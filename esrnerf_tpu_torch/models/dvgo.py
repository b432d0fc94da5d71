"""DVGO: the alphamask stage's dense density/colour-grid renderer.

Port of ``esrnerf_tpu/models/dvgo.py``. The class holds the static
geometry (bbox, resolution, sample count) and its device; the parameters
are a plain dict ``{"density": [X,Y,Z,1], "off_color": [X,Y,Z,3],
"emo_color": [X,Y,Z,3]}``. A forward samples every ray densely
(:func:`~esrnerf_tpu_torch.ops.ray.sample_rays_dvgo`), reads the grids
trilinearly (plain gathers forward; the grid gradient is the splat kernel,
K-3), activates the density into alpha and composites with DVGO's
cumulative-product weights.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from esrnerf_tpu_torch.models.voxurf_base import _linspace
from esrnerf_tpu_torch.ops import grid as gridops
from esrnerf_tpu_torch.ops import ray as rayops
from esrnerf_tpu_torch.ops import render as renderops
from esrnerf_tpu_torch.ops import splat as splatops
from esrnerf_tpu_torch.utils.device import resolve_device

Params = Dict[str, torch.Tensor]


class DVGO:
    def __init__(self, cfg, near: float, far: float, xyz_min, xyz_max,
                 device="cuda"):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.near = float(near)
        self.far = float(far)
        self.xyz_min = np.asarray(xyz_min, np.float32)
        self.xyz_max = np.asarray(xyz_max, np.float32)
        self.xyz_min_t = torch.as_tensor(self.xyz_min, device=self.device)
        self.xyz_max_t = torch.as_tensor(self.xyz_max, device=self.device)

        m = cfg.app.model
        self.num_voxels = int(m["num_voxels"])
        self.alpha_init = float(m["alpha_init"])
        self.stepsize = float(m["stepsize"])

        extent = self.xyz_max - self.xyz_min
        self.voxel_size = float((extent.prod() / self.num_voxels) ** (1 / 3))
        self.world_size = tuple(
            int(x) for x in (extent / self.voxel_size).astype(np.int64))
        # density shift: a zero density activates to alpha_init
        self.act_shift = float(np.log(1 / (1 - self.alpha_init) - 1))
        self.n_samples = int(
            np.linalg.norm(np.asarray(self.world_size) + 1) / self.stepsize
        ) + 1

    # ------------------------------------------------------------------ init

    def init_params(self) -> Params:
        X, Y, Z = self.world_size
        zeros = lambda c: torch.zeros((X, Y, Z, c), device=self.device)
        return {"density": zeros(1), "off_color": zeros(3),
                "emo_color": zeros(3)}

    def grid_xyz(self) -> torch.Tensor:
        """World coordinates of the voxel centres, ``[X,Y,Z,3]``."""
        axes = [_linspace(float(self.xyz_min[i]), float(self.xyz_max[i]), n,
                          self.device) for i, n in enumerate(self.world_size)]
        return torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1)

    @torch.no_grad()
    def maskout_near_cam_vox(self, params: Params,
                             cam_o: torch.Tensor) -> Params:
        """Density -100 for the voxels within ``near`` of a camera centre
        (``cam_o [Ncam, 3]``)."""
        xyz = self.grid_xyz()
        d2 = None
        for c in cam_o.to(self.device):
            d = xyz - c
            dc = d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1] \
                + d[..., 2] * d[..., 2]
            d2 = dc if d2 is None else torch.minimum(d2, dc)
        near = (torch.sqrt(d2) <= self.near)[..., None]
        dens = params["density"]
        return {**params, "density": torch.where(
            near, torch.full_like(dens, -100.0), dens)}

    @torch.no_grad()
    def view_weights(self, rays_o: np.ndarray, rays_d: np.ndarray,
                     chunk: int) -> torch.Tensor:
        """Summed trilinear weight of one view's samples (``[H*W, 3]`` rays)
        at every voxel, ``[X,Y,Z,1]``: the gradient of
        ``sum(grid_sample(ones))`` with respect to the grid, as one
        trilinear splat (K-3) per ``chunk`` rays."""
        X, Y, Z = self.world_size
        w = torch.zeros((X, Y, Z, 1), device=self.device)
        for st in range(0, rays_o.shape[0], chunk):
            ro = torch.as_tensor(rays_o[st:st + chunk], device=self.device)
            rd = torch.as_tensor(rays_d[st:st + chunk], device=self.device)
            pts, _ = rayops.sample_rays_dvgo(
                ro, rd, self.xyz_min_t, self.xyz_max_t, self.near, self.far,
                self.stepsize, self.voxel_size, self.n_samples)
            pts = pts.reshape(-1, 3)
            w = w + splatops.trilinear_splat(
                (X, Y, Z, 1), pts, torch.ones_like(pts[:, :1]),
                self.xyz_min_t, self.xyz_max_t)
        return w

    def voxel_count_views(self, rays_o_imgs: np.ndarray,
                          rays_d_imgs: np.ndarray,
                          chunk: int) -> torch.Tensor:
        """Per voxel, the number of views (``[n_img, H*W, 3]`` rays) whose
        :meth:`view_weights` at the voxel exceed 1, ``[X,Y,Z,1]`` f32."""
        count = torch.zeros((*self.world_size, 1), device=self.device)
        for ro, rd in zip(rays_o_imgs, rays_d_imgs):
            count += (self.view_weights(ro, rd, chunk) > 1).to(torch.float32)
        return count

    # -------------------------------------------------------------- forwards

    def activate_density(self, density: torch.Tensor,
                         interval: float) -> torch.Tensor:
        sp = torch.logaddexp(density + self.act_shift,
                             torch.zeros_like(density))
        return 1.0 - torch.exp(-sp * interval)

    def _sample(self, grid, pts):
        return gridops.grid_sample_3d(grid, pts, self.xyz_min_t,
                                      self.xyz_max_t)

    def _march(self, params: Params, rays_o, rays_d, rand_shift=None):
        pts, mask_out = rayops.sample_rays_dvgo(
            rays_o, rays_d, self.xyz_min_t, self.xyz_max_t, self.near,
            self.far, self.stepsize, self.voxel_size, self.n_samples,
            rand_shift=rand_shift)
        density = self._sample(params["density"], pts)[..., 0]
        alpha = self.activate_density(density, self.stepsize)
        alpha = torch.where(mask_out, torch.zeros_like(alpha), alpha)
        weights, alphainv_cum = renderops.ray_marching_weights_dvgo(alpha)
        return pts, mask_out, alpha, weights, alphainv_cum

    def forward_training(
        self, params: Params, rays_o, rays_d, em_modes,
        generator: Optional[torch.Generator] = None,
        rand_shift: Optional[torch.Tensor] = None,
    ) -> Dict[str, torch.Tensor]:
        """Train render of ``N`` rays; ``em_modes [N]`` (1 = emission on).
        Each ray's samples shift by ``rand_shift [N, 1]`` steps, drawn
        uniformly in ``[0, 1)`` from ``generator`` when not given."""
        if rand_shift is None:
            rand_shift = torch.rand((rays_o.shape[0], 1),
                                    generator=generator,
                                    device=rays_o.device, dtype=rays_o.dtype)
        pts, _, _, weights, alphainv_cum = self._march(
            params, rays_o, rays_d, rand_shift=rand_shift)
        on = (em_modes == 1)[:, None, None]
        emo = torch.sigmoid(self._sample(params["emo_color"], pts))
        off = torch.sigmoid(self._sample(params["off_color"], pts))
        rgb = torch.where(on, emo, torch.zeros_like(emo)) + off
        return {
            "etc/alphainv_cum": alphainv_cum,
            "etc/weights": weights,
            "etc/white_bg": alphainv_cum[..., -1:],
            "srgb/raw_rgb": rgb,
            "srgb/rgb": (weights[..., None] * rgb).sum(-2),
        }

    @torch.no_grad()
    def forward_evaluate(self, params: Params, rays_o, rays_d,
                         em_mode: int) -> Dict[str, torch.Tensor]:
        """Eval render of one chunk of rays with one emission mode: the
        off, on (= off + emo) and emo colours, depth and disparity."""
        pts, _, _, weights, alphainv_cum = self._march(params, rays_o, rays_d)
        off = torch.sigmoid(self._sample(params["off_color"], pts))
        emo = torch.sigmoid(self._sample(params["emo_color"], pts))
        w = weights[..., None]
        off_m = (w * off).sum(-2)
        emo_m = (w * emo).sum(-2)
        on_m = (w * (off + emo)).sum(-2)
        depth = (weights * rayops.ray_norm(rays_o[:, None, :] - pts)).sum(-1)
        disp = 1.0 / (depth + alphainv_cum[..., -1] * self.far)
        return {
            "etc/depth": depth,
            "etc/disp": disp,
            "etc/white_bg": alphainv_cum[..., -1:],
            "srgb/off_rgb": off_m,
            "srgb/on_rgb": on_m,
            "srgb/emo_rgb": emo_m,
            "srgb/rgb": off_m if int(em_mode) == 0 else on_m,
        }

    def export_meta(self) -> dict:
        return {"near": self.near, "far": self.far, "xyz_min": self.xyz_min,
                "xyz_max": self.xyz_max}
