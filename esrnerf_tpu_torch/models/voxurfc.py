"""VoxurfC: the coarse stage's SDF renderer.

Port of ``esrnerf_tpu/models/voxurfc.py``. A dense SDF grid with a frozen
Gaussian smoothing for the march, NeuS alpha against the previous stage's
mask cache (the two-phase march in its ``coarse`` style: a double scan,
K-1/K-2), two colour grids read at the cell-sorted march points by the
corner gather (K-4; the splat, K-3, is their backward) and two small
sigmoid radiance heads (emission off, and on-rays-only emission), plus the
TV regularisers of the masked grids and the mesh.

Parameters are a plain dict with the reference's group names: ``sdf``,
``off_color``, ``emo_color`` (``[X,Y,Z,C]`` grids) and ``off_rgbnet``,
``emo_rgbnet`` (dicts of ``w{i}`` ``[in,out]`` / ``b{i}``).
"""

from __future__ import annotations

from typing import Dict

import torch

from esrnerf_tpu_torch.models import mlp as mlpops
from esrnerf_tpu_torch.models.voxurf_base import MaskCache, VoxurfGeometry
from esrnerf_tpu_torch.ops import grid as gridops
from esrnerf_tpu_torch.ops import tv as tvops
from esrnerf_tpu_torch.utils import profiling
from esrnerf_tpu_torch.utils.device import small_const

Params = Dict[str, object]

# eval normals: camera-space y and z flip to the image convention
NORMAL_FLIPPER = (1.0, -1.0, -1.0)


class VoxurfC:
    """The renderer lives on its mask cache's device."""

    def __init__(
        self, cfg, near, far, xyz_min, xyz_max, mask_cache: MaskCache,
        s_val: float, mask_meta: dict | None = None,
    ):
        self.cfg = cfg
        # the previous stage's raw mask grid and bbox, checkpointed so a
        # reload rebuilds the same mask cache
        self.mask_meta = mask_meta or {}
        m = cfg.app.model
        self.mlp_dtype = mlpops.mlp_dtype_from_cfg(cfg)
        self.geo = VoxurfGeometry(cfg, near, far, xyz_min, xyz_max, mask_cache)
        self.device = self.geo.device
        self.s_val = float(s_val)

        self.fastcolor_thres = float(m["fastcolor_thres"])
        self.color_dim = int(m["color_dim"])
        self.rgbnet_width = int(m["rgbnet_width"])
        self.rgbnet_depth = int(m["rgbnet_depth"])
        self.posbase_pe = int(m["posbase_pe"])
        self.viewbase_pe = int(m["viewbase_pe"])
        self.neus_alpha = str(m["neus_alpha"])

        self.smooth_kernel = gridops.make_gaussian_kernel_3d(
            int(m["smooth_ksize"]), float(m["smooth_sigma"]))
        self.tv_smooth_kernel = gridops.make_gradient_smooth_kernel_3d()
        self._nonempty = self.geo.nonempty_mask()

        self.dim0 = ((3 + 3 * self.posbase_pe * 2) + (3 * self.viewbase_pe * 3)
                     + self.color_dim + 3)
        dev = self.device
        self._posfreq = torch.tensor([2.0**i for i in range(self.posbase_pe)],
                                     device=dev)
        self._viewfreq = torch.tensor(
            [2.0**i for i in range(self.viewbase_pe)], device=dev)

    # ------------------------------------------------------------------ init

    def init_params(self, generator: torch.Generator) -> Params:
        """Sphere SDF, zero colour grids, heads drawn from ``generator``
        with zero final biases."""
        X, Y, Z = self.geo.world_size
        dims = [self.dim0] + [self.rgbnet_width] * (self.rgbnet_depth - 1) + [3]
        dev = self.device
        head = lambda: mlpops.init_mlp(generator, dims, dev,
                                       zero_final_bias=True)
        return {
            "sdf": self.geo.sphere_sdf_init(),
            "off_color": torch.zeros((X, Y, Z, self.color_dim), device=dev),
            "emo_color": torch.zeros((X, Y, Z, self.color_dim), device=dev),
            "off_rgbnet": head(),
            "emo_rgbnet": head(),
        }

    # -------------------------------------------------------------- features

    def _features(self, pts, viewdirs_per_pt, normal):
        geo = self.geo
        xyz_n = (pts - geo.xyz_min_t) / (geo.xyz_max_t - geo.xyz_min_t)
        xyz_emb = (xyz_n[..., None] * self._posfreq).reshape(
            *xyz_n.shape[:-1], -1)
        view_emb = (viewdirs_per_pt[..., None] * self._viewfreq).reshape(
            *viewdirs_per_pt.shape[:-1], -1)
        return torch.cat(
            [xyz_n, torch.sin(xyz_emb), torch.cos(xyz_emb),
             view_emb, torch.sin(view_emb), torch.cos(view_emb), normal],
            dim=-1)

    def _heads(self, params, pts, feat, on_mask):
        """Sigmoid off and emissive heads on the colour grids' samples;
        returns ``(off + emo on on_mask rows, off, emo)``."""
        def head(name):
            x = torch.cat([self.geo.sample_grid_sorted(
                params[f"{name}_color"], pts), feat], -1)
            return torch.sigmoid(mlpops.apply_mlp(
                params[f"{name}_rgbnet"], x, compute_dtype=self.mlp_dtype))

        off, emo = head("off"), head("emo")
        return torch.where(on_mask[:, None], emo, torch.zeros_like(emo)) \
            + off, off, emo

    def smoothed_sdf(self, params: Params) -> torch.Tensor:
        return gridops.conv3d_replicate(params["sdf"], self.smooth_kernel)

    def _march_features(self, params, rays_o, rays_d, viewdirs, s_val):
        geo = self.geo
        with profiling.span("coarse/march"):
            # the unsmoothed SDF's gradient: the grad-variant alpha's
            # sections here, the normals below
            grad_grid = geo.sdf_gradient(params["sdf"])
            m = geo.march(self.smoothed_sdf(params), rays_o, rays_d, viewdirs,
                          s_val, self.fastcolor_thres, self.neus_alpha,
                          style="coarse", gradient_grid=grad_grid)
        with profiling.span("coarse/features"):
            grad_pts = geo.sample_grid_sorted(grad_grid, m.pts)
            normal = grad_pts / (
                torch.linalg.vector_norm(grad_pts, dim=-1, keepdim=True)
                + 1e-5)
            rid = torch.clamp(m.ray_id, max=m.n_rays - 1)
            feat = self._features(m.pts, viewdirs.index_select(0, rid),
                                  normal)
        return m, rid, normal, feat

    # -------------------------------------------------------------- forwards

    def forward_training(self, params: Params, rays_o, rays_d, viewdirs,
                         em_modes, s_val) -> Dict[str, torch.Tensor]:
        """The coarse training forward; ``etc/counts`` are the march's counts
        (:func:`~esrnerf_tpu_torch.models.voxurf_base.march_fractions`),
        which a data-parallel step folds over the ranks."""
        m, rid, _, feat = self._march_features(params, rays_o, rays_d,
                                               viewdirs, s_val)
        on_mask = (em_modes.index_select(0, rid) == 1) & ~m.pad
        with profiling.span("coarse/heads"):
            rgb, _, _ = self._heads(params, m.pts, feat, on_mask)
            rgb_m = self.geo.segment_to_rays(m, rgb)
        return {
            "etc/alphainv_cum": m.alphainv_last,
            "etc/white_bg": (1.0 - m.cum_weights)[:, None],
            "srgb/rgb": rgb_m,
            "etc/overflow": m.overflow,
            "etc/k1_frac": m.k1_frac,
            "etc/k2_frac": m.k2_frac,
            "etc/counts": m.counts,
        }

    @torch.no_grad()
    def forward_evaluate(self, params: Params, rays_o, rays_d, viewdirs,
                         em_mode: int, pos_rt, s_val) -> Dict[str, torch.Tensor]:
        """Eval render of one chunk of rays with one emission mode: off, on
        (= off + emo) and emo colours, the camera-space normal map (``pos_rt``
        is the camera's ``[3, 3]`` rotation), depth and disparity;
        ``etc/overflow`` is the march's."""
        geo = self.geo
        m, _, normal, feat = self._march_features(params, rays_o, rays_d,
                                                  viewdirs, s_val)
        ones = torch.ones(m.pts.shape[0], dtype=torch.bool,
                          device=m.pts.device)
        _, off, emo = self._heads(params, m.pts, feat, ones)
        flip = small_const(NORMAL_FLIPPER, torch.float32, normal.device)
        nrm = ((normal @ pos_rt) * flip + 1.0) / 2.0
        out = {k: geo.segment_to_rays(m, v) for k, v in (
            ("srgb/off_rgb", off), ("srgb/emo_rgb", emo),
            ("srgb/on_rgb", off + emo), ("etc/normal", nrm))}
        depth = geo.segment_to_rays(m, m.step_id.to(torch.float32)
                                    * geo.stepdist)
        bg = (1.0 - m.cum_weights)[:, None]
        out.update({
            "etc/depth": depth,
            "etc/disp": 1.0 / (depth + bg[..., -1] * geo.far),
            "etc/white_bg": bg,
            "srgb/rgb": (out["srgb/off_rgb"] if int(em_mode) == 0
                         else out["srgb/on_rgb"]),
            "etc/overflow": m.overflow,
        })
        return out

    # -------------------------------------------------------------- TV losses

    def density_total_variation(self, params: Params, sdf_tv, smooth_grad_tv):
        """SDF TV (per voxel size) plus the smooth-gradient term: the masked
        mean squared gap between the SDF gradient and its detached smoothed
        version."""
        geo = self.geo
        out = tvops.total_variation(params["sdf"], self._nonempty) \
            / 2.0 / geo.voxel_size * sdf_tv
        grad = geo.sdf_gradient(params["sdf"])
        with torch.no_grad():
            smoothed = gridops.conv3d_replicate(grad, self.tv_smooth_kernel)
        err = (smoothed - grad) ** 2
        mask = self._nonempty[..., None].expand(err.shape)
        denom = torch.clamp(mask.sum(), min=1)
        return out + (torch.where(mask, err, torch.zeros_like(err)).sum()
                      / denom) * smooth_grad_tv

    def color_total_variation(self, params: Params):
        return (tvops.total_variation(params["off_color"], self._nonempty)
                + tvops.total_variation(params["emo_color"], self._nonempty))

    # ------------------------------------------------------------------ mesh

    def extract_geometry(self, params: Params, **kw):
        return self.geo.extract_geometry(params["sdf"], **kw)

    def export_meta(self) -> dict:
        return {
            "near": self.geo.near,
            "far": self.geo.far,
            "xyz_min": self.geo.xyz_min,
            "xyz_max": self.geo.xyz_max,
            "s_val": self.s_val,
            **self.mask_meta,
        }
