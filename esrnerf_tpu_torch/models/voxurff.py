"""VoxurfF: the fine-stage HDR renderer with a learnable tone-mapper.

Port of ``esrnerf_tpu/models/voxurff.py``. The radiance heads output
softplus linear HDR RGB; the tone-mapper maps PE-encoded linear RGB to
sigmoid sRGB; features add the per-point SDF value, the multi-scale
6-neighbour SDF taps and per-displacement normals; emissive-on rays add
the detached off head. Besides the training forward: the coarse-SDF warm
start, progressive grid scaling, the eval forward and the mesh.

Parameters are a plain dict with the reference's group names: ``sdf``,
``off_color``, ``emo_color`` (``[X,Y,Z,C]`` grids) and ``off_rgbnet``,
``emo_rgbnet``, ``tonemapper`` (dicts of ``w{i}`` ``[in,out]`` / ``b{i}``).
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from esrnerf_tpu_torch.models import mlp as mlpops
from esrnerf_tpu_torch.models.voxurf_base import MaskCache, VoxurfGeometry
from esrnerf_tpu_torch.ops import grid as gridops
from esrnerf_tpu_torch.ops import kernels
from esrnerf_tpu_torch.ops import tv as tvops
from esrnerf_tpu_torch.utils import profiling
from esrnerf_tpu_torch.utils.device import small_const

Params = Dict[str, object]

# eval normals: camera-space y and z flip to the image convention
NORMAL_FLIPPER = (1.0, -1.0, -1.0)
# the eval forward's per-ray sums, in the fused heads kernel's order
EVAL_SUMS = ("srgb/off_rgb", "lin/off_rgb", "srgb/on_rgb", "lin/on_rgb",
             "srgb/emo_rgb", "lin/emo_rgb", "etc/normal", "etc/depth")


class VoxurfF:
    """The renderer lives on its mask cache's device."""

    def __init__(
        self, cfg, near, far, xyz_min, xyz_max, mask_cache: MaskCache,
        s_val: float, num_voxels: int, mask_meta: dict | None = None,
    ):
        self.cfg = cfg
        self.mask_meta = mask_meta or {}
        m = cfg.app.model
        self.mlp_dtype = mlpops.mlp_dtype_from_cfg(cfg)
        self.geo = VoxurfGeometry(cfg, near, far, xyz_min, xyz_max, mask_cache)
        self.geo.set_grid_resolution(int(num_voxels))
        self.device = self.geo.device
        self.s_val = float(s_val)

        self.fastcolor_thres = float(m["fastcolor_thres"])
        self.color_dim = int(m["color_dim"])
        self.rgbnet_width = int(m["rgbnet_width"])
        self.rgbnet_depth = int(m["rgbnet_depth"])
        self.tonemap_width = int(m["tonemap_width"])
        self.tonemap_depth = int(m["tonemap_depth"])
        self.posbase_pe = int(m["posbase_pe"])
        self.viewbase_pe = int(m["viewbase_pe"])
        self.colorbase_pe = int(m["colorbase_pe"])
        self.grad_feat = np.asarray(m["grad_feat"], np.float32)
        self.neus_alpha = str(m["neus_alpha"])

        self.tv_smooth_kernel = gridops.make_gradient_smooth_kernel_3d()
        self._nonempty = self.geo.nonempty_mask()

        D = len(self.grad_feat)
        self.dim0 = (
            (3 + 3 * self.posbase_pe * 2)
            + (3 * self.viewbase_pe * 3)
            + self.color_dim
            + D * 3      # multi-scale normals
            + D * 6      # multi-scale neighbour taps
            + 1          # sdf value
        )
        self.tonemap_dim0 = 3 + 3 * self.colorbase_pe * 2
        dev = self.device
        self._posfreq = torch.tensor([2.0**i for i in range(self.posbase_pe)],
                                     device=dev)
        self._viewfreq = torch.tensor(
            [2.0**i for i in range(self.viewbase_pe)], device=dev)
        self._colorfreq = torch.tensor(
            [2.0**i for i in range(self.colorbase_pe)], device=dev)

    @property
    def num_voxels(self) -> int:
        return self.geo.num_voxels

    # ------------------------------------------------------------------ init

    def init_params(self, generator: torch.Generator) -> Params:
        """Sphere SDF, zero color grids, heads drawn from ``generator``."""
        X, Y, Z = self.geo.world_size
        dims = [self.dim0] + [self.rgbnet_width] * (self.rgbnet_depth - 1) + [3]
        tm_dims = ([self.tonemap_dim0]
                   + [self.tonemap_width] * (self.tonemap_depth - 1) + [3])
        dev = self.device
        return {
            "sdf": self.geo.sphere_sdf_init(),
            "off_color": torch.zeros((X, Y, Z, self.color_dim), device=dev),
            "emo_color": torch.zeros((X, Y, Z, self.color_dim), device=dev),
            "off_rgbnet": mlpops.init_mlp(generator, dims, dev),
            "emo_rgbnet": mlpops.init_mlp(generator, dims, dev),
            "tonemapper": mlpops.init_mlp(generator, tm_dims, dev),
        }

    @torch.no_grad()
    def load_coarse_sdf(self, coarse_sdf: np.ndarray,
                        sdf_reduce: float) -> torch.Tensor:
        """Warm-start SDF from the coarse stage's ``[X,Y,Z,1]`` grid: scaled
        by ``1 / sdf_reduce``, resized to this grid, Gaussian-smoothed
        (k=5, sigma=1), and pushed to +1 outside the nonempty mask."""
        sdf = torch.as_tensor(np.asarray(coarse_sdf, np.float32),
                              device=self.device) / sdf_reduce
        if tuple(sdf.shape[:3]) != tuple(self.geo.world_size):
            sdf = gridops.resize_trilinear(sdf, self.geo.world_size)
        sdf = gridops.conv3d_replicate(
            sdf, gridops.make_gaussian_kernel_3d(5, 1.0))
        return torch.where(self._nonempty[..., None], sdf,
                           torch.ones_like(sdf))

    @torch.no_grad()
    def scale_volume_grid(self, params: Params, num_voxels: int) -> Params:
        """Trilinear upsample of the SDF and color grids to ``num_voxels``.
        Rebuilds the geometry (world size, sample count, block-dilated
        mask, nonempty mask); the caller makes a new optimizer state."""
        self.geo.set_grid_resolution(int(num_voxels))
        new_size = self.geo.world_size
        out = dict(params)
        for k in ("sdf", "off_color", "emo_color"):
            out[k] = gridops.resize_trilinear(params[k], new_size)
        self._nonempty = self.geo.nonempty_mask()
        out["sdf"] = torch.where(self._nonempty[..., None], out["sdf"],
                                 torch.ones_like(out["sdf"]))
        return out

    # -------------------------------------------------------------- features

    def _sdf_taps(self, params, pts, n_valid=None):
        """The multi-scale SDF taps and normals of the features:
        ``(feat6 [M, 6D], normals [M, 3D])``."""
        feat6, _, normals = self.geo.sample_sdfeat_grad_normal(
            params["sdf"], pts, self.grad_feat, n_valid
        )
        return feat6, normals

    def _xyz_emb_full(self, pts):
        """Normalised position and its sin/cos encodings."""
        geo = self.geo
        xyz_n = (pts - geo.xyz_min_t) / (geo.xyz_max_t - geo.xyz_min_t)
        xyz_emb = (xyz_n[..., None] * self._posfreq).reshape(
            *xyz_n.shape[:-1], -1)
        return torch.cat([xyz_n, torch.sin(xyz_emb), torch.cos(xyz_emb)], -1)

    def _view_emb(self, viewdirs):
        """View direction's encoding and its sin/cos."""
        view_emb = (viewdirs[..., None] * self._viewfreq).reshape(
            *viewdirs.shape[:-1], -1)
        return torch.cat([view_emb, torch.sin(view_emb), torch.cos(view_emb)],
                         -1)

    def _features(self, params, pts, viewdirs_per_pt, sdf, n_valid=None,
                  taps=None):
        """Head features; ``taps`` passes :meth:`_sdf_taps` of the same
        points when the caller already has them."""
        feat6, normals = taps or self._sdf_taps(params, pts, n_valid)
        return torch.cat(
            [self._xyz_emb_full(pts), self._view_emb(viewdirs_per_pt),
             sdf[:, None], feat6, normals],
            dim=-1,
        )

    def apply_tonemapper(self, params: Params, lin_rgb: torch.Tensor):
        """PE-encode linear RGB -> sigmoid sRGB."""
        emb = (lin_rgb[..., None] * self._colorfreq).reshape(
            *lin_rgb.shape[:-1], -1)
        feat = torch.cat([lin_rgb, torch.sin(emb), torch.cos(emb)], -1)
        return torch.sigmoid(mlpops.apply_mlp(
            params["tonemapper"], feat, compute_dtype=self.mlp_dtype))

    def _radiance(self, params, head: str, feat, grid_val):
        """Softplus HDR radiance of ``head`` from its color-grid samples
        ``grid_val`` and the shared features."""
        x = torch.cat([grid_val, feat], -1)
        return F.softplus(mlpops.apply_mlp(
            params[f"{head}_rgbnet"], x, compute_dtype=self.mlp_dtype))

    def _eval_heads(self, params, m, feat, off_gv, emo_gv, nrm):
        """The eval heads and their per-ray sums, keyed by
        :data:`EVAL_SUMS`: on a CUDA device one fused kernel over the
        march's live rows (:func:`~esrnerf_tpu_torch.ops.kernels.eval_heads`,
        which raises for heads it is not built for), on the CPU the eager
        ops over every row. Counts ``eval.heads_fused`` or
        ``eval.heads_eager``."""
        if feat.is_cuda:
            sums = kernels.eval_heads(
                off_gv, emo_gv, feat, nrm, m.weights, m.ray_id, m.step_id,
                m.n_valid, m.n_rays, self.geo.stepdist, params["off_rgbnet"],
                params["emo_rgbnet"], params["tonemapper"], self.mlp_dtype)
            profiling.count("eval.heads_fused")
        else:
            sums = self._eval_heads_eager(params, m, feat, off_gv, emo_gv,
                                          nrm)
            profiling.count("eval.heads_eager")
        return dict(zip(EVAL_SUMS, sums))

    def _eval_heads_eager(self, params, m, feat, off_gv, emo_gv, nrm):
        """:meth:`_eval_heads` as PyTorch ops over every row: the CPU path,
        and the reference the kernel is tested against."""
        geo = self.geo
        lin_off = self._radiance(params, "off", feat, off_gv)
        lin_emo = self._radiance(params, "emo", feat, emo_gv)
        lin_on = lin_off + lin_emo
        off = self.apply_tonemapper(params, lin_off)
        emo = self.apply_tonemapper(params, lin_emo)
        on = self.apply_tonemapper(params, lin_on)
        depth = m.step_id.to(torch.float32) * geo.stepdist
        return [geo.segment_to_rays(m, v) for v in (
            off, lin_off, on, lin_on, emo, lin_emo, nrm, depth)]

    def _march_gradient(self, sdf: torch.Tensor):
        """The SDF gradient grid the grad-variant march alpha takes, None
        for the interp variant."""
        if self.neus_alpha != "grad":
            return None
        return self.geo.sdf_gradient(sdf)

    # -------------------------------------------------------------- forwards

    def forward_training(self, params: Params, rays_o, rays_d, viewdirs,
                         em_modes, s_val) -> Dict[str, torch.Tensor]:
        """The fine training forward; ``etc/counts`` are the march's counts
        (:func:`~esrnerf_tpu_torch.models.voxurf_base.march_fractions`),
        which a data-parallel step folds over the ranks. The march, the
        features and the heads mark their outputs for the profiled
        backward's ranges ``fine/bwd_{march,features,heads}``
        (:func:`~esrnerf_tpu_torch.utils.profiling.bwd_mark`)."""
        geo = self.geo
        with profiling.span("fine/march"):
            sdf = profiling.bwd_mark(None, params["sdf"])
            m = geo.march(
                sdf, rays_o, rays_d, viewdirs, s_val,
                self.fastcolor_thres, self.neus_alpha, style="fine",
                gradient_grid=self._march_gradient(sdf),
            )
            w, a_last = profiling.bwd_mark("march", m.weights,
                                           m.alphainv_last)
            m = m._replace(weights=w, alphainv_last=a_last)
        rid = torch.clamp(m.ray_id, max=m.n_rays - 1)
        with profiling.span("fine/features"):
            feat = profiling.bwd_mark("features", self._features(
                params, m.pts, viewdirs.index_select(0, rid), m.sdf,
                n_valid=m.n_valid))
        on_mask = ((em_modes.index_select(0, rid) == 1) & ~m.pad)[:, None]

        with profiling.span("fine/heads"):
            off_gv, emo_gv = geo.sample_grids_sorted(
                (params["off_color"], params["emo_color"]), m.pts, m.n_valid
            )
            off = self._radiance(params, "off", feat, off_gv)
            emo = self._radiance(params, "emo", feat, emo_gv)
            lin_rgb = torch.where(on_mask, emo + off.detach(), off)
            rgb = self.apply_tonemapper(params, lin_rgb)
            rgb_m, lin_m = profiling.bwd_mark(
                "heads", geo.segment_to_rays(m, rgb),
                geo.segment_to_rays(m, lin_rgb))

        return {
            "etc/alphainv_cum": m.alphainv_last,
            "etc/white_bg": m.alphainv_last[..., None],
            "srgb/rgb": rgb_m,
            "lin/rgb": lin_m,
            "etc/overflow": m.overflow,
            "etc/k1_frac": m.k1_frac,
            "etc/k2_frac": m.k2_frac,
            "etc/counts": m.counts,
        }

    @torch.no_grad()
    def forward_evaluate(self, params: Params, rays_o, rays_d, viewdirs,
                         em_mode: int, pos_rt, s_val) -> Dict[str, torch.Tensor]:
        """Eval render of one chunk of rays with one emission mode: off, on
        (= off + emo) and emo radiance in linear and tone-mapped sRGB, the
        camera-space normal map, depth and disparity. ``pos_rt`` is the
        camera's ``[3, 3]`` rotation; ``etc/overflow`` is the march's. The
        phases run in the spans ``fine/march``, ``fine/features`` (the
        head features and the normals) and ``fine/heads`` (the heads, the
        tone-mapper and the per-ray sums)."""
        geo = self.geo
        with profiling.span("fine/march"):
            m = geo.march(
                params["sdf"], rays_o, rays_d, viewdirs, s_val,
                self.fastcolor_thres, self.neus_alpha, style="fine",
                gradient_grid=self._march_gradient(params["sdf"]),
            )
        rid = torch.clamp(m.ray_id, max=m.n_rays - 1)
        with profiling.span("fine/features"):
            feat = self._features(params, m.pts,
                                  viewdirs.index_select(0, rid), m.sdf,
                                  n_valid=m.n_valid)
            _, grad_xyz = geo.sample_sdf_grad(params["sdf"], m.pts)
            normal = grad_xyz / torch.clamp(
                torch.linalg.vector_norm(grad_xyz, dim=-1, keepdim=True),
                min=1e-12)
            flip = small_const(NORMAL_FLIPPER, torch.float32, normal.device)
            nrm = ((normal @ pos_rt) * flip + 1.0) / 2.0

        with profiling.span("fine/heads"):
            off_gv, emo_gv = geo.sample_grids_sorted(
                (params["off_color"], params["emo_color"]), m.pts, m.n_valid
            )
            out = self._eval_heads(params, m, feat, off_gv, emo_gv, nrm)
        is_off = int(em_mode) == 0
        out.update({
            "etc/disp": 1.0 / (out["etc/depth"] + m.alphainv_last * geo.far),
            "etc/white_bg": m.alphainv_last[..., None],
            "srgb/rgb": out["srgb/off_rgb"] if is_off else out["srgb/on_rgb"],
            "lin/rgb": out["lin/off_rgb"] if is_off else out["lin/on_rgb"],
            "etc/overflow": m.overflow,
        })
        return out

    # ---------------------------------------------------------------- losses

    def density_total_variation(self, params: Params, smooth_grad_tv):
        """Smooth-gradient TV: masked mean squared gap between the SDF
        gradient and its (detached) smoothed version."""
        grad = self.geo.sdf_gradient(params["sdf"])
        with torch.no_grad():
            smoothed = gridops.conv3d_replicate(grad, self.tv_smooth_kernel)
        err = (smoothed - grad) ** 2
        mask = self._nonempty[..., None].expand(err.shape)
        denom = torch.clamp(mask.sum(), min=1)
        return (torch.where(mask, err, torch.zeros_like(err)).sum() / denom
                ) * smooth_grad_tv

    def sdf_tv_grad(self, sdf: torch.Tensor, weight, sparse_grad=None,
                    x_rows=None):
        """Gradient term of the SDF TV: per-axis weight scaled by
        max(world) / 128 (of the X-rows ``x_rows`` only, as
        :func:`~esrnerf_tpu_torch.ops.tv.tv_grad`'s)."""
        w = weight * max(self.geo.world_size) / 128.0
        return tvops.tv_grad(sdf, w, w, w, sparse_grad=sparse_grad,
                             x_rows=x_rows)

    def extract_geometry(self, params: Params, **kw):
        return self.geo.extract_geometry(params["sdf"], **kw)

    def export_meta(self) -> dict:
        return {
            "near": self.geo.near,
            "far": self.geo.far,
            "xyz_min": self.geo.xyz_min,
            "xyz_max": self.geo.xyz_max,
            "s_val": self.s_val,
            "num_voxels": self.geo.num_voxels,
            **self.mask_meta,
        }
