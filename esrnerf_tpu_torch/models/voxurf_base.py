"""Shared machinery of the Voxurf-family SDF renderers: the mask cache and
the two-phase static-budget march.

Port of ``esrnerf_tpu/models/voxurf_base.py``. The dense ``[N, S]`` sample
grid is culled by a superset occupancy tap and compacted into a fixed
``[K1]`` list (phase 1); the exact mask test, SDF sample, NeuS alpha and the
transmittance scan run on that list through a dense scalar bridge; the
alpha/weight-filtered survivors are compacted into the fixed ``[K2]`` head
buffer (phase 2) and re-ordered by grid cell.

Fixed-size compaction (``jnp.nonzero(size=K, fill_value=-1)`` in the
reference) is :func:`fixed_size_nonzero`, a cumsum + scatter that keeps the
ray-major order, the same ``n1``/``n2`` counts and the same overflow, and
never syncs the host.

Also here: the SDF surface-band cull of the LTS and PDRA stages
(:meth:`VoxurfGeometry.band_occ64`, :meth:`VoxurfGeometry.query_nearest64`;
``surf_band_factor > 0``), the march's per-call budgets and near plane (the
LTS secondary march), the training-ray filter in both styles
(:meth:`VoxurfGeometry.filter_rays_in_maskcache`), the SDF value and
gradient sampler of the eval normals, the mesh extraction, and the
per-ray sample slots of the PDRA relighting fine-tune
(:meth:`VoxurfGeometry.march_ray_slots`).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from esrnerf_tpu_torch.ops import grid as gridops
from esrnerf_tpu_torch.ops import ray as rayops
from esrnerf_tpu_torch.ops import render as renderops
from esrnerf_tpu_torch.ops import scan as scanops
from esrnerf_tpu_torch.ops import splat as splatops
from esrnerf_tpu_torch.utils import profiling
from esrnerf_tpu_torch.utils.device import resolve_device, small_const

_PAD_KEY = 2**30


def fixed_size_nonzero(mask: torch.Tensor, size: int) -> torch.Tensor:
    """Indices of the True entries of flat ``mask`` in ascending order,
    truncated or padded with -1 to ``size`` (int64), without a host sync."""
    flat = mask.reshape(-1)
    pos = torch.cumsum(flat, 0) - 1
    tgt = torch.where(flat & (pos < size), pos, torch.full_like(pos, size))
    out = torch.full((size + 1,), -1, dtype=torch.int64, device=flat.device)
    out.scatter_(0, tgt, torch.arange(flat.numel(), device=flat.device))
    return out[:size]


def _linspace(lo: float, hi: float, n: int, device) -> torch.Tensor:
    """f32 ``linspace`` with the reference's arithmetic
    ``lo * (1 - t) + hi * t``, ``t = i / (n - 1)``, endpoint exact."""
    if n == 1:
        return torch.tensor([lo], dtype=torch.float32, device=device)
    t = torch.arange(n - 1, dtype=torch.float32, device=device) / float(n - 1)
    lo_t = torch.tensor(lo, dtype=torch.float32, device=device)
    hi_t = torch.tensor(hi, dtype=torch.float32, device=device)
    return torch.cat([lo_t * (1 - t) + hi_t * t, hi_t[None]])


def _max_pool_same(x3: torch.Tensor, wins) -> torch.Tensor:
    """Stride-1 max pool of ``[X,Y,Z]`` with odd per-axis windows and SAME
    padding (the padding never wins: inputs here are >= 0)."""
    pad = tuple(w // 2 for w in wins)
    return F.max_pool3d(x3[None, None], tuple(wins), stride=1,
                        padding=pad)[0, 0]


class MaskCache:
    """Frozen occupancy test from the previous stage's density grid:
    max-pooled density, sampled with zero padding, thresholded in alpha
    space. ``occ_sup`` is a binarized, dilated, 1-padded superset of the
    exact test that one nearest tap per point can query
    (:meth:`query_nearest`)."""

    def __init__(self, density, xyz_min, xyz_max, act_shift, thres, occ_sup):
        self.density = density  # [X,Y,Z,1] max-pooled
        self.xyz_min = xyz_min
        self.xyz_max = xyz_max
        self.act_shift = act_shift
        self.thres = thres
        self.occ_sup = occ_sup  # [X+2,Y+2,Z+2] f32 0/1

    @property
    def device(self) -> torch.device:
        return self.density.device

    def query(self, xyz: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            d = gridops.grid_sample_3d(self.density, xyz, self.xyz_min,
                                       self.xyz_max)[..., 0]
            sp = torch.logaddexp(d + self.act_shift, torch.zeros_like(d))
            alpha = 1.0 - torch.exp(-sp)
        return alpha >= self.thres

    def query_nearest(self, xyz: torch.Tensor) -> torch.Tensor:
        """Conservative single-tap superset of :meth:`query`."""
        return _nearest_tap(self.occ_sup, self.density.shape[:3],
                            self.xyz_min, self.xyz_max, xyz)


def _nearest_tap(table, size3, xyz_min, xyz_max, xyz):
    X, Y, Z = size3
    idx = gridops.normalized_index(xyz.reshape(-1, 3), xyz_min, xyz_max,
                                   (X, Y, Z))
    i = torch.round(idx).to(torch.int64) + 1  # pad offset
    hi = small_const((X + 1, Y + 1, Z + 1), torch.int64, xyz.device)
    i = torch.clamp(i, min=torch.zeros_like(hi), max=hi)
    lin = (i[:, 0] * (Y + 2) + i[:, 1]) * (Z + 2) + i[:, 2]
    occ = table.reshape(-1).index_select(0, lin) > 0.0
    return occ.reshape(xyz.shape[:-1])


def make_mask_cache(
    density_xyzc: np.ndarray,
    xyz_min,
    xyz_max,
    alpha_init: float,
    thres: float,
    ks: int,
    device="cuda",
) -> MaskCache:
    """Mask cache from a ``[X,Y,Z,1]`` numpy density grid, on ``device``."""
    dev = resolve_device(device)
    dens = torch.as_tensor(np.asarray(density_xyzc, np.float32), device=dev)
    pooled = gridops.max_pool_3d_same(dens, ks)
    act_shift = float(np.log(1 / (1 - alpha_init) - 1))
    # alpha >= thres  <=>  density >= d_tau (monotone); y <= 0 => everywhere
    y = -np.log1p(-min(float(thres), 1.0 - 1e-12))
    padded = F.pad(pooled[..., 0], (1, 1, 1, 1, 1, 1), value=-1e30)
    if y <= 0:
        occ_sup = torch.ones_like(padded)
    else:
        d_tau = float(np.log(np.expm1(y)) - act_shift)
        occ_sup = (gridops.max_pool_3d_same(padded[..., None], 3)[..., 0]
                   >= d_tau).to(torch.float32)
    return MaskCache(
        density=pooled,
        xyz_min=torch.as_tensor(np.asarray(xyz_min, np.float32), device=dev),
        xyz_max=torch.as_tensor(np.asarray(xyz_max, np.float32), device=dev),
        act_shift=act_shift,
        thres=float(thres),
        occ_sup=occ_sup,
    )


def resample_occ64(mask_cache: MaskCache, lo, hi) -> torch.Tensor:
    """``[66,66,66]`` f32 0/1: the mask cache's ``occ_sup`` on the 1-padded
    64^3 partition of the box ``[lo, hi]`` (a model's, which the band cull
    of :meth:`VoxurfGeometry.band_occ64` taps), conservative for
    :meth:`MaskCache.query_nearest`.

    The reference resamples onto the partition of the mask cache's own box,
    and so assumes the two boxes are one; a stage after coarse has the
    coarse stage's tighter box. Per axis, the points of a 64th of ``[lo,
    hi]`` round (``query_nearest``'s convention) to a contiguous range of
    mask cells: with ``LAT`` box centres per axis, ``LAT`` a multiple of 64
    large enough that one step moves the cell index by less than one, the
    range of a block is that of its ``LAT / 64`` centres. The max over each
    block's ranges, dilated by one block for the rounding at block edges,
    is the result. With ``[lo, hi]`` the mask's box and a mask grid of at
    most 254 a side (the reference's limit), ``LAT`` is 256 and the result
    is the reference's ``occ64`` bit for bit."""
    occ = mask_cache.occ_sup
    mlo = mask_cache.xyz_min.cpu().numpy().astype(np.float64)
    mhi = mask_cache.xyz_max.cpu().numpy().astype(np.float64)
    lo = np.asarray(lo, np.float64)
    hi = np.asarray(hi, np.float64)
    for axis in range(3):
        n = occ.shape[axis] - 2
        span = (n - 1) * (hi[axis] - lo[axis]) / (mhi[axis] - mlo[axis])
        lat = 64 * max(4, int(np.floor(span / 64)) + 1)
        t = (np.arange(lat) + 0.5) / lat
        ll = ((lo[axis] + t * (hi[axis] - lo[axis]) - mlo[axis])
              / (mhi[axis] - mlo[axis]) * (n - 1))
        cell = np.clip(np.round(ll).astype(np.int64) + 1, 0, n + 1)
        cell = cell.reshape(64, lat // 64)
        first = torch.as_tensor(cell[:, 0], device=occ.device)
        last = torch.as_tensor(cell[:, -1], device=occ.device)
        out = None
        for k in range(int((cell[:, -1] - cell[:, 0]).max()) + 1):
            v = occ.index_select(axis, torch.minimum(first + k, last))
            out = v if out is None else torch.maximum(out, v)
        occ = out
    o = gridops.max_pool_3d_same(occ[..., None], 3)[..., 0]
    return F.pad(o, (1, 1, 1, 1, 1, 1))


class March(NamedTuple):
    """Compacted march state; padded slots have weight 0 and ray_id N."""

    pts: torch.Tensor        # [K, 3]
    ray_id: torch.Tensor     # [K] in [0, N]; N = padding
    step_id: torch.Tensor    # [K] sample index along the ray
    weights: torch.Tensor    # [K]
    alpha: torch.Tensor      # [K]
    sdf: torch.Tensor        # [K]
    pad: torch.Tensor        # [K] bool, True = padding slot
    alphainv_last: torch.Tensor  # [N]
    cum_weights: torch.Tensor    # [N]
    n_rays: int
    overflow: torch.Tensor   # [] fraction of surviving samples dropped
    n_valid: torch.Tensor    # [] int32 count of non-pad rows (a tail)
    k1_frac: torch.Tensor    # [] phase-1 budget utilization
    k2_frac: torch.Tensor    # [] phase-2 budget utilization
    key: torch.Tensor        # [K] int64 cell key of each row, ascending
    counts: torch.Tensor     # [6] f32 (n1, n2, K1, K2, dropped1, dropped2)


def march_fractions(counts: torch.Tensor) -> tuple:
    """``(overflow, k1_frac, k2_frac)`` of march counts ``(n1, n2, K1, K2,
    dropped1, dropped2)``: the larger of the two phases' dropped shares of
    their surviving samples, and each phase's use of its budget. Summed
    counts give the fractions of the sum."""
    n, k, d = counts.view(3, 2).unbind()
    k1_frac, k2_frac = (n / k).unbind()
    return (d / torch.clamp(n, min=1)).amax(), k1_frac, k2_frac


def rebudget_counts(counts: torch.Tensor, K1: float, K2: float,
                    keep: bool = True) -> torch.Tensor:
    """March ``counts`` with the budgets ``K1``, ``K2`` in place of their
    own and, unless ``keep``, no samples."""
    k = 1.0 if keep else 0.0
    return (counts * counts.new_tensor([k, k, 0.0, 0.0, k, k])
            + counts.new_tensor([0.0, 0.0, K1, K2, 0.0, 0.0]))


def fold_counters(counts: tuple, fractions: tuple, sh,
                  derive: Callable = march_fractions) -> tuple:
    """A step's march counters over the ranks of ``sh`` (a
    :class:`~esrnerf_tpu_torch.parallel.mesh.ShardHelpers`):
    ``fractions``, the forward's own counters of its ``counts`` (a tuple
    of count vectors), as they are at world 1 and their maximum over the
    ranks under ``shard_map``; under ``gspmd`` ``derive`` of every rank's
    counts summed (default :func:`march_fractions` of one march's: the
    global fractions, world 1's where no rank overflows). No launch at
    world 1, one collective on a world of ranks."""
    if sh.n == 1:
        return tuple(f.detach() for f in fractions)
    if sh.gspmd:
        return derive(sh.reduce(torch.cat(counts)))
    return tuple(sh.gmax(torch.stack(fractions).detach()).unbind())


class VoxurfGeometry:
    """Static geometry + the dense -> compact march. The device is the
    mask cache's."""

    def __init__(self, cfg, near, far, xyz_min, xyz_max, mask_cache):
        self.cfg = cfg
        self.near = float(near)
        self.far = float(far)
        self.xyz_min = np.asarray(xyz_min, np.float32)
        self.xyz_max = np.asarray(xyz_max, np.float32)
        self.mask_cache = mask_cache
        self.device = mask_cache.device
        self.xyz_min_t = torch.as_tensor(self.xyz_min, device=self.device)
        self.xyz_max_t = torch.as_tensor(self.xyz_max, device=self.device)
        # the mask cache's occupancy on this box's 64^3 partition
        self.occ64 = resample_occ64(mask_cache, self.xyz_min, self.xyz_max)

        m = cfg.app.model
        self.stepsize = float(m["stepsize"])
        self.num_voxels = int(
            m.get("num_voxels") or cfg.app["trainer"].get("num_voxels") or 4096
        )
        self.set_grid_resolution(self.num_voxels)
        self.points_per_ray = int(m.get("points_budget_per_ray", 64))
        self.points_per_ray_masked = int(
            m.get("points_budget_masked_per_ray", 4 * self.points_per_ray)
        )
        self.surf_band_factor = float(m.get("surf_band_factor", 0.0))
        self.phase1_block = int(m.get("phase1_block", 8))
        self._rebuild_mask_blk()

    def set_grid_resolution(self, num_voxels: int) -> None:
        extent = self.xyz_max - self.xyz_min
        self.num_voxels = num_voxels
        self.voxel_size = float((extent.prod() / num_voxels) ** (1 / 3))
        self.world_size = tuple(
            int(x) for x in (extent / self.voxel_size).astype(np.int64)
        )
        diag = float(np.linalg.norm(np.asarray(self.world_size) + 1))
        self.n_samples = int(diag / self.stepsize) + 1
        if hasattr(self, "phase1_block"):
            self._rebuild_mask_blk()

    @property
    def stepdist(self) -> float:
        return self.stepsize * self.voxel_size

    def _rebuild_mask_blk(self) -> None:
        """Block-dilated ``occ_sup`` for the block-granular phase 1: a block
        sample lies within ``halfspan`` of its centre along the ray, so its
        rounded occupancy cell differs from the centre's by at most
        ``floor(halfspan / cell) + 1`` per axis."""
        self._mask_sup_blk = None
        if self.phase1_block <= 1 or self.surf_band_factor > 0:
            return
        mc = self.mask_cache
        X, Y, Z = mc.density.shape[:3]
        ext = mc.xyz_max.cpu().numpy() - mc.xyz_min.cpu().numpy()
        halfspan = (self.phase1_block - 1) / 2 * self.stepdist
        win = tuple(
            2 * (int(np.floor(halfspan * (n - 1) / e)) + 1) + 1
            for n, e in zip((X, Y, Z), ext)
        )
        self._mask_sup_blk = _max_pool_same(mc.occ_sup, win)

    def _query_nearest_blk(self, xyz: torch.Tensor) -> torch.Tensor:
        """Nearest tap on the block-dilated table (block-centre test)."""
        mc = self.mask_cache
        return _nearest_tap(self._mask_sup_blk, mc.density.shape[:3],
                            mc.xyz_min, mc.xyz_max, xyz)

    # -------------------------------------------------------------- helpers

    def grid_xyz(self):
        """[X,Y,Z,3] world coordinates of the voxel centres."""
        axes = [_linspace(float(self.xyz_min[i]), float(self.xyz_max[i]), n,
                          self.device) for i, n in enumerate(self.world_size)]
        return torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1)

    def nonempty_mask(self) -> torch.Tensor:
        """[X,Y,Z] bool: voxels inside the previous stage's occupancy."""
        return self.mask_cache.query(self.grid_xyz())

    def sphere_sdf_init(self) -> torch.Tensor:
        """Unit-sphere SDF, voxels outside the nonempty mask pushed to +1."""
        X, Y, Z = self.world_size
        x, y, z = np.mgrid[-1:1:X * 1j, -1:1:Y * 1j, -1:1:Z * 1j]
        sdf = ((x**2 + y**2 + z**2) ** 0.5 - 1).astype(np.float32)[..., None]
        sdf = torch.as_tensor(sdf, device=self.device)
        ne = self.nonempty_mask()[..., None]
        return torch.where(ne, sdf, torch.ones_like(sdf))

    def sample_dense(self, rays_o, rays_d, near=None) -> rayops.RaySamples:
        """Dense sampling with far = 1e9 (rays march the whole bbox) from
        ``near`` (default: the scene's)."""
        return rayops.sample_rays_dense(
            rays_o, rays_d, self.xyz_min_t, self.xyz_max_t,
            self.near if near is None else near, 1e9, self.stepdist,
            self.n_samples,
        )

    def sdf_gradient(self, sdf_grid: torch.Tensor) -> torch.Tensor:
        """Central-difference gradient, zero at borders: [X,Y,Z,1] ->
        [X,Y,Z,3]."""
        g = sdf_grid[..., 0]
        s = 2 * self.voxel_size
        gx = F.pad((g[2:] - g[:-2]) / s, (0, 0, 0, 0, 1, 1))
        gy = F.pad((g[:, 2:] - g[:, :-2]) / s, (0, 0, 1, 1))
        gz = F.pad((g[:, :, 2:] - g[:, :, :-2]) / s, (1, 1))
        return torch.stack([gx, gy, gz], dim=-1)

    def sample_grid(self, grid: torch.Tensor, pts: torch.Tensor):
        return gridops.grid_sample_3d(grid, pts, self.xyz_min_t,
                                      self.xyz_max_t)

    def sample_grid_sorted(self, grid: torch.Tensor, pts: torch.Tensor,
                           n_valid=None) -> torch.Tensor:
        """One grid at the cell-sorted march points: the corner gather
        (K-4) forward, the splat (K-3) backward. Pad chunks read zeros."""
        return splatops.sorted_trilinear_sample(
            grid, pts.reshape(-1, 3), self.xyz_min_t, self.xyz_max_t,
            n_valid)

    def sample_grids_sorted(self, grids, pts: torch.Tensor, n_valid=None):
        """Several same-resolution grids at the cell-sorted march points
        through one gather; pad chunks read zeros."""
        return splatops.sorted_trilinear_sample_multi(
            tuple(grids), pts.reshape(-1, 3), self.xyz_min_t,
            self.xyz_max_t, n_valid,
        )

    @torch.no_grad()
    def band_occ64(self, sdf_grid: torch.Tensor, s_val) -> torch.Tensor:
        """``[66,66,66]`` f32 0/1: the mask cache's 64^3 occupancy on this
        box (:func:`resample_occ64`) AND the SDF surface band ``|sdf| <=
        surf_band_factor / s_val``, on a 1-padded 64^3 world partition,
        for one nearest tap per sample.

        Conservative: trilinear values inside a cell lie between its corner
        values, so a block passes iff the range of the corners it covers
        meets ``[-band, band]``. The corners are resampled onto a per-axis
        lattice of the multiple of 64 at or above the axis length (every
        corner index hit), min/max-pooled over overlapping windows (width
        p + 1, stride p, edge-padded: adjacent blocks share a corner plane)
        to 64^3, and dilated by one block for nearest-rounding slop. A
        selection mask: no gradient flows through it."""
        a = sdf_grid[..., 0].detach()
        X, Y, Z = a.shape
        dev = a.device

        def lat(n):
            LAT = 64 * (-(-n // 64))
            ll = (torch.arange(LAT, dtype=torch.float32, device=dev) + 0.5) \
                / LAT * (n - 1)
            return torch.clamp(torch.round(ll).to(torch.int64), 0, n - 1), \
                LAT // 64

        (ix, px), (iy, py), (iz, pz) = lat(X), lat(Y), lat(Z)
        a_lat = a[ix][:, iy][:, :, iz]

        def pool_max(v):
            v = torch.cat([v, v[-1:]], 0)
            v = torch.cat([v, v[:, -1:]], 1)
            v = torch.cat([v, v[:, :, -1:]], 2)
            for axis, p in ((0, px), (1, py), (2, pz)):
                v = v.unfold(axis, p + 1, p).amax(-1)
            return v

        mn = -pool_max(-a_lat)
        mx = pool_max(a_lat)
        band = float(np.float32(self.surf_band_factor) / np.float32(s_val))
        ok = ((mn <= band) & (mx >= -band)).to(torch.float32)
        ok = gridops.max_pool_3d_same(ok[..., None], 3)[..., 0]
        return F.pad(ok, (1, 1, 1, 1, 1, 1)) * self.occ64

    def query_nearest64(self, occ: torch.Tensor, xyz: torch.Tensor):
        """Box tap on a ``[66,66,66]`` 1-padded 64^3 world-partition mask
        (:meth:`band_occ64`): block ``floor(frac * 64)``, +1 pad offset."""
        frac = (xyz.reshape(-1, 3) - self.xyz_min_t) \
            / (self.xyz_max_t - self.xyz_min_t)
        i = torch.clamp(torch.floor(frac * 64).to(torch.int64) + 1, 0, 65)
        lin = (i[:, 0] * 66 + i[:, 1]) * 66 + i[:, 2]
        occ_v = occ.reshape(-1).index_select(0, lin) > 0.0
        return occ_v.reshape(xyz.shape[:-1])

    # ------------------------------------------------------------ the march

    def march_budgets(self, N: int, k_budget: int | None = None,
                      k1_budget: int | None = None) -> tuple:
        """``(K1, K2, BLK)`` of a march of ``N`` rays: the phase-1 and
        head budgets (``k1_budget`` / ``k_budget``, default per ray) and
        the phase-1 block. Phase 1 is block-granular: blocks of BLK samples
        are tested once at their centre against the block-dilated mask,
        surviving blocks are compacted whole, and the exact per-sample test
        runs on the K1 list -- the survivor set equals the per-sample
        path's. K1 is a whole number of blocks, at most every sample."""
        S = self.n_samples
        K2 = k_budget or (N * self.points_per_ray)
        K1 = min(k1_budget or (N * self.points_per_ray_masked), N * S)
        BLK = self.phase1_block if (self.surf_band_factor > 0
                                    or self._mask_sup_blk is not None) else 1
        return min(-(-K1 // BLK) * BLK, N * -(-S // BLK) * BLK), K2, BLK

    def march(
        self,
        sdf_grid_smooth: torch.Tensor,
        rays_o: torch.Tensor,
        rays_d: torch.Tensor,
        viewdirs: torch.Tensor,
        s_val,
        fastcolor_thres: float,
        neus_alpha: str = "interp",
        style: str = "coarse",
        k_budget: int | None = None,
        k1_budget: int | None = None,
        near_override: float | None = None,
        gradient_grid: torch.Tensor | None = None,
    ) -> March:
        """Two-phase NeuS march: early compaction, then the scans.

        style="coarse": maskcache skip, NeuS alpha, scan, ``weights >
        fastcolor_thres`` filter, re-scan on the survivors. style="fine": an
        ``alpha > fastcolor_thres`` pre-filter before the scan, then a
        ``weights > fastcolor_thres`` filter without re-scan. With
        ``surf_band_factor > 0`` phase 1 taps the surface-band mask of
        :meth:`band_occ64` instead of the mask cache's superset.
        ``k_budget`` / ``k1_budget`` replace the per-ray head and phase-1
        budgets (K2, K1) and ``near_override`` the scene's near plane (the
        LTS secondary march).

        The four stages run in the spans ``march/phase1`` (ray-box clip,
        occupancy test, phase-1 compaction, points, exact re-test),
        ``march/alpha`` (SDF samples, dense bridge, NeuS alpha),
        ``march/scan`` (the transmittance scans, ``gather_back``) and
        ``march/phase2`` (phase-2 compaction, cell sort, counts).

        ``neus_alpha="interp"`` pairs each sample with its ray's
        neighbours on the dense bridge; ``"grad"`` takes the section from
        ``gradient_grid`` (the SDF gradient, ``[X, Y, Z, 3]``) sampled at
        the phase-1 points and the ray's direction, pointwise, so only the
        alphas cross the bridge.
        """
        if neus_alpha not in ("interp", "grad"):
            raise ValueError(f"unknown neus_alpha '{neus_alpha}' (interp or "
                             "grad)")
        if neus_alpha == "grad" and gradient_grid is None:
            raise ValueError("march: neus_alpha='grad' needs gradient_grid")
        if style not in ("coarse", "fine"):
            raise ValueError(f"unknown march style '{style}'")
        dev = rays_o.device
        N = rays_o.shape[0]
        S = self.n_samples
        band = self.surf_band_factor > 0
        K1, K2, BLK = self.march_budgets(N, k_budget, k1_budget)
        SB = -(-S // BLK)
        Sp = SB * BLK  # dense-bridge row stride

        with profiling.span("march/phase1"):
            mn, mx = self.xyz_min_t, self.xyz_max_t
            near_v = self.near if near_override is None else near_override
            occ = self.band_occ64(sdf_grid_smooth, s_val) if band else None
            t_min, t_max = rayops.ray_aabb(rays_o, rays_d, mn, mx, near_v, 1e9)
            rnorm = rayops.ray_norm(rays_d)
            n_steps = torch.clamp(
                torch.ceil((t_max - t_min) * rnorm / self.stepdist), min=1.0)

            if BLK > 1:
                sbc = (torch.arange(SB, dtype=rays_o.dtype, device=dev) * BLK
                       + (BLK - 1) / 2)
                start = rays_o + rays_d * t_min[:, None]
                dirn = rays_d / rnorm[:, None]
                cpts = (start[:, None, :]
                        + dirn[:, None, :]
                        * (self.stepdist * sbc)[None, :, None])
                blk_in = (sbc[None, :] - (BLK - 1) / 2) < n_steps[:, None]
                if band:
                    # block-conservative dilation of the band mask: a block
                    # sample lies within halfspan of its centre, so its 64^3
                    # cell differs from the centre's by at most
                    # floor(halfspan / cell) + 1 per axis
                    halfspan = (BLK - 1) / 2 * self.stepdist
                    cell64 = float((self.xyz_max - self.xyz_min).min()) / 64.0
                    r = int(np.floor(halfspan / cell64)) + 1
                    occ_blk = gridops.max_pool_3d_same(occ[..., None],
                                                       2 * r + 1)[..., 0]
                    blk_hit = self.query_nearest64(occ_blk, cpts)
                else:
                    blk_hit = self._query_nearest_blk(cpts)
                sup_blk = blk_in & blk_hit  # [N, SB]

                # ---- phase-1 compaction at block granularity (ray-major)
                n1 = sup_blk.sum() * BLK  # blocks enter whole
                idxb = fixed_size_nonzero(sup_blk, K1 // BLK)
                padb = idxb < 0
                idxbc = torch.clamp(idxb, min=0)
                rayb = torch.where(padb, torch.full_like(idxbc, N),
                                   idxbc // SB)
                jj = torch.arange(BLK, device=dev)
                ray1 = rayb.repeat_interleave(BLK)
                step1 = ((idxbc % SB) * BLK)[:, None] + jj[None, :]
                step1 = torch.where(padb[:, None], torch.zeros_like(step1),
                                    step1).reshape(-1)
                pad1 = padb.repeat_interleave(BLK)
            else:
                rs = self.sample_dense(rays_o, rays_d, near=near_override)
                occ_hit = (self.query_nearest64(occ, rs.pts) if band
                           else self.mask_cache.query_nearest(rs.pts))
                sup = rs.valid & occ_hit

                # ---- phase-1 compaction (order-preserving => ray-major)
                n1 = sup.sum()
                idx1 = fixed_size_nonzero(sup, K1)
                pad1 = idx1 < 0
                idx1c = torch.clamp(idx1, min=0)
                ray1 = torch.where(pad1, torch.full_like(idx1c, N), idx1c // S)
                step1 = torch.where(pad1, torch.zeros_like(idx1c), idx1c % S)

            # compacted points recomputed from (ray, step), the same float
            # expression as sample_rays_dense: p = start + dirn * stepdist * s
            r1c = torch.clamp(ray1, max=N - 1)
            ray_pack = torch.cat(
                [rays_o + rays_d * t_min[:, None], rays_d / rnorm[:, None],
                 n_steps[:, None]], -1
            )  # [N, 7] (start, dirn, count)
            rp = ray_pack.index_select(0, r1c)
            sd = self.stepdist * step1.to(rays_o.dtype)
            pts1 = torch.stack(
                [rp[:, 0] + rp[:, 3] * sd,
                 rp[:, 1] + rp[:, 4] * sd,
                 rp[:, 2] + rp[:, 5] * sd], -1)

            if BLK > 1:
                # exact per-sample re-test on the compacted list
                in_cnt = step1.to(rays_o.dtype) < rp[:, 6]
                in_bb = ((pts1 >= mn) & (pts1 <= mx)).all(-1)
                occ_ok = (self.query_nearest64(occ, pts1) if band
                          else self.mask_cache.query_nearest(pts1))
                samp_ok = ~pad1 & in_cnt & in_bb & occ_ok
            else:
                samp_ok = ~pad1

            exact = samp_ok & self.mask_cache.query(pts1)

        with profiling.span("march/alpha"):
            sdf1 = self.sample_grid(sdf_grid_smooth, pts1)[..., 0]  # [K1]

            # ---- dense scalar bridge: scatter the compacted scalars back to
            # their (ray, step) slot; lin is ascending and pads land in row N
            lin = torch.clamp(ray1, max=N) * Sp + step1
            dsize = (N + 1) * Sp
            nv1 = torch.clamp(n1, max=K1).to(torch.int32)

            def to_dense(x):
                full = splatops.sorted_scatter_1d(lin, x, dsize, n_valid=nv1)
                return full.reshape(N + 1, Sp)[:N]

            if neus_alpha == "grad":
                grad1 = self.sample_grid(gradient_grid, pts1)
                alpha_d = to_dense(renderops.neus_alpha_grad_flat(
                    sdf1, grad1, viewdirs.index_select(0, r1c), self.stepdist,
                    exact, s_val))
            else:
                alpha_d = renderops.neus_alpha_interp(
                    to_dense(sdf1), to_dense(exact), s_val)

        with profiling.span("march/scan"):
            def gather_back(cols):
                dense = torch.stack(cols, -1).reshape(-1, len(cols))
                dense = torch.cat([dense, dense.new_zeros((Sp, len(cols)))])
                return splatops.sorted_gather_rows(dense, lin, n_valid=nv1)

            zero_d = torch.zeros_like(alpha_d)
            if style == "fine":
                # alpha is 0 at invalid slots
                pre_d = alpha_d > fastcolor_thres
                a1_d = torch.where(pre_d, alpha_d, zero_d)
                w1_d, alphainv_last = scanops.alpha2weights_scan(
                    a1_d, renderops.EARLY_EXIT_T)
                flat2 = gather_back([a1_d, w1_d])
                keep = (flat2[:, 1] > fastcolor_thres) & ~pad1
                zero = torch.zeros_like(flat2[:, 0])
                alpha2 = torch.where(keep, flat2[:, 0], zero)
                weights = torch.where(keep, flat2[:, 1], zero)
            else:
                w1_d, _ = scanops.alpha2weights_scan(alpha_d,
                                                     renderops.EARLY_EXIT_T)
                keep_d = w1_d > fastcolor_thres
                alpha2_d = torch.where(keep_d, alpha_d, zero_d)
                w_d, alphainv_last = scanops.alpha2weights_scan(
                    alpha2_d, renderops.EARLY_EXIT_T)
                flat3 = gather_back([alpha_d, w1_d, w_d])
                keep = (flat3[:, 1] > fastcolor_thres) & ~pad1
                alpha2 = torch.where(keep, flat3[:, 0],
                                     torch.zeros_like(flat3[:, 0]))
                weights = flat3[:, 2]

        with profiling.span("march/phase2"):
            # ---- phase-2 compaction to the static K2 head budget
            n2 = keep.sum()
            idx2 = fixed_size_nonzero(keep, K2)
            pad = idx2 < 0
            # pads clamp to the LAST row so idx2c stays ascending
            idx2c = torch.where(pad, torch.full_like(idx2, K1 - 1), idx2)

            pack1 = torch.cat(
                [pts1, weights[:, None], alpha2[:, None], sdf1[:, None]], -1
            )  # [K1, 6]
            nv2 = torch.clamp(n2, max=K2).to(torch.int32)
            pack2 = splatops.sorted_gather_rows(pack1, idx2c, n_valid=nv2)
            lin2 = lin.index_select(0, idx2c)

            # re-order the compacted points by grid cell (every consumer is
            # order-agnostic; the cell order gives the gather/splat locality)
            X, Y, Z = self.world_size
            ind = gridops.normalized_index(pack2[:, 0:3].detach(), mn, mx,
                                           (X, Y, Z))
            i0 = torch.floor(ind).to(torch.int64)
            cell = (i0[:, 0] * Y + i0[:, 1]) * Z + i0[:, 2]
            key = torch.where(pad, torch.full_like(cell, _PAD_KEY), cell)
            key, perm = torch.sort(key, stable=True)
            inv_perm = torch.empty_like(perm).scatter_(
                0, perm, torch.arange(perm.numel(), device=dev))
            pack2 = splatops.permute_rows(pack2, perm, inv_perm)
            lin2 = lin2.index_select(0, perm)
            pad = pad.index_select(0, perm)

            pts_c = pack2[:, 0:3]
            # pad rows collapse onto the last real (max-cell) row, so the base
            # cells stay ascending and the pad tail is one cell
            last_idx = torch.clamp(nv2.to(torch.int64) - 1, min=0).reshape(1)
            last_real = pts_c.index_select(0, last_idx)
            pts_c = torch.where(pad[:, None], last_real, pts_c)
            zero = torch.zeros_like(pack2[:, 3])
            w_c = torch.where(pad, zero, pack2[:, 3])
            a_c = torch.where(pad, zero, pack2[:, 4])
            sdf_c = torch.where(pad, zero, pack2[:, 5])
            ray_c = torch.where(pad, torch.full_like(lin2, N), lin2 // Sp)
            step_c = torch.where(pad, torch.zeros_like(lin2), lin2 % Sp)

            cum_weights = torch.zeros(N + 1, dtype=w_c.dtype, device=dev) \
                .index_add(0, ray_c, w_c)[:N]
            n12 = torch.stack([n1, n2]).to(torch.float32)
            k12 = torch.full_like(n12, K1)
            k12[1] = K2
            counts = torch.cat([n12, k12, torch.clamp(n12 - k12, min=0)])
            overflow, k1_frac, k2_frac = march_fractions(counts)
        return March(
            pts=pts_c, ray_id=ray_c, step_id=step_c, weights=w_c, alpha=a_c,
            sdf=sdf_c, pad=pad, alphainv_last=alphainv_last,
            cum_weights=cum_weights, n_rays=N, overflow=overflow,
            n_valid=nv2, k1_frac=k1_frac, k2_frac=k2_frac, key=key,
            counts=counts,
        )

    @torch.no_grad()
    def march_ray_slots(self, sdf_grid_smooth, rays_o, rays_d, viewdirs,
                        s_val, fastcolor_thres, neus_alpha, ppr: int):
        """One fine-style march with its surviving samples regrouped per
        ray: ``(pts [N, ppr, 3], valid [N, ppr], (counts [N], dropped
        [N]))``. The relighting fine-tune's SDF is frozen, so its march is
        a function of the ray alone and runs once per test image. A ray
        keeps its first ``ppr`` samples in the march's cell order and drops
        the rest (``dropped``); ``counts`` are its survivors."""
        m = self.march(sdf_grid_smooth, rays_o, rays_d, viewdirs, s_val,
                       fastcolor_thres, neus_alpha, style="fine")
        N, K = m.n_rays, m.pts.shape[0]
        dev = m.pts.device
        # group rows by ray; the stable sort keeps the cell order within a
        # ray, and pads (ray id N) land at the end
        order = torch.argsort(m.ray_id, stable=True)
        rid_s = m.ray_id.index_select(0, order)
        pts_s = m.pts.index_select(0, order)
        pad_s = m.pad.index_select(0, order)
        starts = torch.searchsorted(
            rid_s, torch.arange(N, dtype=rid_s.dtype, device=dev))
        rank = torch.arange(K, device=dev) - starts.index_select(
            0, torch.clamp(rid_s, max=N - 1))
        ok = ~pad_s & (rank < ppr)
        # every kept row has its own slot; the rest go to a dump row
        tgt = torch.where(ok, rid_s * ppr + torch.clamp(rank, 0, ppr - 1),
                          torch.full_like(rid_s, N * ppr))
        pts_slots = torch.zeros((N * ppr + 1, 3), dtype=torch.float32,
                                device=dev).index_put_((tgt,), pts_s)
        valid = torch.zeros(N * ppr + 1, dtype=torch.bool,
                            device=dev).index_put_((tgt,), ok)
        counts = torch.zeros(N + 1, dtype=torch.int32, device=dev).index_add_(
            0, torch.clamp(rid_s, max=N), (~pad_s).to(torch.int32))[:N]
        dropped = torch.clamp(counts - ppr, min=0)
        return (pts_slots[:-1].reshape(N, ppr, 3),
                valid[:-1].reshape(N, ppr), (counts, dropped))

    def segment_to_rays(self, march: March, values: torch.Tensor):
        """Weighted per-ray sum of per-point values (``index_add_``; on
        CUDA its atomics sum in no fixed order)."""
        w = march.weights[:, None] if values.ndim == 2 else march.weights
        out = torch.zeros((march.n_rays + 1, *values.shape[1:]),
                          dtype=values.dtype, device=values.device)
        return out.index_add(0, march.ray_id, w * values)[: march.n_rays]

    # ------------------------------------- multi-scale SDF features/normals

    def sample_sdfeat_grad_normal(self, sdf_grid, pts, displace,
                                  n_valid=None):
        """Displaced 6-neighbour SDF taps, finite-difference gradients and
        normalized normals: features ``[M, 6*D]`` (-z,+z,-y,+y,-x,+x per
        displacement), gradients ``[M, 3*D]`` in (z,y,x) order, normals
        ``[M, 3*D]``."""
        displace_t = tuple(float(d) for d in np.asarray(displace).reshape(-1))
        D = len(displace_t)
        X, Y, Z = sdf_grid.shape[:3]
        mn, mx = self.xyz_min_t, self.xyz_max_t

        feat = gridops.displaced_taps(sdf_grid, pts, mn, mx, displace_t,
                                      n_valid)  # [M, 6, D]

        # actual (clamped) index distance along the displaced axis
        ind = gridops.normalized_index(pts, mn, mx, (X, Y, Z))
        dd = small_const(displace_t, torch.float32, pts.device)
        axes = torch.stack([ind[:, 2], ind[:, 1], ind[:, 0]], -1)  # (z,y,x)
        hi = small_const((Z - 1.0, Y - 1.0, X - 1.0), torch.float32,
                         pts.device)
        q_plus = torch.minimum(torch.clamp(axes[..., None] + dd, min=0.0),
                               hi[:, None])
        q_minus = torch.minimum(torch.clamp(axes[..., None] - dd, min=0.0),
                                hi[:, None])
        diff = q_plus - q_minus  # [M, 3, D]

        feat_diff = feat[:, 1::2] - feat[:, 0::2]
        grad = feat_diff / diff / self.voxel_size
        # vector_norm's gradient is 0 at a zero vector (pad-chunk rows)
        normal = grad / torch.clamp(
            torch.linalg.vector_norm(grad, dim=1, keepdim=True), min=1e-12)

        M = pts.shape[0]
        return (feat.reshape(M, 6 * D), grad.reshape(M, 3 * D),
                normal.reshape(M, 3 * D))

    def sample_sdf_grad(self, sdf_grid: torch.Tensor, pts: torch.Tensor):
        """SDF value ``[M]`` and xyz-ordered 1-voxel finite-difference
        gradient ``[M, 3]``."""
        sdf = self.sample_grid(sdf_grid, pts)[..., 0]
        _, grad, _ = self.sample_sdfeat_grad_normal(sdf_grid, pts, (1.0,))
        grad_xyz = torch.stack([grad[:, 2], grad[:, 1], grad[:, 0]], dim=-1)
        return sdf, grad_xyz

    # -------------------------------------------------- training-ray filter

    @torch.no_grad()
    def filter_rays_in_maskcache(self, rays_o: np.ndarray, rays_d: np.ndarray,
                                 chunk: int,
                                 style: str = "dvgo") -> np.ndarray:
        """Host bool mask of the rays whose samples hit the mask cache at
        least once, ``chunk`` rays at a time on the geometry's device. Both
        samplers are ported: ``dvgo`` (the coarse stage's: DVGO's
        un-normalised march between ``near`` and ``far``) and ``voxurf``
        (the fine stage's: the march's sampler with far = 1e9)."""
        if style not in ("dvgo", "voxurf"):
            raise ValueError(f"unknown ray-filter style '{style}'")
        out = np.ones(len(rays_o), dtype=bool)
        for st in range(0, len(rays_o), chunk):
            en = min(st + chunk, len(rays_o))
            ro = torch.as_tensor(rays_o[st:en], device=self.device)
            rd = torch.as_tensor(rays_d[st:en], device=self.device)
            if style == "voxurf":
                rs = self.sample_dense(ro, rd)
                ok = rs.valid & self.mask_cache.query(rs.pts)
            else:
                pts, outb = rayops.sample_rays_dvgo(
                    ro, rd, self.xyz_min_t, self.xyz_max_t, self.near,
                    self.far, self.stepsize, self.voxel_size, self.n_samples)
                ok = ~outb & self.mask_cache.query(pts)
            out[st:en] = ok.any(-1).cpu().numpy()
        return out

    # --------------------------------------------------------------- meshes

    @torch.no_grad()
    def extract_geometry(self, sdf_grid: torch.Tensor, resolution: int = 512,
                         threshold: float = 0.0, smooth: bool = True,
                         sigma: float = 0.5, max_points: int = 2**22):
        """Marching-tetrahedra mesh ``(verts [V, 3], tris [T, 3])`` in world
        coordinates of the (optionally Gaussian-smoothed) SDF's zero set,
        from a ``resolution^3`` field sampled on the SDF's device
        ``max_points`` at a time."""
        from esrnerf_tpu_torch.utils import mesh as meshutil

        if smooth:
            kern = gridops.make_gaussian_kernel_3d(3, sigma)
            sdf_grid = gridops.conv3d_replicate(sdf_grid, kern)

        u = meshutil.extract_fields(
            self.xyz_min, self.xyz_max, resolution,
            lambda pts: -self.sample_grid(sdf_grid, pts)[..., 0],
            max_points, device=self.device,
        )
        verts, tris = meshutil.marching_cubes(u, threshold)
        verts = verts / (resolution - 1.0) * (
            self.xyz_max - self.xyz_min
        )[None, :] + self.xyz_min[None, :]
        return verts, tris
