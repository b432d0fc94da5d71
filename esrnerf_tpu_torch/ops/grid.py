"""Dense voxel-grid sampling, pooling and smoothing on ``[X, Y, Z, C]``
grids.

Port of the parts of ``esrnerf_tpu/ops/grid.py`` that the stages up to LTS
use.
Sampling is trilinear with ``align_corners=True``: a point at ``xyz_min``
maps to index 0 and ``xyz_max`` to ``dim - 1``; ``mode='zeros'`` gives
out-of-range corners zero weight. Forwards are plain PyTorch gathers; the
grid gradients of :func:`grid_sample_3d` and :func:`displaced_taps` and the
tap forward go through the splat and gather kernels of
:mod:`esrnerf_tpu_torch.ops.splat`. :func:`grid_sample_3d_coordgrad` (the
LTS normals) is plain PyTorch both ways, as its reference is plain
``jnp.take``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from esrnerf_tpu_torch.utils.device import small_const


def normalized_index(xyz, xyz_min, xyz_max, size: Sequence[int]):
    """World coordinates -> fractional voxel indices (align_corners=True)."""
    sz = small_const(size, xyz.dtype, xyz.device)
    t = (xyz - xyz_min) / (xyz_max - xyz_min)
    return t * (sz - 1.0)


def corner_offsets_dmajor(Y: int, Z: int):
    """Corner linear offsets in ``d = dx*4 + dy*2 + dz`` order."""
    return [(d >> 2 & 1) * Y * Z + (d >> 1 & 1) * Z + (d & 1)
            for d in range(8)]


def corner_base_weights(size3, pts, xyz_min, xyz_max):
    """Base-cell linear index ``[M]`` (int64, may be out of range) and the
    eight zeros-mode corner weights ``[M, 8]`` in d-major order."""
    X, Y, Z = size3
    idx = normalized_index(pts, xyz_min, xyz_max, (X, Y, Z))
    i0 = torch.floor(idx).to(torch.int64)
    base = (i0[:, 0] * Y + i0[:, 1]) * Z + i0[:, 2]
    size = small_const((X, Y, Z), torch.int64, pts.device)
    v0 = (i0 >= 0) & (i0 < size)
    v1 = (i0 + 1 >= 0) & (i0 + 1 < size)
    fx = idx[:, 0] - i0[:, 0]
    fy = idx[:, 1] - i0[:, 1]
    fz = idx[:, 2] - i0[:, 2]
    w = []
    for d in range(8):
        dx, dy, dz = d >> 2 & 1, d >> 1 & 1, d & 1
        ok = ((v1 if dx else v0)[:, 0] & (v1 if dy else v0)[:, 1]
              & (v1 if dz else v0)[:, 2])
        w.append((fx if dx else 1 - fx) * (fy if dy else 1 - fy)
                 * (fz if dz else 1 - fz) * ok)
    return base, torch.stack(w, 1)


def grid_sample_3d_impl(grid, xyz, xyz_min, xyz_max, mode: str = "zeros"):
    """Trilinear sample of a ``[X, Y, Z, C]`` grid at world points
    ``[..., 3]`` as eight plain row gathers (native autograd)."""
    if grid.ndim != 4:
        raise ValueError(f"grid must be [X,Y,Z,C], got {tuple(grid.shape)}")
    X, Y, Z, C = grid.shape
    lead_shape = xyz.shape[:-1]
    pts = xyz.reshape(-1, 3)

    idx = normalized_index(pts, xyz_min, xyz_max, (X, Y, Z))
    i0f = torch.floor(idx)
    frac = idx - i0f
    i0 = i0f.to(torch.int64)
    i1 = i0 + 1

    size = small_const((X, Y, Z), torch.int64, grid.device)
    if mode == "zeros":
        v0 = (i0 >= 0) & (i0 < size)
        v1 = (i1 >= 0) & (i1 < size)
    elif mode == "border":
        v0 = v1 = torch.ones_like(i0, dtype=torch.bool)
    else:
        raise ValueError(f"unknown padding mode '{mode}'")

    zero = torch.zeros_like(size)
    c0 = torch.clamp(i0, min=zero, max=size - 1)
    c1 = torch.clamp(i1, min=zero, max=size - 1)

    flat = grid.reshape(-1, C)
    yz = Y * Z

    def tap(ix, iy, iz, vx, vy, vz, w):
        vals = flat.index_select(0, ix * yz + iy * Z + iz)
        return vals * (w * (vx & vy & vz).to(grid.dtype))[:, None]

    fx, fy, fz = frac[:, 0], frac[:, 1], frac[:, 2]
    gx0, gx1 = 1 - fx, fx
    gy0, gy1 = 1 - fy, fy
    gz0, gz1 = 1 - fz, fz

    out = (
        tap(c0[:, 0], c0[:, 1], c0[:, 2], v0[:, 0], v0[:, 1], v0[:, 2], gx0 * gy0 * gz0)
        + tap(c0[:, 0], c0[:, 1], c1[:, 2], v0[:, 0], v0[:, 1], v1[:, 2], gx0 * gy0 * gz1)
        + tap(c0[:, 0], c1[:, 1], c0[:, 2], v0[:, 0], v1[:, 1], v0[:, 2], gx0 * gy1 * gz0)
        + tap(c0[:, 0], c1[:, 1], c1[:, 2], v0[:, 0], v1[:, 1], v1[:, 2], gx0 * gy1 * gz1)
        + tap(c1[:, 0], c0[:, 1], c0[:, 2], v1[:, 0], v0[:, 1], v0[:, 2], gx1 * gy0 * gz0)
        + tap(c1[:, 0], c0[:, 1], c1[:, 2], v1[:, 0], v0[:, 1], v1[:, 2], gx1 * gy0 * gz1)
        + tap(c1[:, 0], c1[:, 1], c0[:, 2], v1[:, 0], v1[:, 1], v0[:, 2], gx1 * gy1 * gz0)
        + tap(c1[:, 0], c1[:, 1], c1[:, 2], v1[:, 0], v1[:, 1], v1[:, 2], gx1 * gy1 * gz1)
    )
    return out.reshape(*lead_shape, C)


class _GridSample3d(torch.autograd.Function):
    @staticmethod
    def forward(ctx, grid, xyz, xyz_min, xyz_max):
        ctx.save_for_backward(xyz, xyz_min, xyz_max)
        ctx.grid_shape = tuple(grid.shape)
        return grid_sample_3d_impl(grid, xyz, xyz_min, xyz_max, "zeros")

    @staticmethod
    def backward(ctx, ct):
        from esrnerf_tpu_torch.ops import splat as splatops

        xyz, xyz_min, xyz_max = ctx.saved_tensors
        C = ctx.grid_shape[-1]
        dgrid = splatops.trilinear_splat(
            ctx.grid_shape, xyz.reshape(-1, 3), ct.reshape(-1, C),
            xyz_min, xyz_max,
        )
        return dgrid.to(ct.dtype), None, None, None


def grid_sample_3d(grid, xyz, xyz_min, xyz_max, mode: str = "zeros"):
    """Zeros-mode trilinear sample (plain gathers) whose grid gradient is
    the splat kernel. Not differentiable w.r.t. ``xyz``: every call site
    samples at ray-geometry points that carry no parameter gradient."""
    if mode != "zeros":
        raise NotImplementedError(
            "grid_sample_3d: only mode='zeros' is ported (the fine step's "
            "mode); use grid_sample_3d_impl for a forward-only border sample"
        )
    return _GridSample3d.apply(grid, xyz, xyz_min, xyz_max)


def grid_sample_3d_coordgrad(grid, xyz, xyz_min, xyz_max):
    """Trilinear sample of a ``[X,Y,Z,1]`` grid and the closed-form
    spatial gradient of the interpolant, from the same 8 corner gathers:
    ``(val [...], dval_dxyz [..., 3])``. Plain PyTorch gathers with native
    autograd, so both outputs are differentiable w.r.t. ``grid`` and
    ``xyz``."""
    X, Y, Z, C = grid.shape
    if C != 1:
        raise ValueError("grid_sample_3d_coordgrad samples a [X,Y,Z,1] grid")
    pts = xyz.reshape(-1, 3)
    size = small_const((X, Y, Z), torch.int64, grid.device)
    idx = normalized_index(pts, xyz_min, xyz_max, (X, Y, Z))
    i0 = torch.floor(idx).to(torch.int64)
    frac = idx - i0
    i1 = i0 + 1
    v0 = (i0 >= 0) & (i0 < size)
    v1 = (i1 >= 0) & (i1 < size)
    zero = torch.zeros_like(size)
    c0 = torch.clamp(i0, min=zero, max=size - 1)
    c1 = torch.clamp(i1, min=zero, max=size - 1)
    flat = grid.reshape(-1)
    yz = Y * Z

    fx, fy, fz = frac[:, 0], frac[:, 1], frac[:, 2]
    val = None
    grad = None
    for d in range(8):
        dx, dy, dz = (d >> 2) & 1, (d >> 1) & 1, d & 1
        ix = c1[:, 0] if dx else c0[:, 0]
        iy = c1[:, 1] if dy else c0[:, 1]
        iz = c1[:, 2] if dz else c0[:, 2]
        ok = ((v1 if dx else v0)[:, 0] & (v1 if dy else v0)[:, 1]
              & (v1 if dz else v0)[:, 2]).to(grid.dtype)
        v = flat.index_select(0, ix * yz + iy * Z + iz) * ok
        wx = fx if dx else 1 - fx
        wy = fy if dy else 1 - fy
        wz = fz if dz else 1 - fz
        sx = 1.0 if dx else -1.0
        sy = 1.0 if dy else -1.0
        sz = 1.0 if dz else -1.0
        t_val = v * wx * wy * wz
        t_grad = v[:, None] * torch.stack(
            [sx * wy * wz, wx * sy * wz, wx * wy * sz], -1)
        val = t_val if val is None else val + t_val
        grad = t_grad if grad is None else grad + t_grad
    scale = (small_const((X, Y, Z), grid.dtype, grid.device) - 1.0) \
        / (xyz_max - xyz_min)
    grad = grad * scale[None, :]
    lead = xyz.shape[:-1]
    return val.reshape(lead), grad.reshape(*lead, 3)


# ---------------------------------------------------------------------------
# Displaced multi-tap SDF sampler: per point and axis, the SDF at
# +-d voxels for each displacement d. All displaced samples of a point along
# one axis live in a W-wide window of that axis, so per axis the taps are
# 4 cross-axis corners x W window slots of raw grid values (K-4 raw), mixed
# by per-point weights.
# ---------------------------------------------------------------------------


def _axis_perm(axis: int) -> Tuple[int, int, int]:
    """(b, c, a): grid-axis order with the windowed axis minor."""
    others = [ax for ax in (0, 1, 2) if ax != axis]
    return others[0], others[1], axis


def _window_geometry(grid_shape, pts, xyz_min, xyz_max, displace):
    """Shared index math of the taps' forward and backward (no gathers)."""
    X, Y, Z = grid_shape
    size_i = np.array([X, Y, Z], np.int64)
    dd_np = np.asarray(displace, np.float32)
    maxd = int(np.ceil(float(dd_np.max())))
    dd = small_const([float(d) for d in dd_np], torch.float32, pts.device)

    sizef = small_const((X, Y, Z), torch.float32, pts.device)
    ind = normalized_index(pts, xyz_min, xyz_max, (X, Y, Z))
    ind_c = torch.minimum(torch.clamp(ind, min=0.0), sizef - 1.0)

    per_axis = []
    for axis in range(3):
        b, c, a = _axis_perm(axis)
        Sa, Sb, Sc = int(size_i[a]), int(size_i[b]), int(size_i[c])
        W = min(2 * maxd + 2, Sa)
        ub, uc = ind_c[:, b], ind_c[:, c]
        i0b = torch.clamp(torch.floor(ub).to(torch.int64), 0, Sb - 2)
        i0c = torch.clamp(torch.floor(uc).to(torch.int64), 0, Sc - 2)
        fb = ub - i0b
        fc = uc - i0c

        f0 = torch.floor(ind_c[:, a]).to(torch.int64)
        w0 = torch.clamp(f0 - maxd, 0, Sa - W)

        # displaced coords along the axis: [-d, +d] per displacement
        qm = torch.clamp(ind[:, a, None] - dd[None, :], 0.0, Sa - 1.0)
        qp = torch.clamp(ind[:, a, None] + dd[None, :], 0.0, Sa - 1.0)
        q = torch.stack([qm, qp], dim=1)  # [M, 2, D] (-, +)
        i0q = torch.clamp(torch.floor(q).to(torch.int64), 0, Sa - 2)
        fq = q - i0q
        rel = i0q - w0[:, None, None]  # in [0, W-2]

        per_axis.append(dict(axis=axis, a=a, b=b, c=c, Sa=Sa, Sb=Sb, Sc=Sc,
                             i0b=i0b, i0c=i0c, fb=fb, fc=fc, w0=w0, rel=rel,
                             fq=fq, q=q, W=W))
    return per_axis


def _slot_weights(g) -> torch.Tensor:
    """``[M, 2, D, W]`` linear weights of each tap over the window slots."""
    j = torch.arange(g["W"], device=g["rel"].device)
    rel, fq = g["rel"][..., None], g["fq"][..., None]
    return (j == rel) * (1.0 - fq) + (j == rel + 1) * fq


def _displaced_taps_fwd_impl(grid, pts, xyz_min, xyz_max, displace,
                             n_valid=None):
    from esrnerf_tpu_torch.ops import splat as splatops

    X, Y, Z, C = grid.shape
    if C != 1:
        raise ValueError("displaced_taps samples a [X,Y,Z,1] grid")
    per_axis = _window_geometry((X, Y, Z), pts, xyz_min, xyz_max, displace)
    flat = grid.reshape(-1, 1)
    strides = (Y * Z, Z, 1)

    # offset order: (-z, +z, -y, +y, -x, +x) => axis order z, y, x
    out = []
    for g in (per_axis[2], per_axis[1], per_axis[0]):
        W = g["W"]
        sa, sb, sc = strides[g["a"]], strides[g["b"]], strides[g["c"]]
        wcol4 = torch.stack(
            [(g["fb"] if db else 1 - g["fb"]) * (g["fc"] if dc else 1 - g["fc"])
             for db in (0, 1) for dc in (0, 1)], -1,
        )  # [M, 4]
        base = g["i0b"] * sb + g["i0c"] * sc + g["w0"] * sa
        offs = [db * sb + dc * sc + jj * sa
                for db in (0, 1) for dc in (0, 1) for jj in range(W)]
        raw = splatops.sorted_corner_gather(
            flat, base, None, offs, raw=True, n_valid=n_valid,
        ).reshape(-1, 4, W)
        win = torch.einsum("mkw,mk->mw", raw, wcol4)
        out.append(torch.einsum("mw,msdw->msd", win, _slot_weights(g)))
    return torch.cat(out, dim=1)  # [M, 6, D] z-,z+,y-,y+,x-,x+


class _DisplacedTaps(torch.autograd.Function):
    @staticmethod
    def forward(ctx, grid, pts, xyz_min, xyz_max, displace, n_valid):
        ctx.save_for_backward(pts, xyz_min, xyz_max)
        ctx.grid_shape = tuple(grid.shape)
        ctx.displace = displace
        ctx.n_valid = n_valid
        return _displaced_taps_fwd_impl(grid, pts, xyz_min, xyz_max,
                                        displace, n_valid)

    @staticmethod
    def backward(ctx, ct):
        from esrnerf_tpu_torch.ops import splat as splatops

        pts, xyz_min, xyz_max = ctx.saved_tensors
        dgrid = splatops.displaced_taps_splat(
            ctx.grid_shape, pts, ct, xyz_min, xyz_max, ctx.displace,
            n_valid=ctx.n_valid,
        )
        return dgrid, None, None, None, None, None


def displaced_taps(grid, pts, xyz_min, xyz_max, displace, n_valid=None):
    """Border-mode trilinear taps at ``pts +- d * voxel`` along each axis.

    grid: ``[X,Y,Z,1]``; pts: ``[M,3]`` world coords; displace: tuple of D
    voxel displacements. Returns ``[M, 6, D]`` in the offset order
    (-z, +z, -y, +y, -x, +x). Rows of whole 2048-row chunks at or after
    ``n_valid`` read zeros. Not differentiable w.r.t. ``pts``.
    """
    return _DisplacedTaps.apply(grid, pts, xyz_min, xyz_max,
                                tuple(float(d) for d in displace), n_valid)


# ------------------------------------------------------------------ resize


@torch.no_grad()
def resize_trilinear(grid: torch.Tensor, new_size, slab: int = 16):
    """Trilinear resize of a ``[X, Y, Z, C]`` grid to ``new_size``
    (align_corners=True, border mode): the new voxel centres sampled in the
    old grid's index space, ``slab`` output x-planes at a time to bound the
    temporaries. No gradient (the trainer resizes between steps)."""
    X, Y, Z, C = grid.shape
    nx, ny, nz = (int(n) for n in new_size)
    dev = grid.device

    def axis(n_old, n_new):
        # index-space voxel centres, i * delta with the endpoint exact (the
        # JAX package's linspace from 0 as XLA evaluates it)
        if n_new == 1:
            return torch.zeros((1,), dtype=torch.float32, device=dev)
        delta = float(np.float32(n_old - 1) / np.float32(n_new - 1))
        t = torch.arange(n_new, dtype=torch.float32, device=dev) * delta
        t[-1] = float(n_old - 1)
        return t

    gx, gy, gz = axis(X, nx), axis(Y, ny), axis(Z, nz)
    zero = torch.zeros((3,), dtype=torch.float32, device=dev)
    top = torch.tensor([X - 1.0, Y - 1.0, Z - 1.0], device=dev)
    out = torch.empty((nx, ny, nz, C), dtype=grid.dtype, device=dev)
    for x0 in range(0, nx, slab):
        xx, yy, zz = torch.meshgrid(gx[x0:x0 + slab], gy, gz, indexing="ij")
        pts = torch.stack([xx, yy, zz], -1)
        out[x0:x0 + slab] = grid_sample_3d_impl(grid, pts, zero, top,
                                                mode="border")
    return out


def make_gaussian_kernel_3d(ksize: int = 3, sigma: float = 1.0) -> np.ndarray:
    """Normalized ``[k, k, k]`` Gaussian kernel."""
    r = np.arange(-(ksize // 2), ksize // 2 + 1, 1)
    xx, yy, zz = np.meshgrid(r, r, r)
    k = np.exp(-(xx**2 + yy**2 + zz**2) / (2 * sigma**2))
    return (k / k.sum()).astype(np.float32)


# --------------------------------------------------------- pooling, smoothing


def max_pool_3d_same(grid: torch.Tensor, ks: int) -> torch.Tensor:
    """Stride-1 3-D max pool with padding ``ks // 2`` over ``[X,Y,Z,C]``,
    as three separable 1-D pools."""
    p = ks // 2
    x = grid.permute(3, 0, 1, 2)[None]  # [1, C, X, Y, Z]
    for axis in range(3):
        k, pad = [1, 1, 1], [0, 0, 0]
        k[axis], pad[axis] = ks, p
        x = F.max_pool3d(x, tuple(k), stride=1, padding=tuple(pad))
    return x[0].permute(1, 2, 3, 0).contiguous()


def make_gradient_smooth_kernel_3d(sigma: float = 0.0) -> np.ndarray:
    """3x3x3 binomial smoothing kernel used for smooth-gradient TV."""
    kernel = np.asarray(
        [
            [[1, 2, 1], [2, 4, 2], [1, 2, 1]],
            [[2, 4, 2], [4, 8, 4], [2, 4, 2]],
            [[1, 2, 1], [2, 4, 2], [1, 2, 1]],
        ],
        dtype=np.float64,
    )
    dist = np.zeros((3, 3, 3))
    for i in range(3):
        for j in range(3):
            for k in range(3):
                dist[i, j, k] = (i - 1) ** 2 + (j - 1) ** 2 + (k - 1) ** 2 - 1
    k0 = kernel * np.exp(-dist * sigma)
    return (k0 / k0.sum()).astype(np.float32)


def _separate_kernel_3d(kernel: np.ndarray):
    """Best rank-1 factorization k3 ~= kx (x) ky (x) kz via two SVDs;
    returns (kx, ky, kz) or None when the kernel isn't separable."""
    k = kernel.shape[0]
    u, s, vt = np.linalg.svd(kernel.reshape(k, k * k), full_matrices=False)
    kx = u[:, 0] * s[0]
    u2, s2, vt2 = np.linalg.svd(vt[0].reshape(k, k), full_matrices=False)
    ky = u2[:, 0] * s2[0]
    kz = vt2[0]
    approx = kx[:, None, None] * ky[None, :, None] * kz[None, None, :]
    if not np.allclose(approx, kernel, rtol=1e-5,
                       atol=1e-7 * np.abs(kernel).max()):
        return None
    if kx.sum() < 0:
        kx, ky = -kx, -ky
    if kz.sum() < 0:
        kz, ky = -kz, -ky
    return kx, ky, kz


def _edge_pad(x: torch.Tensor, axis: int, p: int) -> torch.Tensor:
    n = x.shape[axis]
    first, last = x.narrow(axis, 0, 1), x.narrow(axis, n - 1, 1)
    return torch.cat([first] * p + [x] + [last] * p, dim=axis)


def _conv_axis_replicate(grid, k1d, axis: int):
    """1-D correlation along ``axis`` with replicate padding, as k scaled
    shifted slices."""
    k = len(k1d)
    n = grid.shape[axis]
    xp = _edge_pad(grid, axis, k // 2)
    out = None
    for d in range(k):
        term = float(np.float32(k1d[d])) * xp.narrow(axis, d, n)
        out = term if out is None else out + term
    return out


def conv3d_replicate(grid: torch.Tensor, kernel) -> torch.Tensor:
    """Depthwise 3-D convolution with replicate padding on ``[X,Y,Z,C]``,
    each channel with the same ``[k,k,k]`` kernel, in full f32 as shifted
    adds (three axis passes when the kernel is separable). No cuDNN."""
    kern = np.asarray(kernel, np.float32)
    k = kern.shape[0]
    sep = _separate_kernel_3d(kern)
    if sep is not None:
        out = grid
        for axis, k1 in enumerate(sep):
            out = _conv_axis_replicate(out, k1, axis)
        return out
    p = k // 2
    xp = grid
    for axis in range(3):
        xp = _edge_pad(xp, axis, p)
    X, Y, Z = grid.shape[:3]
    out = None
    for i in range(k):
        for j in range(k):
            for l in range(k):
                w = float(kern[i, j, l])
                if w == 0.0:
                    continue
                term = w * xp[i:i + X, j:j + Y, l:l + Z]
                out = term if out is None else out + term
    return out
