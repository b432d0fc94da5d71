"""Sorted-stream scatter-add ("splat", K-3), chunk-major corner gather
(K-4), and the autograd pieces built on them.

Port of ``esrnerf_tpu/ops/splat.py``. The backward of every trainable-grid
read, the march's dense-bridge scatter and the adjoint of its compaction
gathers go through :func:`sorted_streams_splat`; the color-grid reads and
the displaced SDF taps go through :func:`sorted_corner_gather`. On a CUDA
tensor each launches its kernel (``csrc/splat.cu``, ``csrc/gather.cu``);
on a CPU tensor it runs the plain version beside it.

What carries over from the TPU design is the contract, not the algorithm:
rows out of range are dropped, rows ``>= n_valid`` (the march's pad tail)
are skipped, and the gather returns zeros for whole 2048-row chunks at or
after ``n_valid``. The one-hot MXU matmuls, bf16 hi+lo splits, VMEM pieces
and the fold/shear tables of ``trilinear_splat`` are TPU devices: here the
eight trilinear corners are eight streams of C channels, and the displaced
taps are 4W single-channel streams per axis, all added with atomics — so
the splat needs no sort, and "sorted" in the names only promises locality.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from esrnerf_tpu_torch.ops import grid as gridops
from esrnerf_tpu_torch.ops import kernels

# pad-skip chunk of the gather: rows of a 2048-row chunk that starts at or
# after n_valid read as zeros (csrc/gather.cu kChunk)
GATHER_CHUNK = 2048


# --------------------------------------------------------------------- K-3


def _splat_plain(base, vals, offsets, out, n_valid=None):
    """Plain version of K-3: ``index_add_`` per stream."""
    S, C, M = vals.shape
    n_cells = out.shape[0]
    base = base.long()
    keep = (None if n_valid is None
            else torch.arange(M, device=base.device) < n_valid)
    for s in range(S):
        idx = base + int(offsets[s])
        ok = (idx >= 0) & (idx < n_cells)
        if keep is not None:
            ok = ok & keep
        v = torch.where(ok[None, :], vals[s], torch.zeros_like(vals[s]))
        out.index_add_(0, torch.clamp(idx, 0, n_cells - 1), v.t())
    return out


def sorted_streams_splat(
    base: torch.Tensor,
    vals: torch.Tensor,
    offsets: Sequence[int],
    n_cells: int,
    n_valid=None,
    out: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Scatter-add of S update streams into an f32 ``[n_cells, C]`` table.

    base: ``[M]`` int; vals: ``[S, C, M]`` f32. Stream s's update k adds
    ``vals[s, :, k]`` to row ``base[k] + offsets[s]``; rows outside
    ``[0, n_cells)`` are dropped and updates ``k >= n_valid`` (a device
    scalar, or None) are skipped. Ascending ``base`` is not required; it
    gives the kernel's atomics locality. ``out`` (pre-zeroed, or None for a
    new zero table) is accumulated into and returned.
    """
    S, C, M = vals.shape
    if len(offsets) != S:
        raise ValueError(f"{len(offsets)} offsets for {S} streams")
    if out is None:
        out = torch.zeros((n_cells, C), dtype=torch.float32,
                          device=vals.device)
    elif out.shape != (n_cells, C):
        raise ValueError(f"out is {tuple(out.shape)}, want {(n_cells, C)}")
    if vals.is_cuda:
        return kernels.splat(base.to(torch.int32).contiguous(),
                             vals.to(torch.float32).contiguous(), offsets,
                             out, n_valid)
    return _splat_plain(base, vals.to(torch.float32), offsets, out, n_valid)


class _SortedScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, idx, x, size, n_valid):
        ctx.save_for_backward(idx)
        return sorted_streams_splat(idx, x.reshape(1, 1, -1), (0,), size,
                                    n_valid)[:, 0]

    @staticmethod
    def backward(ctx, ct):
        # unique indices => the adjoint is a plain gather
        (idx,) = ctx.saved_tensors
        return None, ct.index_select(0, idx.long()), None, None


def sorted_scatter_1d(idx: torch.Tensor, x: torch.Tensor, size: int,
                      n_valid=None) -> torch.Tensor:
    """Scatter ``x [M]`` into a zero ``[size]`` array at unique indices
    (the march's dense-bridge scatter). Rows ``>= n_valid`` must target
    droppable cells; they are skipped. Bool ``x`` gives a bool result."""
    if x.dtype == torch.bool:
        with torch.no_grad():
            out = sorted_streams_splat(
                idx, x.to(torch.float32).reshape(1, 1, -1), (0,), size,
                n_valid)[:, 0]
        return out > 0.5
    return _SortedScatter.apply(idx, x.to(torch.float32), size,
                                n_valid).to(x.dtype)


class _SortedGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, idx, n_valid):
        ctx.save_for_backward(idx)
        ctx.n_rows = table.shape[0]
        ctx.n_valid = n_valid
        return table.index_select(0, idx.long())

    @staticmethod
    def backward(ctx, ct):
        (idx,) = ctx.saved_tensors
        vals = ct.to(torch.float32).t().contiguous()[None]  # [1, C, M]
        dtable = sorted_streams_splat(idx, vals, (0,), ctx.n_rows,
                                      ctx.n_valid)
        return dtable.to(ct.dtype), None, None


def sorted_gather_rows(table: torch.Tensor, idx: torch.Tensor,
                       n_valid=None) -> torch.Tensor:
    """``table[idx]`` whose adjoint is the splat kernel. ``idx`` must be in
    range; rows ``>= n_valid`` carry zero cotangents and are skipped in the
    adjoint."""
    return _SortedGatherRows.apply(table, idx, n_valid)


class _PermuteRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, perm, inv_perm):
        ctx.save_for_backward(inv_perm)
        return x.index_select(0, perm)

    @staticmethod
    def backward(ctx, ct):
        (inv_perm,) = ctx.saved_tensors
        return ct.index_select(0, inv_perm), None, None


def permute_rows(x, perm, inv_perm):
    """``x[perm]`` for a bijective ``perm``; the adjoint is the inverse
    gather, not a scatter."""
    return _PermuteRows.apply(x, perm, inv_perm)


# --------------------------------------------------------------------- K-4


def _gather_plain(table, base, weights, offsets, raw, n_valid):
    """Plain version of K-4 (clipped row gathers)."""
    R, C = table.shape
    M = base.shape[0]
    base = base.long()
    rows = [table.index_select(0, torch.clamp(base + int(o), 0, R - 1))
            for o in offsets]
    if raw:
        out = torch.stack([r[:, 0] for r in rows], -1)
    else:
        out = torch.zeros((M, C), dtype=torch.float32, device=table.device)
        for d, r in enumerate(rows):
            out = out + weights[:, d:d + 1] * r
    if n_valid is not None:
        row_chunk = (torch.arange(M, device=table.device) // GATHER_CHUNK
                     ) * GATHER_CHUNK
        out = torch.where(row_chunk[:, None] >= n_valid,
                          torch.zeros_like(out), out)
    return out


def sorted_corner_gather(
    table: torch.Tensor,
    base: torch.Tensor,
    weights: Optional[torch.Tensor],
    offsets: Sequence[int],
    raw: bool = False,
    n_valid=None,
) -> torch.Tensor:
    """``out[m] = sum_d weights[m, d] * table[base[m] + offsets[d]]`` for an
    f32 ``[R, C]`` table, or with ``raw=True`` (C=1, no weights) the
    per-offset values ``out[m, d]``. Indices are clipped into the table
    (out-of-range corners carry zero weight). Rows of 2048-row chunks that
    start at or after ``n_valid`` are zeros. Not differentiable itself."""
    if raw:
        if table.shape[1] != 1 or weights is not None:
            raise ValueError("raw gather takes a [R, 1] table and no weights")
    elif weights is None or weights.shape[1] != len(offsets):
        raise ValueError("weighted gather needs weights [M, len(offsets)]")
    if table.is_cuda:
        t = table.detach().to(torch.float32).contiguous()
        b = base.to(torch.int32).contiguous()
        if raw:
            return kernels.gather_raw(t, b, offsets, n_valid)
        return kernels.gather_weighted(
            t, b, weights.detach().to(torch.float32).contiguous(), offsets,
            n_valid)
    return _gather_plain(table.detach(), base, None if raw
                         else weights.detach(), offsets, raw, n_valid)


# ------------------------------------------------- trilinear sample / splat


def _sorted_trilinear_sample_impl(grid, pts, xyz_min, xyz_max, n_valid=None):
    X, Y, Z, C = grid.shape
    base, wts = gridops.corner_base_weights((X, Y, Z), pts, xyz_min, xyz_max)
    offs = gridops.corner_offsets_dmajor(Y, Z)
    return sorted_corner_gather(grid.reshape(-1, C), base, wts, offs,
                                n_valid=n_valid)


class _SortedTrilinearSampleMulti(torch.autograd.Function):
    @staticmethod
    def forward(ctx, pts, xyz_min, xyz_max, n_valid, *grids):
        widths = [g.shape[-1] for g in grids]
        cat = grids[0] if len(grids) == 1 else torch.cat(grids, -1)
        out = _sorted_trilinear_sample_impl(cat, pts, xyz_min, xyz_max,
                                            n_valid)
        ctx.save_for_backward(pts, xyz_min, xyz_max)
        ctx.shapes = [tuple(g.shape) for g in grids]
        ctx.n_valid = n_valid
        if len(grids) == 1:
            return out
        return tuple(o.contiguous() for o in torch.split(out, widths, -1))

    @staticmethod
    def backward(ctx, *cts):
        pts, xyz_min, xyz_max = ctx.saved_tensors
        dgrids = [
            None if ct is None else trilinear_splat(
                shape, pts, ct, xyz_min, xyz_max, n_valid=ctx.n_valid)
            for shape, ct in zip(ctx.shapes, cts)
        ]
        return (None, None, None, None, *dgrids)


def sorted_trilinear_sample_multi(grids, pts, xyz_min, xyz_max,
                                  n_valid=None) -> Tuple[torch.Tensor, ...]:
    """Zeros-mode trilinear sample of several same-resolution ``[X,Y,Z,C_i]``
    grids at cell-sorted points through one gather (K-4); the backward
    splats each grid's cotangent (K-3). Rows ``>= n_valid`` of whole pad
    chunks read zeros. Returns a tuple of ``[M, C_i]``."""
    grids = tuple(grids)
    out = _SortedTrilinearSampleMulti.apply(pts, xyz_min, xyz_max, n_valid,
                                            *grids)
    return (out,) if len(grids) == 1 else out


def sorted_trilinear_sample(grid, pts, xyz_min, xyz_max, n_valid=None):
    """Single-grid :func:`sorted_trilinear_sample_multi`."""
    return sorted_trilinear_sample_multi((grid,), pts, xyz_min, xyz_max,
                                         n_valid)[0]


def trilinear_splat(
    grid_shape: Sequence[int],
    pts: torch.Tensor,
    ct: torch.Tensor,
    xyz_min: torch.Tensor,
    xyz_max: torch.Tensor,
    n_valid=None,
) -> torch.Tensor:
    """Adjoint of zeros-mode trilinear sampling: splat ``ct [M, C]`` at
    ``pts [M, 3]`` into a zero ``[X,Y,Z,C]`` grid, as 8 corner streams of C
    channels (K-3). Equals ``grid_sample_3d_impl``'s grid gradient. Rows
    ``>= n_valid`` (zero cotangents of a pad tail) are skipped."""
    X, Y, Z, C = grid_shape
    base, wts = gridops.corner_base_weights((X, Y, Z), pts, xyz_min, xyz_max)
    ct = ct.reshape(-1, C).to(torch.float32)
    vals = wts.t()[:, None, :] * ct.t()[None, :, :]  # [8, C, M]
    out = sorted_streams_splat(base, vals, gridops.corner_offsets_dmajor(Y, Z),
                               X * Y * Z, n_valid)
    return out.reshape(X, Y, Z, C)


def displaced_taps_splat(
    grid_shape: Sequence[int],
    pts: torch.Tensor,
    ct: torch.Tensor,
    xyz_min: torch.Tensor,
    xyz_max: torch.Tensor,
    displace: Tuple[float, ...],
    n_valid=None,
) -> torch.Tensor:
    """Adjoint of :func:`esrnerf_tpu_torch.ops.grid.displaced_taps`: splat
    the ``[M, 6, D]`` tap cotangents into a zero ``[X,Y,Z,1]`` grid. Per
    axis, the window-slot cotangents become 4W single-channel streams (2x2
    cross-axis corners x W window slots) of one K-3 launch."""
    X, Y, Z = grid_shape[:3]
    n_cells = X * Y * Z
    strides = (Y * Z, Z, 1)
    per_axis = gridops._window_geometry((X, Y, Z), pts, xyz_min, xyz_max,
                                        displace)
    dflat = torch.zeros((n_cells, 1), dtype=torch.float32, device=pts.device)
    # ct layout: axis order z, y, x (pairs -, +), as displaced_taps returns
    for k, g in enumerate((per_axis[2], per_axis[1], per_axis[0])):
        W = g["W"]
        sa, sb, sc = strides[g["a"]], strides[g["b"]], strides[g["c"]]
        ct_a = ct[:, 2 * k:2 * k + 2, :].to(torch.float32)  # [M, 2, D]
        slot = torch.einsum("msd,msdw->mw", ct_a, gridops._slot_weights(g))
        base = g["i0b"] * sb + g["i0c"] * sc + g["w0"] * sa
        vals, offs = [], []
        for db in (0, 1):
            wb = g["fb"] if db else 1 - g["fb"]
            for dc in (0, 1):
                wc = g["fc"] if dc else 1 - g["fc"]
                wbc = wb * wc
                for jj in range(W):
                    vals.append(slot[:, jj] * wbc)
                    offs.append(db * sb + dc * sc + jj * sa)
        sorted_streams_splat(base, torch.stack(vals, 0)[:, None, :], offs,
                             n_cells, n_valid, out=dflat)
    return dflat.reshape(X, Y, Z, 1)


def splat_oracle(base, vals, offsets, n_cells):
    """Numpy oracle for tests."""
    S, C, M = vals.shape
    out = np.zeros((n_cells, C), np.float64)
    for s in range(S):
        idx = np.asarray(base) + offsets[s]
        ok = (idx >= 0) & (idx < n_cells)
        np.add.at(out, idx[ok], np.asarray(vals)[s, :, ok])
    return out.astype(np.float32)
