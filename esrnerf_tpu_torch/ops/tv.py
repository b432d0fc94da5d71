"""Total-variation regularisers on dense ``[X, Y, Z, C]`` grids.

Port of ``esrnerf_tpu/ops/tv.py``. :func:`total_variation` is the coarse
stage's loss term (masked mean absolute first difference; autograd gives
its gradient). :func:`tv_grad` is the fine stage's: the reference applies
TV as an in-place gradient op after backward; here it is a gradient term
added to the parameter gradient, with the same clamped-diff / 6 semantics
and sparse mode.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _pad_axis(x: torch.Tensor, axis: int, lo: int, hi: int) -> torch.Tensor:
    """Zero-pad ``x`` by ``lo``/``hi`` along ``axis``."""
    spec = [0, 0] * (x.ndim - 1 - axis) + [lo, hi]
    return F.pad(x, spec)


def total_variation(v: torch.Tensor,
                    mask: torch.Tensor | None = None) -> torch.Tensor:
    """Mean ``|first difference|`` along x, y and z, averaged over the
    axes. With ``mask [X, Y, Z]`` (bool) a difference counts only where
    both voxels are in the mask; each axis's mean divides by its count of
    such entries (at least 1)."""
    def abs_(x):
        # |x| whose gradient at 0 is +1, as the reference's: the coarse
        # stage's colour grids start at zero, where torch.abs's is 0
        return torch.where(x >= 0, x, -x)

    diffs = [abs_(torch.diff(v, dim=a)) for a in range(3)]
    if mask is None:
        return (diffs[0].mean() + diffs[1].mean() + diffs[2].mean()) / 3.0
    out = 0.0
    for a, d in enumerate(diffs):
        n = mask.shape[a]
        mm = (mask.narrow(a, 1, n - 1) & mask.narrow(a, 0, n - 1))[..., None]
        mm = mm.expand(d.shape)
        denom = torch.clamp(mm.sum(), min=1)
        out = out + torch.where(mm, d, torch.zeros_like(d)).sum() / denom
    return out / 3.0


def tv_grad(
    grid: torch.Tensor,
    wx: float,
    wy: float,
    wz: float,
    sparse_grad: torch.Tensor | None = None,
    nonempty_mask: torch.Tensor | None = None,
    x_rows: tuple | None = None,
) -> torch.Tensor:
    """Per voxel ``w/6 * sum_axes(clamp(v - neighbour, -1, 1))`` over the up
    to 6 neighbours, per-axis weights ``wx, wy, wz``.

    ``sparse_grad``: voxels whose existing gradient is exactly 0 get no TV
    gradient. ``nonempty_mask``: a voxel pair's diff counts only if both
    voxels are nonempty. ``x_rows``: ``(lo, hi)``, the gradient of the
    X-rows ``grid[lo:hi]`` only (their neighbours read from the rows
    around them; ``sparse_grad`` of that shape). Returns the TV gradient
    (add it to the gradient).
    """
    m = None
    if nonempty_mask is not None:
        m = nonempty_mask.to(grid.dtype)
        if m.ndim == 3:
            m = m[..., None]
    if x_rows is not None:
        lo, hi = x_rows
        a, b = max(lo - 1, 0), min(hi + 1, grid.shape[0])
        grid = grid[a:b]
        m = None if m is None else m[a:b]

    def axis_terms(axis, w):
        n = grid.shape[axis]
        d = torch.clamp(grid.narrow(axis, 1, n - 1)
                        - grid.narrow(axis, 0, n - 1), -1.0, 1.0)
        if m is not None:
            d = d * (m.narrow(axis, 1, n - 1) * m.narrow(axis, 0, n - 1))
        # voxel i gets +clamp(v_i - v_{i-1}) from its lower side and
        # -clamp(v_{i+1} - v_i) from its upper side
        return (w / 6.0) * (_pad_axis(d, axis, 1, 0) - _pad_axis(d, axis, 0, 1))

    g = axis_terms(0, wx) + axis_terms(1, wy) + axis_terms(2, wz)
    if x_rows is not None:
        g = g[lo - a:hi - a]
    if sparse_grad is not None:
        g = torch.where(sparse_grad == 0, torch.zeros_like(g), g)
    return g
