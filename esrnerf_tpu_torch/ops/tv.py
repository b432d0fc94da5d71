"""Total-variation gradient on dense ``[X, Y, Z, C]`` grids.

Port of ``esrnerf_tpu/ops/tv.py::tv_grad``: the reference applies TV as an
in-place gradient op after backward; here it is a gradient term added to
the parameter gradient, with the same clamped-diff / 6 semantics and
sparse mode.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _pad_axis(x: torch.Tensor, axis: int, lo: int, hi: int) -> torch.Tensor:
    """Zero-pad ``x`` by ``lo``/``hi`` along ``axis``."""
    spec = [0, 0] * (x.ndim - 1 - axis) + [lo, hi]
    return F.pad(x, spec)


def tv_grad(
    grid: torch.Tensor,
    wx: float,
    wy: float,
    wz: float,
    sparse_grad: torch.Tensor | None = None,
    nonempty_mask: torch.Tensor | None = None,
) -> torch.Tensor:
    """Per voxel ``w/6 * sum_axes(clamp(v - neighbour, -1, 1))`` over the up
    to 6 neighbours, per-axis weights ``wx, wy, wz``.

    ``sparse_grad``: voxels whose existing gradient is exactly 0 get no TV
    gradient. ``nonempty_mask``: a voxel pair's diff counts only if both
    voxels are nonempty. Returns the TV gradient (add it to the gradient).
    """
    m = None
    if nonempty_mask is not None:
        m = nonempty_mask.to(grid.dtype)
        if m.ndim == 3:
            m = m[..., None]

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
    if sparse_grad is not None:
        g = torch.where(sparse_grad == 0, torch.zeros_like(g), g)
    return g
