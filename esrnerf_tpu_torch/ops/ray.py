"""Dense ray engine: bbox intersection and fixed-step dense sampling.

Port of ``esrnerf_tpu/ops/ray.py``: ``ray_aabb``, ``sample_rays_dense``
(the Voxurf march's normalised-direction sampler) and the DVGO sampler
``sample_rays_dvgo`` with its ``max_samples_along_diag`` cap. Rays are
sampled into a dense ``[N, S, 3]`` grid with a validity mask.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch


class RaySamples(NamedTuple):
    """pts [N, S, 3]; valid [N, S] (inside bbox and within the ray's step
    count); t_min, t_max [N]; n_valid [N] per-ray marched count (>= 1)."""

    pts: torch.Tensor
    valid: torch.Tensor
    t_min: torch.Tensor
    t_max: torch.Tensor
    n_valid: torch.Tensor


def ray_norm(rays_d: torch.Tensor) -> torch.Tensor:
    """``|d|`` as ``sqrt(sum(d*d))``, the reference's formula."""
    return torch.sqrt((rays_d * rays_d).sum(-1))


def ray_aabb(
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    xyz_min: torch.Tensor,
    xyz_max: torch.Tensor,
    near: float,
    far: float,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-ray bbox entry/exit distances clamped to ``[near, far]``; zero
    direction components are replaced by 1e-6."""
    vec = torch.where(rays_d == 0, torch.full_like(rays_d, 1e-6), rays_d)
    rate_a = (xyz_max - rays_o) / vec
    rate_b = (xyz_min - rays_o) / vec
    t_min = torch.clamp(torch.minimum(rate_a, rate_b).amax(-1), near, far)
    t_max = torch.clamp(torch.maximum(rate_a, rate_b).amin(-1), near, far)
    return t_min, t_max


def sample_rays_dense(
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    xyz_min: torch.Tensor,
    xyz_max: torch.Tensor,
    near: float,
    far: float,
    stepdist: float,
    n_samples: int,
) -> RaySamples:
    """Points march from the bbox entry along the normalized direction in
    fixed world steps: ``p(s) = (o + d*t_min) + (d/|d|) * stepdist * s``.
    The per-ray count is ``max(ceil((t_max - t_min)*|d|/stepdist), 1)``."""
    t_min, t_max = ray_aabb(rays_o, rays_d, xyz_min, xyz_max, near, far)
    rnorm = ray_norm(rays_d)
    n_valid = torch.clamp(torch.ceil((t_max - t_min) * rnorm / stepdist),
                          min=1.0)

    start = rays_o + rays_d * t_min[..., None]
    dirn = rays_d / rnorm[..., None]
    steps = torch.arange(n_samples, dtype=rays_o.dtype, device=rays_o.device)
    dist = stepdist * steps[None, :]
    pts = start[:, None, :] + dirn[:, None, :] * dist[..., None]

    in_count = steps[None, :] < n_valid[:, None]
    in_bbox = ((pts >= xyz_min) & (pts <= xyz_max)).all(-1)
    return RaySamples(pts, in_count & in_bbox, t_min, t_max, n_valid)


def max_samples_along_diag(xyz_min, xyz_max, voxel_size: float,
                           stepsize: float) -> int:
    """Sample-count cap: enough steps of ``stepsize * voxel_size`` to cross
    the bbox diagonal (a host-side int)."""
    diag = float(np.linalg.norm(np.asarray(xyz_max) - np.asarray(xyz_min)))
    return int(math.ceil(diag / (stepsize * voxel_size))) + 1


def sample_rays_dvgo(
    rays_o: torch.Tensor,
    rays_d: torch.Tensor,
    xyz_min: torch.Tensor,
    xyz_max: torch.Tensor,
    near: float,
    far: float,
    stepsize: float,
    voxel_size: float,
    n_samples: int,
    rand_shift: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """DVGO-style dense sampling in un-normalised parameter space:
    ``interpx = t_min + stepsize * voxel_size * (s + rand_shift) / |d|``,
    ``p = o + d * interpx``. ``rand_shift`` ``[N, 1]`` jitters each ray.

    Returns ``(pts [N, S, 3], mask_out [N, S])`` with True = outside the
    bbox, or on a ray that misses it (``t_max <= t_min``).
    """
    t_min, t_max = ray_aabb(rays_o, rays_d, xyz_min, xyz_max, near, far)
    mask_miss = t_max <= t_min

    rng = torch.arange(n_samples, dtype=rays_o.dtype,
                       device=rays_o.device)[None, :]
    if rand_shift is not None:
        rng = rng + rand_shift
    step = (stepsize * voxel_size) * rng
    interpx = t_min[:, None] + step / ray_norm(rays_d)[:, None]
    pts = rays_o[:, None, :] + rays_d[:, None, :] * interpx[..., None]
    out = mask_miss[:, None] | ((pts < xyz_min) | (pts > xyz_max)).any(-1)
    return pts, out
