"""Transmittance scans and NeuS alpha on dense ``[N, S]`` layouts.

Port of the parts of ``esrnerf_tpu/ops/render.py`` that the ported stages
use: the dense masked ``alpha2weights`` (the semantics the scan kernel must
equal), the interp-variant NeuS alpha with ragged neighbour pairing, and
DVGO's cumulative-product weights.
"""

from __future__ import annotations

from typing import Tuple

import torch

EARLY_EXIT_T = 1e-3  # stop marching once transmittance < 1e-3


def exclusive_cumprod(p: torch.Tensor) -> torch.Tensor:
    """``[1, p0, p0*p1, ...]`` along the last axis (same length)."""
    cp = torch.cumprod(p, dim=-1)
    return torch.cat([torch.ones_like(cp[..., :1]), cp[..., :-1]], dim=-1)


def ray_marching_weights_dvgo(
        alpha: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """DVGO's weights on ``alpha [N, S]``: ``alphainv_cum = [1,
    cumprod(clamp(1 - alpha, 1e-10))]`` (S + 1 long) and ``weights = alpha
    * alphainv_cum[..., :-1]``. Autograd gives the gradient."""
    cum = torch.cumprod(torch.clamp(1.0 - alpha, min=1e-10), dim=-1)
    alphainv_cum = torch.cat([torch.ones_like(alpha[..., :1]), cum], dim=-1)
    return alpha * alphainv_cum[..., :-1], alphainv_cum


def alpha2weights(
    alpha: torch.Tensor,
    mask: torch.Tensor | None = None,
    early_exit: float | None = EARLY_EXIT_T,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dense masked transmittance scan. ``alpha, mask: [N, S]``; returns
    ``(weights [N, S], alphainv_last [N])``.

    A sample is processed iff the transmittance entering it is
    ``>= early_exit``; the first sample that drives T below it still gets
    weight, later samples get 0 and ``alphainv_last`` freezes. The exit mask
    carries no gradient.
    """
    zero = torch.zeros_like(alpha)
    if mask is not None:
        alpha = torch.where(mask, alpha, zero)
    if early_exit is not None:
        live = exclusive_cumprod(1.0 - alpha).detach() >= early_exit
        alpha = torch.where(live, alpha, zero)
    T_in = exclusive_cumprod(1.0 - alpha)
    weights = alpha * T_in
    alphainv_last = T_in[..., -1] * (1.0 - alpha[..., -1])
    return weights, alphainv_last


def _fill_next_valid(x: torch.Tensor, mask: torch.Tensor):
    """For each position s, the value of ``x`` at the next valid position
    t > s along the last axis; positions with no later valid neighbour keep
    their own value. Returns ``(values, has_next)``.

    The reference runs a reverse ``lax.scan``; here the next valid index is
    a reversed running minimum of the valid positions, then one gather —
    the same values, with no arithmetic on them.
    """
    S = x.shape[-1]
    pos = torch.arange(S, device=x.device).expand(x.shape)
    idx = torch.where(mask, pos, torch.full_like(pos, S))
    after = torch.cat([idx[..., 1:], torch.full_like(idx[..., :1], S)], -1)
    nxt = torch.flip(torch.cummin(torch.flip(after, [-1]), dim=-1).values,
                     [-1])
    ok = nxt < S
    vals = torch.gather(x, -1, torch.clamp(nxt, max=S - 1))
    return torch.where(ok, vals, x), ok


def neus_alpha_interp(
    sdf: torch.Tensor, mask: torch.Tensor, s_val
) -> torch.Tensor:
    """Interp-variant NeuS alpha on ``[N, S]``: each valid sample estimates
    its section from the midpoint with the *next valid* sample of the ray
    (holes skipped), and likewise on the previous side; a sample without a
    neighbour pairs with itself. Returns alpha ``[N, S]``, 0 at invalid
    samples."""
    nxt, has_next = _fill_next_valid(sdf, mask)
    prv_rev, has_prev_rev = _fill_next_valid(
        torch.flip(sdf, [-1]), torch.flip(mask, [-1])
    )
    prv = torch.flip(prv_rev, [-1])
    has_prev = torch.flip(has_prev_rev, [-1])

    est_next = torch.where(has_next, 0.5 * (sdf + nxt), sdf)
    est_prev = torch.where(has_prev, 0.5 * (sdf + prv), sdf)

    prev_cdf = torch.sigmoid(est_prev * s_val)
    next_cdf = torch.sigmoid(est_next * s_val)
    p = torch.relu(prev_cdf - next_cdf)
    alpha = torch.clamp((p + 1e-5) / (prev_cdf + 1e-5), 0.0, 1.0)
    return torch.where(mask, alpha, torch.zeros_like(alpha))
