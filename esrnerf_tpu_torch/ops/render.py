"""Transmittance scans and NeuS alpha on dense ``[N, S]`` layouts.

Port of ``esrnerf_tpu/ops/render.py``: the dense masked ``alpha2weights``
(the semantics the scan kernel must equal), the interp- and grad-variant
NeuS alphas, DVGO's cumulative-product weights, the flat compacted-list
(segmented) variants, and the dense per-ray ``segment_mean``.
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

    alpha = _neus_alpha(est_prev, est_next, s_val)
    return torch.where(mask, alpha, torch.zeros_like(alpha))


def _neus_alpha(est_prev, est_next, s_val):
    """NeuS section alpha from the section's two endpoint SDF estimates."""
    prev_cdf = torch.sigmoid(est_prev * s_val)
    next_cdf = torch.sigmoid(est_next * s_val)
    p = torch.relu(prev_cdf - next_cdf)
    return torch.clamp((p + 1e-5) / (prev_cdf + 1e-5), 0.0, 1.0)


def neus_alpha_grad(sdf: torch.Tensor, gradients: torch.Tensor,
                    viewdirs: torch.Tensor, dist, mask: torch.Tensor,
                    s_val) -> torch.Tensor:
    """Grad-variant NeuS alpha on ``[N, S]``: the section endpoints are
    ``sdf -/+ (viewdir . gradient) * dist / 2``. ``gradients [N, S, 3]``,
    ``viewdirs [N, 3]`` (broadcast over S) or ``[N, S, 3]``. Returns alpha
    ``[N, S]``, 0 at invalid samples."""
    if viewdirs.dim() == 2:
        viewdirs = viewdirs[:, None, :]
    return neus_alpha_grad_flat(sdf, gradients, viewdirs, dist, mask, s_val)


# Segmented variants on the march's flat compacted list: each entry carries
# its ray (``ray_id``, pads ``n_rays``), and the per-ray scans keep the
# ragged ray_id-continuity semantics of the dense ones.


def alpha2weights_flat(alpha: torch.Tensor, ray_id: torch.Tensor,
                       step_id: torch.Tensor, n_rays: int, n_steps: int,
                       early_exit: float | None = EARLY_EXIT_T):
    """:func:`alpha2weights` on a flat list: the alphas go to their ``(ray,
    step)`` slot of a dense ``[N, S]`` grid (empty slots alpha 0, so
    transmittance factor 1), the scan (K-1 / K-2 on the card) runs there
    and the weights come back. Pads use ``ray_id == n_rays`` with alpha 0.
    Returns ``(weights [K], alphainv_last [N])``; a ray with no entry has
    ``alphainv_last`` 1."""
    from esrnerf_tpu_torch.ops import scan as scanops

    lin = torch.clamp(ray_id, max=n_rays) * n_steps + step_id
    dense = alpha.new_zeros((n_rays + 1) * n_steps).index_put((lin,), alpha)
    ee = -1.0 if early_exit is None else float(early_exit)
    w_dense, alphainv_last = scanops.alpha2weights_scan(
        dense.reshape(n_rays + 1, n_steps)[:n_rays], ee)
    w_flat = torch.cat([w_dense.reshape(-1), w_dense.new_zeros(n_steps)])
    return w_flat[lin], alphainv_last


def neus_alpha_interp_flat(sdf: torch.Tensor, ray_id: torch.Tensor,
                           valid: torch.Tensor, s_val) -> torch.Tensor:
    """:func:`neus_alpha_interp` on a flat list: each valid entry pairs with
    the next and the previous valid entry of the same ray (holes skipped);
    an entry without such a neighbour pairs with itself."""
    K = sdf.shape[0]
    cnt = torch.cumsum(valid.to(torch.int64), 0)
    rank = cnt - 1  # 0-based rank of each valid entry
    vpos = torch.nonzero(valid).reshape(-1)
    vpos = torch.cat([vpos, vpos.new_full((K - vpos.numel(),), K - 1)])
    n_valid = cnt[-1]

    def neighbour(r, in_range):
        pos = vpos[torch.clamp(r, 0, K - 1)]
        return pos, valid & in_range & (ray_id[pos] == ray_id)

    nxt_pos, has_next = neighbour(rank + 1, rank + 1 < n_valid)
    prv_pos, has_prev = neighbour(rank - 1, rank - 1 >= 0)
    est_next = torch.where(has_next, 0.5 * (sdf + sdf[nxt_pos]), sdf)
    est_prev = torch.where(has_prev, 0.5 * (sdf + sdf[prv_pos]), sdf)
    alpha = _neus_alpha(est_prev, est_next, s_val)
    return torch.where(valid, alpha, torch.zeros_like(alpha))


def neus_alpha_grad_flat(sdf: torch.Tensor, gradients: torch.Tensor,
                         viewdirs_per_pt: torch.Tensor, dist,
                         valid: torch.Tensor, s_val) -> torch.Tensor:
    """:func:`neus_alpha_grad` on a flat list (pointwise): ``sdf [K]``,
    ``gradients`` and ``viewdirs_per_pt [K, 3]``."""
    iter_cos = (viewdirs_per_pt * gradients).sum(-1) * dist * 0.5
    alpha = _neus_alpha(sdf - iter_cos, sdf + iter_cos, s_val)
    return torch.where(valid, alpha, torch.zeros_like(alpha))


def segment_mean(values: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """Weighted per-ray sum over the sample axis of the dense layout:
    ``values [N, S, C]`` or ``[N, S]``, ``weights [N, S]``."""
    if values.dim() == weights.dim() + 1:
        weights = weights[..., None]
    return (weights * values).sum(dim=-2 if values.dim() == 3 else -1)
