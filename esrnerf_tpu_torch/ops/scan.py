"""Masked transmittance scan (alpha -> weights) with its reverse-scan
backward, as one ``torch.autograd.Function``.

Port of ``esrnerf_tpu/ops/scan.py``. On a CUDA tensor the forward runs
kernel K-1 and the backward kernel K-2 (``csrc/scan.cu``); on a CPU tensor
both run the plain versions below, which mirror the reference's vectorized
``_fwd_jnp`` / ``_bwd_jnp``. Everything takes the march's ``[N, S]``
layout (rays x samples); no launch is wrapped in a transposing copy.

Semantics: a sample is live iff the transmittance entering it is
``>= early_exit``; the sample that drives T below the threshold still gets
weight; later samples get 0 and ``alphainv_last`` freezes. The early-exit
mask is a constant region of the backward, which uses the CUDA reference's
division form ``grad_i = T_in*ct_i - (sum_{j>i} w_j ct_j)/max(1-alpha_i,
1e-10)``. At alpha == 1 exactly this differs from autograd through a
cumprod (which recovers the nonzero limit); the kernel and the plain
version both keep the division form.
"""

from __future__ import annotations

from typing import Tuple

import torch

from esrnerf_tpu_torch.ops import kernels
from esrnerf_tpu_torch.ops.render import EARLY_EXIT_T


def _fwd_plain(alpha: torch.Tensor, ee: float):
    """Plain version of K-1 on ``alpha [N, S]``: ``(w, t_in [N, S],
    last [N])``.

    Works in ``[S, N]`` inside, so that the cumprod runs over the outer
    dimension: on the card it takes each ray's products in sample order in
    float, as the kernel does (PyTorch's CPU cumprod carries them in
    double). T follows the plain exclusive cumprod until it first enters a
    sample below ``ee``; from that sample on ``a_eff`` is zero, so T (and
    every later ``T_in``) freezes at that entry value.
    """
    alpha_sn = alpha.t().contiguous()
    S, N = alpha_sn.shape
    c = torch.cumprod(1.0 - alpha_sn, dim=0)
    tin_raw = torch.cat([torch.ones_like(alpha_sn[:1]), c[:-1]], 0)
    raw_dead = tin_raw < ee
    any_dead = raw_dead.any(dim=0)
    first = torch.argmax(raw_dead.to(torch.int8), dim=0)
    steps = torch.arange(S, device=alpha_sn.device)
    dead = any_dead[None, :] & (steps[:, None] >= first[None, :])
    frozen = torch.gather(tin_raw, 0, first[None, :])
    tin = torch.where(dead, frozen, tin_raw)
    a_eff = torch.where(dead, torch.zeros_like(alpha_sn), alpha_sn)
    w = a_eff * tin
    last = tin[-1] * (1.0 - a_eff[-1])
    return w.t().contiguous(), tin.t().contiguous(), last


def _bwd_plain(alpha, tin, ctw, ct_last, ee: float):
    """Plain version of K-2 (division-form gradient) on ``[N, S]``
    inputs and ``ct_last [N]``: ``d_alpha [N, S]``. Works in ``[S, N]``
    inside, as :func:`_fwd_plain` does."""
    alpha_sn, tin_sn, ctw_sn = (x.t().contiguous() for x in (alpha, tin, ctw))
    live = tin_sn >= ee
    a_eff = torch.where(live, alpha_sn, torch.zeros_like(alpha_sn))
    w = a_eff * tin_sn
    last = tin_sn[-1] * (1.0 - a_eff[-1])
    p = w * ctw_sn
    rev = torch.flip(p, [0])
    tail = torch.flip(torch.cumsum(rev, 0) - rev, [0])  # sum_{j>s} w_j ct_j
    A = tail + (last * ct_last)[None, :]
    grad = tin_sn * ctw_sn - A / torch.clamp(1.0 - a_eff, min=1e-10)
    return torch.where(live, grad, torch.zeros_like(grad)).t().contiguous()


def scan_forward(alpha: torch.Tensor, early_exit: float):
    """K-1 on a CUDA tensor, else the plain version; ``alpha [N, S]``."""
    if alpha.is_cuda:
        return kernels.scan_fwd(alpha, early_exit)
    return _fwd_plain(alpha, early_exit)


def scan_backward(alpha, tin, ctw, ct_last, early_exit: float):
    """K-2 on CUDA tensors, else the plain version; ``[N, S]`` inputs."""
    if alpha.is_cuda:
        return kernels.scan_bwd(alpha, tin, ctw, ct_last, early_exit)
    return _bwd_plain(alpha, tin, ctw, ct_last, early_exit)


class _Alpha2WeightsScan(torch.autograd.Function):
    @staticmethod
    def forward(ctx, alpha, early_exit):
        a = alpha.detach()  # [N, S], as the march holds it
        w, tin, last = scan_forward(a, early_exit)
        ctx.save_for_backward(a, tin)
        ctx.early_exit = early_exit
        return w, last

    @staticmethod
    def backward(ctx, ct_w, ct_last):
        a, tin = ctx.saved_tensors
        # the march stacks w with other columns, whose backward hands a
        # strided ct_w
        ctw = torch.zeros_like(a) if ct_w is None else ct_w.contiguous()
        ctl = (a.new_zeros((a.shape[0],)) if ct_last is None
               else ct_last.contiguous())
        return scan_backward(a, tin, ctw, ctl, ctx.early_exit), None


def alpha2weights_scan(
    alpha: torch.Tensor, early_exit: float = EARLY_EXIT_T
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Masked transmittance scan on a dense ``[N, S]`` alpha grid (invalid
    samples already zeroed). Returns ``(weights [N, S], alphainv_last
    [N])``. Equals :func:`esrnerf_tpu_torch.ops.render.alpha2weights`."""
    return _Alpha2WeightsScan.apply(alpha, float(early_exit))
