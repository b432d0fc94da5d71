"""Adam with per-group learning rates and per-voxel LR scaling.

Port of ``esrnerf_tpu/optim/adam.py``. Parameters live in a dict whose
top-level keys are the param groups; a group's value is a tensor or a dict
of tensors (an MLP head). Groups with ``lr <= 0`` are frozen: no state, no
update. ``per_lr`` scales the first-moment numerator elementwise for
shape-matching parameters. Betas default to (0.9, 0.99).

Unlike the functional reference, :meth:`Adam.step` updates parameters and
moments in place (under ``torch.no_grad``): at 16.7M voxels the grids and
their moments are 2.4 GB, and in-place updates avoid a second copy of each.
It returns the same objects for the caller's convenience.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch

Params = Dict[str, Any]


class AdamState(NamedTuple):
    step: Dict[str, torch.Tensor]  # per-group int32 scalar step count
    mu: Params
    nu: Params


def tree_map(fn, *trees):
    """Map ``fn`` over matching leaves of tensors or dicts of tensors."""
    if isinstance(trees[0], dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in trees[0]}
    return fn(*trees)


class Adam:
    def __init__(self, lrs: Dict[str, float],
                 betas: Tuple[float, float] = (0.9, 0.99), eps: float = 1e-8):
        self.lrs = {k: float(v) for k, v in lrs.items()}
        self.betas = betas
        self.eps = eps

    def trainable(self, group: str) -> bool:
        return self.lrs.get(group, 0.0) > 0.0

    def init(self, params: Params) -> AdamState:
        zeros = lambda t: tree_map(torch.zeros_like, t)
        mu = {g: zeros(p) for g, p in params.items() if self.trainable(g)}
        nu = {g: zeros(p) for g, p in params.items() if self.trainable(g)}
        step = {}
        for g in mu:
            leaf = params[g]
            while isinstance(leaf, dict):
                leaf = next(iter(leaf.values()))
            step[g] = torch.zeros((), dtype=torch.int32, device=leaf.device)
        return AdamState(step, mu, nu)

    @torch.no_grad()
    def step(
        self,
        params: Params,
        grads: Params,
        state: AdamState,
        lr_scales: Optional[Dict[str, Any]] = None,
        per_lr: Optional[Params] = None,
    ) -> Tuple[Params, AdamState]:
        """One in-place update. ``lr_scales``: group -> multiplicative factor
        on the base LR; ``per_lr``: group -> elementwise LR tensor."""
        b1, b2 = self.betas
        for g in params:
            if not self.trainable(g):
                continue
            state.step[g].add_(1)
            t = state.step[g].to(torch.float32)
            bc1 = 1.0 - torch.pow(b1, t)
            sqrt_bc2 = torch.sqrt(1.0 - torch.pow(b2, t))
            lr = self.lrs[g]
            if lr_scales is not None and g in lr_scales:
                lr = lr * lr_scales[g]
            step_size = lr / bc1
            plr = per_lr.get(g) if per_lr is not None else None

            def upd(p, gr, m, v):
                m.mul_(b1).add_(gr, alpha=1 - b1)
                v.mul_(b2).addcmul_(gr, gr, value=1 - b2)
                denom = torch.sqrt(v) / sqrt_bc2 + self.eps
                # per-voxel LR only applies to shape-matching params
                num = m * plr if plr is not None and plr.shape == p.shape else m
                p.sub_(step_size * num / denom)

            tree_map(upd, params[g], grads[g], state.mu[g], state.nu[g])
        return params, state



def make_pervoxel_lr(count: torch.Tensor) -> torch.Tensor:
    """Per-voxel LR ``count / count.max()`` (f32) from a view count."""
    c = count.to(torch.float32)
    return c / c.max()
