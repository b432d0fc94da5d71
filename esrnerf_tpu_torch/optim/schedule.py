"""Learning-rate schedules (host-side float math, fed to the train step as
plain floats). Port of ``esrnerf_tpu/optim/schedule.py``.

The exponential decay :func:`exp_decay_factor` (alphamask, coarse) is a
per-step multiplicative factor; the warm-up + cosine ``CosineLR`` (fine)
returns a per-step multiplicative ``decay_factor`` (reference
``app/utils/optimizer.py:231-275``).
"""

from __future__ import annotations

import math


def exp_decay_factor(lr_decay: float) -> float:
    """Per-step factor that reaches 0.1x every ``lr_decay * 1000`` steps."""
    return 0.1 ** (1.0 / (lr_decay * 1000.0))


class CosineLR:
    """Warm-up (linear or constant) then cosine decay.

    Stateful like the reference: each read of :attr:`decay_factor` advances
    ``cur_step`` and returns the *ratio* of consecutive absolute factors, so
    it can be applied multiplicatively to a running LR scale.
    """

    def __init__(
        self,
        n_iters: int,
        warm_up_iters: int,
        warm_up_min_ratio: float,
        const_warm_up: bool,
        cos_min_ratio: float,
        cur_step: int = 0,
    ):
        self.n_iters = n_iters
        self.warm_up_iters = n_iters if warm_up_iters == -1 else warm_up_iters
        self.warm_up_min_ratio = warm_up_min_ratio
        self.const_warm_up = const_warm_up
        self.cos_min_ratio = cos_min_ratio
        self.cur_step = cur_step
        self.pre_decay_factor = 1.0 if cur_step == 0 else self(cur_step - 1)
        self.pos_decay_factor = self(cur_step)

    @classmethod
    def from_cfg(cls, cfg, cur_step: int = 0) -> "CosineLR":
        tr = cfg.app.trainer
        return cls(
            n_iters=tr["n_iters"],
            warm_up_iters=tr["warm_up_iters"],
            warm_up_min_ratio=tr["warm_up_min_ratio"],
            const_warm_up=tr["const_warm_up"],
            cos_min_ratio=tr["cos_min_ratio"],
            cur_step=cur_step,
        )

    def __call__(self, it: int) -> float:
        if it < self.warm_up_iters:
            if not self.const_warm_up:
                return self.warm_up_min_ratio + (1 - self.warm_up_min_ratio) * (
                    it / self.warm_up_iters
                )
            return self.warm_up_min_ratio
        return (
            1
            + math.cos(
                (it - self.warm_up_iters)
                / (self.n_iters - self.warm_up_iters)
                * math.pi
            )
        ) * 0.5 * (1 - self.cos_min_ratio) + self.cos_min_ratio

    @property
    def decay_factor(self) -> float:
        pre = self.pre_decay_factor
        pos = self(self.cur_step)
        self.cur_step += 1
        self.pre_decay_factor = pos
        return pos / pre
