"""The numbers that decide ``correct``.

Training (the check steps the reference follows, from the same weights and
batches):

- ``loss_gap``: the largest relative gap of a step's sRGB or linear MSE;
- ``grad_gap``: over the leaves, the largest gap between the program's and
  the reference's norm of the first step's gradient (the program's read
  from Adam's first moment after one step), over the reference's norm of
  that leaf or of the median leaf, whichever is larger;
- ``change_gap``: the same of the parameters' change after the check
  steps, over the leaves whose first reference gradient is at least a
  thousandth of the median leaf's (a leaf with none moves by round-off
  alone under Adam).

Rendering (chunks that the window rendered, drawn from the seed):

- ``output_gap``: over the outputs, the largest root-mean-square gap
  between the program's and the reference's values over the reference's
  root mean square.
"""

from __future__ import annotations

import statistics
from typing import Dict, List

import numpy as np
import torch

from benchmark.harness.core import Check

MIN_GRAD_SHARE = 1e-3


def train_readings(ref: dict, start: dict, leaves) -> dict:
    """Norms per leaf of a reference run's first gradient and change;
    ``leaves`` names the leaves of a parameter tree (the reference
    module's)."""
    start = dict(leaves(start))
    return {"losses": ref["losses"],
            "grads": {n: float(torch.linalg.vector_norm(g))
                      for n, g in ref["grads"].items()},
            "change": {n: float(torch.linalg.vector_norm(
                p - start[n].to(p.device)))
                for n, p in ref["params"].items()}}


def _gap(prog: Dict[str, float], ref: Dict[str, float], names) -> float:
    med = statistics.median(ref[n] for n in names)
    return max(abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30)
               for n in names)


def train_numbers(prog: dict, ref: dict) -> Dict[str, float]:
    loss = max(abs(p - r) / max(abs(r), 1e-30)
               for ps, rs in zip(prog["losses"], ref["losses"])
               for p, r in zip(ps, rs))
    names = sorted(ref["grads"])
    med = statistics.median(ref["grads"][n] for n in names)
    moving = [n for n in names if ref["grads"][n] >= MIN_GRAD_SHARE * med]
    return {"loss_gap": loss,
            "grad_gap": _gap(prog["grads"], ref["grads"], names),
            "change_gap": _gap(prog["change"], ref["change"], moving)}


def leaf_gaps(prog: dict, ref: dict) -> List[tuple]:
    """Per leaf: its reference gradient's norm over the median leaf's, the
    gaps of its gradient's and its change's norms over its own reference
    norm, and whether ``change_gap`` counts it."""
    names = sorted(ref["grads"])
    med = statistics.median(ref["grads"][n] for n in names)
    out = []
    for n in names:
        g = ref["grads"][n]
        own = lambda key: (abs(prog[key][n] - ref[key][n])
                           / max(ref[key][n], 1e-30))
        out.append((n, g / max(med, 1e-30), own("grads"), own("change"),
                    g >= MIN_GRAD_SHARE * med))
    return out


def report_leaves(prog: dict, ref: dict) -> None:
    """:func:`leaf_gaps` on standard error, one line a leaf."""
    import sys

    for n, share, g, c, counted in leaf_gaps(prog, ref):
        print(f"leaf {n} grad/median {share:.3e} grad_gap_own {g:.3e} "
              f"change_gap_own {c:.3e}{'' if counted else ' (left out)'}",
              file=sys.stderr)


def train_checks(prog: dict, ref: dict, limits: dict) -> List[Check]:
    nums = train_numbers(prog, ref)
    return [Check(k, v, float(limits[k])) for k, v in nums.items()]


def output_gap(prog: List[Dict[str, np.ndarray]],
               ref: List[Dict[str, np.ndarray]]) -> float:
    worst = 0.0
    for k in ref[0]:
        p = np.concatenate([c[k].reshape(-1) for c in prog]).astype(np.float64)
        r = np.concatenate([c[k].reshape(-1) for c in ref]).astype(np.float64)
        rms = float(np.sqrt(np.mean(r * r)))
        worst = max(worst, float(np.sqrt(np.mean((p - r) ** 2)))
                    / max(rms, 1e-30))
    return worst


def render_checks(prog, ref, limits: dict) -> List[Check]:
    return [Check("output_gap", output_gap(prog, ref),
                  float(limits["output_gap"]))]
