"""Recommend march point budgets from a training run's metrics.jsonl.

The march compacts into budgets fixed per ray
(``points_budget_masked_per_ray``, ``points_budget_per_ray`` and the
``*_per_2ndray`` pair of the LTS/PDRA secondary march); every stage logs
their use as ``train/metric/etc/k1_frac`` and ``.../k2_frac`` (and
``k*_frac_2nd``) and the dropped share as ``.../overflow``. This tool reads
log dirs (or ``metrics.jsonl`` files) and prints each fraction's median,
p99 and max with the budget scale that leaves 1.3x headroom over the max.

Usage:
  python -m esrnerf_tpu_torch.scripts.budget_advisor <logdir or metrics.jsonl> [...]

``app.model.budget_autotune=true`` applies the same sizing during a run
from its first step; this tool reads a whole run's envelope afterwards.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np

HEADROOM = 1.3  # recommended budget = observed max * HEADROOM
_KEYS = ("etc/k1_frac", "etc/k2_frac", "etc/k1_frac_2nd", "etc/k2_frac_2nd",
         "etc/overflow")
_BUDGETS = (("etc/k1_frac", "points_budget_masked_per_ray"),
            ("etc/k2_frac", "points_budget_per_ray"),
            ("etc/k1_frac_2nd", "points_budget_masked_per_2ndray"),
            ("etc/k2_frac_2nd", "points_budget_per_2ndray"))


def scan(path):
    """``{key: float64 array}`` of the ``train/metric/<key>`` values of the
    rows of one ``metrics.jsonl`` that log them (unparsable lines
    skipped)."""
    rows = []
    with open(path) as f:
        for line in f:
            try:
                rows.append(json.loads(line))
            except json.JSONDecodeError:
                continue
    out = {}
    for key in _KEYS:
        vals = [r[f"train/metric/{key}"] for r in rows
                if f"train/metric/{key}" in r]
        if vals:
            out[key] = np.asarray(vals, np.float64)
    return out


def report(path, stats):
    """The printed lines for one file's :func:`scan`."""
    lines = [f"\n== {path}"]
    ovf = stats.get("etc/overflow")
    if ovf is not None and ovf.max() > 0:
        lines.append(f"  OVERFLOW seen (max {ovf.max():.4f}) — budgets are "
                     "too SMALL; raise before trusting the numbers below.")
    for key, name in _BUDGETS:
        v = stats.get(key)
        if v is None:
            continue
        mx, p99, med = v.max(), np.percentile(v, 99), np.median(v)
        # only shrinking is clamped: use above 1 (overflow) must show as a
        # grow factor above 1, not "1.00x"
        rec = mx * HEADROOM
        lines.append(f"  {key}: median {med:.3f}  p99 {p99:.3f}  max {mx:.3f}"
                     f" -> scale {name} by ~{rec:.2f}x"
                     + ("  (already tight)" if 0.85 < rec <= 1.0 else "")
                     + ("  (GROW: budget overflowed)" if mx > 1.0 else ""))
    return lines


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    paths = []
    for root in argv:
        if os.path.isfile(root):
            paths.append(root)
        else:
            for dirpath, _, names in os.walk(root):
                if "metrics.jsonl" in names:
                    paths.append(os.path.join(dirpath, "metrics.jsonl"))
    if not paths:
        print("no metrics.jsonl found under", argv)
        return 1
    for p in paths:
        stats = scan(p)
        if stats:
            print("\n".join(report(p, stats)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
