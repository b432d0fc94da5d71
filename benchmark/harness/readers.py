"""Arithmetic shared by the metric readers in ``benchmark/metrics/``.

Each reader returns None where its run has nothing to read (another kind of
traffic, an untraced run, or no such range or launch in the trace), and the
harness then leaves the metric out of the result line.
"""

from __future__ import annotations

from typing import Callable, Optional

import numpy as np

from benchmark.harness import roofline
from benchmark.harness.core import Run


def untraced(run: Run, kind: str) -> bool:
    return run.kind == kind and not run.traced and run.window_s > 0


def traced(run: Run, kind: str) -> bool:
    return run.kind == kind and run.traced and run.summary is not None


def rate(run: Run, kind: str) -> Optional[float]:
    """Primary rays completed in the window over its seconds."""
    return run.rays / run.window_s if untraced(run, kind) else None


def percentile_ms(run: Run, kind: str, q: float) -> Optional[float]:
    if not untraced(run, kind) or not run.unit_ms:
        return None
    return float(np.percentile(np.asarray(run.unit_ms), q))


def mfu(run: Run, kind: str) -> Optional[float]:
    """Head operations of the measured window (of a traced run) over its
    seconds at the bf16 peak, in %."""
    if not traced(run, kind) or not run.flops:
        return None
    return 100.0 * sum(run.flops) / (run.window_s * roofline.BF16_FLOP_PER_S)


def range_ms(run: Run, kind: str,
             pred: Callable[[str], bool]) -> Optional[float]:
    """Device ms per step or chunk launched inside the ranges ``pred``
    names."""
    if not traced(run, kind):
        return None
    s = run.summary.device_s_in(pred)
    return None if s is None else s / run.trace_units * 1e3


def is_march(name: str) -> bool:
    return name.endswith("/march") or name.endswith("/march_2nd")


def kernels_roofline(run: Run, kind: str) -> Optional[float]:
    """Sum of the recorded launches' bounds over the device time of their
    kernels, in %; None where the trace and the record disagree on the
    number of launches of a kernel."""
    if not traced(run, kind) or not run.launch_work:
        return None
    bound = dev = 0.0
    for k in roofline.KERNELS:
        recs = [w for w in run.launch_work if w["kernel"] == k]
        ops = [d for d in run.summary.device if f"{k}_kernel" in d.name]
        if len(recs) != len(ops):
            return None
        bound += sum(w["bound_s"] for w in recs)
        dev += sum(d.end - d.start for d in ops) / 1e6
    return 100.0 * bound / dev if dev > 0 else None


def idle_share(run: Run, kind: str) -> Optional[float]:
    """Share of the device-only traced window in which no operation ran on
    the device, in %."""
    if not traced(run, kind) or run.busy_s <= 0:
        return None
    return 100.0 * (1.0 - run.busy_s / run.busy_window_s)
