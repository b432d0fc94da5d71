"""A traced window's profile, reduced to what the per-layer readers need.

:func:`capture` runs a function under ``torch.profiler`` recording host
and device activity (each operator and range, which slows the host by half
or more), writes the Chrome trace to a temporary directory, reads it back
and deletes it. :class:`Summary` holds the window (the benchmark's own
``bench/window`` range), the device's operations in it, the host time of the
launch behind each (CUDA runtime and driver events, joined by correlation
id), and the host ranges (``record_function``: the benchmark's ``bench/*``
spans and the program's ``<stage>/*`` phases). :func:`busy` runs a function
under the profiler recording device activity alone, which costs the host
far less (a tenth or two of a step here), and returns the seconds in which
an operation ran on the device and the window's length on the host clock:
the device's idle share. :func:`record` makes both windows of a traced run.

A device operation belongs to a host range when its launch falls inside the
range's interval, on any thread: the autograd engine launches the backward
from its own thread while the caller's thread waits inside the range.
"""

from __future__ import annotations

import bisect
import heapq
import json
import os
import tempfile
import time
from collections import defaultdict
from typing import Callable, Iterable, List, NamedTuple, Optional, Tuple

WINDOW = "bench/window"
MARK = "spin_kernel"  # torch.cuda._sleep's kernel
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


class DeviceOp(NamedTuple):
    name: str
    start: float
    end: float
    launch: float  # host time of its launch
    cat: str


class Summary:
    """Device operations ``(name, start, end, launch)`` in the window, host
    ranges ``(name, start, end)`` and host operations of the window's
    thread, all in microseconds on the trace's clock."""

    def __init__(self, events: Iterable[dict], device_cats=DEVICE_CATS):
        events = [e for e in events if e.get("ph") == "X"]
        wins = [e for e in events if e.get("name") == WINDOW
                and e.get("cat") == "user_annotation"]
        if len(wins) != 1:
            raise ValueError(f"expected one {WINDOW} range, found {len(wins)}")
        w = wins[0]
        self.t0, self.t1 = float(w["ts"]), float(w["ts"]) + float(w["dur"])
        launch = {}
        for e in events:
            if e.get("cat") in LAUNCH_CATS:
                c = (e.get("args") or {}).get("correlation")
                if c is not None:
                    launch[c] = float(e["ts"])
        self.device: List[DeviceOp] = []
        for e in events:
            if e.get("cat") not in device_cats:
                continue
            ts = float(e["ts"])
            if not self.t0 <= ts < self.t1:
                continue
            c = (e.get("args") or {}).get("correlation")
            at = launch.get(c, ts) if c is not None else ts
            self.device.append(DeviceOp(e["name"], ts,
                                        ts + float(e.get("dur", 0.0)), at,
                                        e["cat"]))
        self.ranges = [(e["name"], float(e["ts"]),
                        float(e["ts"]) + float(e["dur"])) for e in events
                       if e.get("cat") == "user_annotation"
                       and e["name"] != WINDOW]
        self.host_ops = sorted(
            (float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
            for e in events if e.get("cat") == "cpu_op"
            and e.get("tid") == w.get("tid"))

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def intervals(self) -> List[Tuple[float, float]]:
        """The union of the device operations' intervals, clipped to the
        window."""
        out: List[List[float]] = []
        for _, a, b, _, _ in sorted(self.device, key=lambda d: d.start):
            b = min(b, self.t1)
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def kernels(self) -> int:
        """Kernel launches on the device (copies and fills left out)."""
        return sum(1 for d in self.device
                   if d.cat not in ("gpu_memcpy", "gpu_memset"))

    def device_s(self, pred: Callable[[str], bool]) -> float:
        """Seconds of the device operations whose name satisfies ``pred``."""
        return sum(d.end - d.start for d in self.device if pred(d.name)) / 1e6

    def device_s_in(self,
                    range_pred: Callable[[str], bool]) -> Optional[float]:
        """Seconds of the device operations launched inside any host range
        whose name satisfies ``range_pred``; None where no such range is in
        the trace."""
        spans = sorted((a, b) for n, a, b in self.ranges if range_pred(n))
        if not spans:
            return None
        merged: List[List[float]] = []
        for a, b in spans:
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        starts = [a for a, _ in merged]
        tot = 0.0
        for d in self.device:
            k = bisect.bisect_right(starts, d.launch) - 1
            if k >= 0 and d.launch <= merged[k][1]:
                tot += d.end - d.start
        return tot / 1e6

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle time by
        what the host was doing when each gap began (summed per label)."""
        per = defaultdict(float)
        for d in self.device:
            per[d.name[:96]] += (d.end - d.start) / 1e6
        busiest = sorted(per.items(), key=lambda kv: -kv[1])[:top]
        holes, t = [], self.t0
        for a, b in self.intervals() + [(self.t1, self.t1)]:
            if a > t:
                holes.append((t, a))
            t = max(t, b)
        starts = [a for a, _ in holes]
        rng = _innermost([(a, b, n) for n, a, b in self.ranges], starts)
        ops = _innermost(self.host_ops, starts)
        gaps = defaultdict(float)
        for (a, b), r, o in zip(holes, rng, ops):
            label = (r or "(no range)") + (f" > {o}" if o else "")
            gaps[label] += (b - a) / 1e6
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, s] for n, s in busiest],
                "idle_gaps": [[n, s] for n, s in idle]}


def _innermost(spans, times) -> List[Optional[str]]:
    """For each of the ascending ``times``, the name of the latest-starting
    span ``(start, end, name)`` open at it, or None."""
    spans = sorted(spans)
    heap: List[Tuple[float, float, str]] = []
    out, k = [], 0
    for t in times:
        while k < len(spans) and spans[k][0] <= t:
            a, b, n = spans[k]
            heapq.heappush(heap, (-a, b, n))
            k += 1
        while heap and heap[0][1] <= t:
            heapq.heappop(heap)
        out.append(heap[0][2] if heap else None)
    return out


def union_s(spans: Iterable[Tuple[float, float]]) -> float:
    """Seconds covered by the union of ``(start, end)`` microsecond
    spans."""
    tot, hi = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > hi:
            tot += b - max(a, hi)
            hi = b
    return tot / 1e6


def _events(prof) -> List[dict]:
    with tempfile.TemporaryDirectory(prefix="esr-bench-") as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]


def busy(fn: Callable[[], None], warm: Callable[[], None],
         device_cats=DEVICE_CATS) -> Tuple[float, float, int]:
    """Run ``fn`` (which ends by synchronising the device) under the
    profiler recording device activity alone. Returns the seconds in which
    an operation of ``device_cats`` ran, the seconds ``fn`` took on the host
    clock, and the number of kernels.

    A profiler started a second time in a process misses the device's
    first operations, so ``warm`` runs one step or chunk under it first,
    and a spin kernel then marks where the window begins. The CPU tests
    pass ``("cpu_op",)`` and record host operators instead, after a range
    of the marker's name."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cpu = "cpu_op" in device_cats
    acts = [ProfilerActivity.CPU if cpu else ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        warm()
        if cpu:
            with torch.profiler.record_function(MARK):
                pass
        else:
            torch.cuda._sleep(1000)
            torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        window = time.perf_counter() - t
    events = [e for e in _events(prof) if e.get("ph") == "X"]
    marks = [float(e["ts"]) + float(e.get("dur", 0.0)) for e in events
             if MARK in e.get("name", "")]
    if not marks:
        raise RuntimeError("the device-only trace lost its start marker")
    ops = [e for e in events if e.get("cat") in device_cats
           and float(e["ts"]) >= max(marks)]
    spans = [(float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0)))
             for e in ops]
    kernels = sum(1 for e in ops if e.get("cat") not in ("gpu_memcpy",
                                                          "gpu_memset"))
    return union_s(spans), window, kernels


def capture(fn: Callable[[], None], warm: Callable[[], None],
            device_cats=DEVICE_CATS) -> Summary:
    """Run ``fn`` (which opens the ``bench/window`` range) under the
    profiler, host and device activity, after one ``warm`` step or chunk
    outside the range (as for :func:`busy`), and summarise its trace."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        warm()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        fn()
    return Summary(_events(prof), device_cats)


def record(run, unit: Callable[[], None], n: int, device,
           device_cats=DEVICE_CATS) -> None:
    """A traced run's two traced windows of ``n`` calls of ``unit`` (a step
    or a chunk), after its measured window, into ``run``: the first under
    the profiler with host activity too (the ranges, the launches and the
    breakdown), the second with device activity alone (the busy and window
    seconds)."""
    import torch

    from benchmark.harness.core import sync
    from benchmark.harness.launches import Recorder

    def units():
        for _ in range(n):
            unit()
        sync(device)

    launches = Recorder()

    def window():
        with torch.profiler.record_function(WINDOW), launches:
            units()

    run.trace_units = n
    run.summary = capture(window, unit, device_cats)
    run.launch_work = launches.work()
    run.busy_s, run.busy_window_s, run.busy_kernels = busy(units, unit,
                                                           device_cats)
    report(run)


def report(run) -> None:
    """A traced run's milliseconds a step or chunk on standard error, in
    the measured window and in each traced one (the profilers' cost), and
    the kernels a unit in each trace (a trace that lost records reads
    fewer)."""
    import sys

    n = run.trace_units
    print(f"trace ms per unit: measured {run.window_s / run.units * 1e3:.3f}, "
          f"device-only traced {run.busy_window_s / n * 1e3:.3f} (busy "
          f"{run.busy_s / n * 1e3:.3f}), host traced "
          f"{run.summary.window_s / n * 1e3:.3f}; kernels per unit: "
          f"device-only {run.busy_kernels / n:.1f}, host traced "
          f"{run.summary.kernels() / n:.1f}", file=sys.stderr, flush=True)
