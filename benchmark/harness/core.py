"""What every run shares: the cell's files found by name, the record of a
run that the metric readers read, the result line, and the checks that the
JAX package stayed out of the process."""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
# top-level module names that may not be loaded in a benchmark process
FORBIDDEN = ("jax", "jaxlib", "flax", "esrnerf_tpu")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with its configuration, traffic
    mix and metrics."""

    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: List[dict]
    per_layer: List[dict]

    @classmethod
    def load(cls, name: str, root: str = ROOT) -> "Cell":
        spec = load_json(os.path.join(root, "BENCHMARK.json"))
        cells = {w["name"]: w for w in spec["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                           f"(have {sorted(cells)})")
        w = cells[name]
        cfgs = {c["name"]: c for c in spec["configs"]}
        config = load_json(os.path.join(root, cfgs[w["config"]]["file"]))
        traffic = load_json(os.path.join(BENCH_DIR, "traffic",
                                         f"{w['traffic']}.json"))

        def mine(ms):
            return [m for m in ms if name in m.get("workloads", [name])]

        return cls(name, config, traffic, int(w["chips"]),
                   mine(spec["end_to_end"]), mine(spec["per_layer"]))


def part(kind: str, name: str):
    """``benchmark/<kind>/<name>.py`` as a module (stages, drivers,
    references)."""
    return importlib.import_module(f"benchmark.{kind}.{name}")


def reader(metric: str) -> Callable[["Run"], Optional[float]]:
    """The ``read`` function of ``benchmark/metrics/<metric>.py``."""
    path = os.path.join(BENCH_DIR, "metrics", f"{metric}.py")
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + metric.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


@dataclass
class Run:
    """What a run measured, for the metric readers. Times in seconds unless
    the name says otherwise."""

    kind: str                      # the traffic's kind: train or render
    traced: bool                   # a --trace 1 run
    setup_s: float = 0.0
    # the measured window (a traced run measures one too, before its trace)
    window_s: float = 0.0
    units: int = 0                 # steps or chunks in the window
    rays: int = 0                  # primary rays completed in the window
    # each step (CUDA-event intervals) or chunk (host clock) of the window
    unit_ms: List[float] = field(default_factory=list)
    data_ms: List[float] = field(default_factory=list)  # host sample + place
    flops: List[float] = field(default_factory=list)    # per step or march
    memory_peak: int = 0           # bytes, at the measured window's end
    # a traced run's two traced windows of trace_units steps or chunks each:
    # one recording host activity too (summary, launch_work), then one
    # recording device activity alone (busy_s of busy_window_s)
    trace_units: int = 0
    busy_s: float = 0.0
    busy_window_s: float = 0.0
    busy_kernels: int = 0
    summary: Any = None            # its trace.Summary
    launch_work: Optional[List[dict]] = None


def read_metrics(run: Run, metrics: List[dict]) -> Dict[str, dict]:
    out = {}
    for m in metrics:
        v = reader(m["name"])(run)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


class HostLoad:
    """A window's host side, for standard error: its seconds, this
    process's CPU seconds in it, and the mean ms of its steps or chunks in
    each quarter of the window (the machine's own load counters read zero
    in the card's sandbox)."""

    def __init__(self):
        self.start = (time.perf_counter(), time.process_time())

    def report(self, what: str, unit_ms: List[float]) -> None:
        t, cpu = (b - a for a, b in zip(
            self.start, (time.perf_counter(), time.process_time())))
        q = len(unit_ms) // 4
        quarters = " ".join(f"{sum(unit_ms[i * q:(i + 1) * q]) / q:.2f}"
                            for i in range(4)) if q else "-"
        print(f"host {what}: {t:.3f} s, {cpu:.2f} cpu-s in this process; ms "
              f"a unit by quarter {quarters}", file=sys.stderr, flush=True)


def forbidden_modules() -> List[str]:
    """Loaded modules whose whole top-level name is forbidden."""
    tops = {n.split(".")[0] for n in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


@dataclass
class Ctx:
    """One run: its cell, seed, device and window, the process's start on
    the host clock, and a fault planted in the timed path (tests only)."""

    cell: Cell
    seed: int
    device: Any
    seconds: float
    trace: bool
    t0: float
    fault: Optional[str] = None

    @property
    def device_cats(self):
        """The trace categories of device operations; on the CPU (the
        tests) host operators stand in for them."""
        from benchmark.harness import trace

        return ("cpu_op",) if self.device.type == "cpu" else trace.DEVICE_CATS

    def mark(self, what: str) -> None:
        """Note on standard error how far set-up has come."""
        print(f"setup {what} {time.perf_counter() - self.t0:.3f} s",
              file=sys.stderr, flush=True)


def sync(device) -> None:
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)


def memory_peak(device) -> int:
    if device.type != "cuda":
        return 0
    import torch

    return int(torch.cuda.max_memory_allocated(device))


def free(device) -> None:
    import gc

    gc.collect()
    if device.type == "cuda":
        import torch

        torch.cuda.empty_cache()


@dataclass
class Check:
    """A number compared with its limit: correct while ``value <=
    limit``."""

    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value == self.value and self.value <= self.limit


def emit(result: dict, checks: List[Check]) -> None:
    """Each compared number beside its limit, as the last lines on standard
    error and as the result line's last key; the result as the last line on
    standard output."""
    for c in checks:
        print(f"check {c.name} {c.value!r} limit {c.limit!r} "
              f"{'ok' if c.ok else 'FAILED'}", file=sys.stderr, flush=True)
    result = dict(result)
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                        for c in checks}
    print(json.dumps(result), flush=True)
