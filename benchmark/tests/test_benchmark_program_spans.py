"""The readers of the program's own spans and counters: the backward split
by forward phase, the eval forward's features and heads, the march's four
stages, the data calls, the eval path's overflow wait and retries; on a
hand-made trace and a hand-filled span record, and on a trace of a tiny
fine step recorded on the CPU."""

import time

import pytest
import torch

from benchmark.harness import core, readers, spans, trace
from benchmark.tests.tiny import tiny_cell


def ev(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "args": args}


def kernel(i, ts, dur):
    """A launch at ``ts`` (the autograd thread's, tid 2) of a kernel that
    runs ``dur`` at ``ts + 1``."""
    return [ev("cuda_runtime", "cudaLaunchKernel", ts, 0.5, tid=2,
               correlation=i),
            ev("kernel", f"k{i}", ts + 1, dur, tid=7, correlation=i)]


TRAIN = [
    ev("user_annotation", "bench/window", 0, 200),
    ev("user_annotation", "fine/backward", 10, 100),
    ev("user_annotation", "fine/bwd_loss", 12, 10, tid=2),
    ev("user_annotation", "fine/bwd_heads", 22, 20, tid=2),
    ev("user_annotation", "fine/bwd_features", 42, 30, tid=2),
    ev("user_annotation", "fine/bwd_march", 72, 30, tid=2),
    *kernel(1, 13, 2), *kernel(2, 25, 4), *kernel(3, 30, 1),
    *kernel(4, 50, 6), *kernel(5, 80, 8),
    # after the last range closes, inside the backward
    *kernel(6, 105, 3),
]

RENDER = [
    ev("user_annotation", "bench/window", 0, 200),
    ev("user_annotation", "fine/march", 10, 80),
    ev("user_annotation", "march/phase1", 10, 20),
    ev("user_annotation", "march/alpha", 30, 20),
    ev("user_annotation", "march/scan", 50, 20),
    ev("user_annotation", "march/phase2", 70, 20),
    ev("user_annotation", "fine/features", 90, 30),
    ev("user_annotation", "fine/heads", 120, 40),
    *kernel(1, 11, 2), *kernel(2, 31, 3), *kernel(3, 51, 4),
    *kernel(4, 71, 5), *kernel(5, 91, 6), *kernel(6, 121, 7),
    *kernel(7, 130, 1),
]

SNAP = {"spans": {"data/sample": {"count": 4, "total_ns": 10_000_000,
                                  "ns": [1_000_000, 2_000_000, 3_000_000,
                                         4_000_000]},
                  "data/place": {"count": 3, "total_ns": 1_500_000,
                                 "ns": [500_000, 400_000, 600_000]},
                  "eval/overflow_wait": {"count": 3, "total_ns": 9_000_000,
                                         "ns": [2_000_000, 5_000_000,
                                                2_000_000]}},
        "counters": {"eval.chunks": 8, "eval.retries": 2}}

NEW = {"train": ["backward.loss_ms", "backward.heads_ms",
                 "backward.features_ms", "backward.march_ms", "data.host_ms"],
       "render": ["features.device_ms.render", "heads.device_ms.render",
                  "march.phase1_ms.render", "march.alpha_ms.render",
                  "march.scan_ms.render", "march.phase2_ms.render",
                  "eval.host_wait_ms", "eval.retries_per_chunk"]}


def _run(kind, events, traced=True):
    return core.Run(kind=kind, traced=traced, trace_units=2,
                    summary=trace.Summary(events) if traced else None)


def test_the_readers_on_a_hand_made_trace_and_record(monkeypatch):
    monkeypatch.setattr(spans, "snapshot", lambda: SNAP)
    train, render = _run("train", TRAIN), _run("render", RENDER)
    read = lambda name, run: core.reader(name)(run)
    # device ms a step: two traced steps
    assert read("backward.loss_ms", train) == pytest.approx(1e-3)
    assert read("backward.heads_ms", train) == pytest.approx(2.5e-3)
    assert read("backward.features_ms", train) == pytest.approx(3e-3)
    assert read("backward.march_ms", train) == pytest.approx(4e-3)
    parts = sum(read(n, train) for n in NEW["train"][:4])
    assert parts <= read("phase.backward_ms", train) == pytest.approx(12e-3)
    assert read("data.host_ms", train) == pytest.approx(2.5 + 0.5)
    assert read("features.device_ms.render", render) == pytest.approx(3e-3)
    assert read("heads.device_ms.render", render) == pytest.approx(4e-3)
    for name, ms in (("phase1", 1e-3), ("alpha", 1.5e-3), ("scan", 2e-3),
                     ("phase2", 2.5e-3)):
        assert read(f"march.{name}_ms.render", render) == pytest.approx(ms)
    assert read("march.device_ms.render", render) == pytest.approx(7e-3)
    assert read("eval.host_wait_ms", render) == pytest.approx(2.0)
    assert read("eval.retries_per_chunk", render) == 0.25
    # another kind, an untraced run, or a record without the span
    for kind, names in NEW.items():
        other = _run("render" if kind == "train" else "train",
                     RENDER if kind == "train" else TRAIN)
        for name in names:
            assert read(name, other) is None, name
            assert read(name, _run(kind, [], traced=False)) is None, name
    monkeypatch.setattr(spans, "snapshot", lambda: {"spans": {},
                                                    "counters": {}})
    for name in ("data.host_ms", "eval.host_wait_ms",
                 "eval.retries_per_chunk"):
        assert read(name, train if name == "data.host_ms" else render) \
            is None, name


def test_a_program_without_the_record_reads_nothing(monkeypatch):
    from esrnerf_tpu_torch.utils import profiling

    monkeypatch.delattr(profiling, "snapshot")
    assert spans.snapshot() is None
    assert spans.median_ms("data/sample") is None
    assert spans.counter("eval.chunks") is None
    assert core.reader("data.host_ms")(_run("train", TRAIN)) is None
    # nor do the device readers find a range the parent never opens
    assert core.reader("backward.loss_ms")(_run("train", TRAIN[:2])) is None


def test_old_predicates_match_the_same_ranges_on_a_traced_step():
    """On a traced tiny fine step the march, backward and Adam readers'
    predicates still match exactly the ranges they matched before the
    backward was split by phase and the march by stage."""
    from benchmark.drivers import train

    cell = tiny_cell("train")
    ctx = core.Ctx(cell, 3, torch.device("cpu"), 0.0, False,
                   time.perf_counter())
    st = train.setup(ctx)

    def window():
        with torch.profiler.record_function(trace.WINDOW):
            aux = st.stage.step(st.step, st.stage.place(st.stage.sample()))
            st.stage.after_step(st.step, aux)

    s = trace.capture(window, lambda: None, device_cats=("cpu_op",))
    names = {n for n, _, _ in s.ranges}
    assert {f"fine/bwd_{p}" for p in ("loss", "heads", "features",
                                      "march")} <= names
    assert {f"march/{p}" for p in ("phase1", "alpha", "scan",
                                   "phase2")} <= names
    assert {n for n in names if readers.is_march(n)} == {"fine/march"}
    assert {n for n in names if n.endswith("/backward")} == {"fine/backward"}
    assert {n for n in names if n.endswith("/adam")} == {"fine/adam"}
