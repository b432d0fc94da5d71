"""The trace summary and the metric readers, on a hand-made trace and on a
trace recorded on the CPU (its host operations standing in for device
operations)."""

import time

import pytest
import torch

from benchmark.harness import core, trace
from benchmark.tests.tiny import tiny_cell


def ev(cat, name, ts, dur, tid=1, **args):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
            "tid": tid, "args": args}


EVENTS = [
    ev("user_annotation", "bench/window", 0, 100),
    ev("user_annotation", "fine/backward", 10, 30),
    ev("user_annotation", "fine/adam", 50, 10),
    ev("user_annotation", "fine/march", 60, 10),
    ev("cpu_op", "aten::item", 30, 20),
    # the backward's launch comes from the autograd thread
    ev("cuda_runtime", "cudaLaunchKernel", 12, 1, tid=2, correlation=1),
    ev("cuda_runtime", "cudaLaunchKernel", 52, 1, correlation=2),
    ev("cuda_runtime", "cudaMemsetAsync", 80, 1, correlation=3),
    ev("kernel", "void scan_bwd_kernel<4>(...)", 20, 10, tid=7,
       correlation=1),
    ev("kernel", "splat_kernel", 55, 5, tid=7, correlation=2),
    ev("gpu_memset", "Memset (Device)", 85, 5, tid=7, correlation=3),
    ev("kernel", "other_kernel", 90, 2, tid=7),
    ev("kernel", "before the window", -5, 2, tid=7),
]


def test_summary_by_hand():
    s = trace.Summary(EVENTS)
    assert s.window_s == pytest.approx(100e-6)
    assert trace.union_s(s.intervals()) == pytest.approx(22e-6)
    assert trace.union_s([(0, 10), (5, 12), (20, 21), (1, 2)]) == \
        pytest.approx(13e-6)
    assert s.kernels() == 3
    assert s.device_s_in(lambda n: n.endswith("/backward")) == \
        pytest.approx(10e-6)
    assert s.device_s_in(lambda n: n.endswith("/adam")) == pytest.approx(5e-6)
    assert s.device_s_in(lambda n: n.endswith("/march")) == 0.0
    assert s.device_s_in(lambda n: n.endswith("/loss")) is None
    b = s.breakdown()
    assert dict(b["idle_gaps"]) == pytest.approx({
        "(no range)": 28e-6, "fine/backward > aten::item": 25e-6,
        "fine/march": 25e-6})
    assert b["device_ops"][0] == ["void scan_bwd_kernel<4>(...)",
                                  pytest.approx(10e-6)]


def test_readers_on_a_hand_made_run():
    run = core.Run(kind="train", traced=True, window_s=2.0, units=10,
                   rays=10 * 8192, flops=[1e11] * 10, trace_units=2,
                   busy_s=22e-6, busy_window_s=100e-6,
                   summary=trace.Summary(EVENTS), data_ms=[1.0, 3.0],
                   launch_work=[{"kernel": "scan_bwd", "bound_s": 4e-6},
                                {"kernel": "splat", "bound_s": 1e-6}])
    read = lambda name: core.reader(name)(run)
    assert read("step.mfu") == pytest.approx(100 * 1e12 / (2.0 * 989e12))
    assert read("step.launches") == 1.5
    assert read("phase.backward_ms") == pytest.approx(5e-3)
    assert read("march.device_ms.train") == 0.0
    assert read("device.idle_share.train") == pytest.approx(78.0)
    assert read("kernels.train_roofline") == pytest.approx(100 * 5 / 15)
    assert read("data.batch_ms") == 2.0
    # nothing to read in a traced run for the end-to-end metrics, nor in a
    # run of another kind
    assert read("train_rays_per_s") is None and read("setup_s") is None
    assert read("march.device_ms.render") is None
    run.launch_work = run.launch_work[:1]  # a launch missing: no pairing
    assert read("kernels.train_roofline") is None


def test_end_to_end_readers():
    run = core.Run(kind="train", traced=False, setup_s=12.5, window_s=2.0,
                   units=20, rays=20 * 8192,
                   unit_ms=[float(x) for x in range(1, 101)])
    assert core.reader("train_rays_per_s")(run) == 20 * 8192 / 2.0
    assert core.reader("train_step_ms_p95")(run) == pytest.approx(95.05)
    assert core.reader("setup_s")(run) == 12.5
    assert core.reader("render_rays_per_s")(run) is None


def test_readers_on_a_cpu_trace_of_a_step():
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
    busy, wall, _ = trace.busy(window, lambda: None, device_cats=("cpu_op",))
    assert 0 < busy <= wall
    run = core.Run(kind="train", traced=True, trace_units=1, summary=s,
                   busy_s=busy, busy_window_s=wall)
    ms = core.read_metrics(run, cell.per_layer)
    for name in ("phase.backward_ms", "phase.adam_ms",
                 "march.device_ms.train"):
        assert ms[name]["value"] > 0, name
    assert ms["step.launches"]["value"] > 100
    assert 0.0 <= ms["device.idle_share.train"]["value"] < 100.0
    b = s.breakdown()
    assert 0 < len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10


@pytest.mark.parametrize("kind", ["train", "render"])
def test_a_traced_run_reads_every_per_layer_metric(kind):
    from benchmark.drivers import render, train

    cell = tiny_cell(kind)
    ctx = core.Ctx(cell, 5, torch.device("cpu"), 0.0, True,
                   time.perf_counter())
    rec = (train if kind == "train" else render).run(ctx)["run"]
    assert rec.flops and all(f > 0 for f in rec.flops)
    assert 0 < rec.busy_s <= rec.busy_window_s
    ms = core.read_metrics(rec, cell.per_layer)
    # the kernels' roofline pairs CUDA launches alone, none on the CPU
    want = {m["name"] for m in cell.per_layer} - {
        f"kernels.{kind}_roofline"}
    assert want <= set(ms), sorted(want - set(ms))
