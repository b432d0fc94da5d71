"""The port's spans and counters (``esrnerf_tpu_torch/utils/profiling.py``):
the record and its ring, a ``record_function`` range only while a profiler
records, the backward split by forward phase on a toy graph and on a tiny
``VoxurfF``, the eval path's ranges, ``eval_chunk_retry``'s counters, and
the trainers' log export. JAX-free; on the CPU."""

import json
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from esrnerf_tpu_torch.apps.base import AppClass, loss_and_grads
from esrnerf_tpu_torch.utils import profiling
from test_torch_common import NUM_VOXELS, S_VAL, ball_density, rays

pytestmark = pytest.mark.quick

BWD = [f"fine/bwd_{p}" for p in ("loss", "heads", "features", "march")]
MARCH = [f"march/{p}" for p in ("phase1", "alpha", "scan", "phase2")]


@pytest.fixture(autouse=True)
def clean_record():
    profiling.reset()
    yield
    profiling.reset()


def _events(prof, tmp_path):
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        return [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]


def _ranges(events):
    """``{name: [(start, end), ...]}`` of the user ranges."""
    out = {}
    for e in events:
        if e.get("cat") == "user_annotation":
            out.setdefault(e["name"], []).append(
                (float(e["ts"]), float(e["ts"]) + float(e["dur"])))
    return out


def _graph_names(t):
    seen, todo, names = set(), [t.grad_fn], []
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        names.append(type(fn).__name__)
        todo += [f for f, _ in fn.next_functions]
    return names


def test_span_and_count_record_ring_and_reset(monkeypatch):
    monkeypatch.setattr(profiling, "RING", 3)
    for _ in range(5):
        with profiling.span("t/a"):
            pass
    with profiling.span("t/b"):
        pass
    profiling.count("c.x")
    profiling.count("c.x", 2)
    snap = profiling.snapshot()
    a = snap["spans"]["t/a"]
    assert a["count"] == 5 and len(a["ns"]) == 3
    assert all(ns >= 0 for ns in a["ns"]) and a["total_ns"] >= sum(a["ns"])
    assert snap["spans"]["t/b"]["count"] == 1
    assert snap["counters"] == {"c.x": 3}
    # the snapshot is a copy
    snap["counters"]["c.x"] = 0
    assert profiling.snapshot()["counters"]["c.x"] == 3
    profiling.reset()
    assert profiling.snapshot() == {"spans": {}, "counters": {}}


def test_span_emits_a_range_only_under_a_profiler(monkeypatch, tmp_path):
    made = []
    real = torch.autograd.profiler.record_function

    def counting(name, *a):
        made.append(name)
        return real(name, *a)

    monkeypatch.setattr(profiling._autograd_profiler, "record_function",
                        counting)
    with profiling.span("t/off"):
        pass
    assert made == [] and not profiling.profiler_on()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        assert profiling.profiler_on()
        with profiling.span("t/on"):
            torch.ones(4).sum()
    assert made == ["t/on"]
    assert set(_ranges(_events(prof, tmp_path))) == {"t/on"}
    assert profiling.snapshot()["spans"]["t/off"]["count"] == 1
    assert profiling.snapshot()["spans"]["t/on"]["count"] == 1


def _toy_loss(p):
    """Three forward phases with their own operators: sin, exp, tanh."""
    x = profiling.bwd_mark(None, p["w"])
    a = profiling.bwd_mark("first", torch.sin(x))
    b = profiling.bwd_mark("second", torch.exp(a))
    return torch.tanh(b).sum(), None


def test_backward_marks_split_a_toy_backward(tmp_path):
    params = {"w": torch.linspace(-1.0, 1.0, 257)}
    _, g_off = loss_and_grads(_toy_loss, params, "toy")
    with profiling.split_backward("toy") as split:
        loss, _ = _toy_loss({"w": params["w"].clone().requires_grad_(True)})
    assert split is None
    assert "_MarkBackward" not in _graph_names(loss)

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, g_on = loss_and_grads(_toy_loss, params, "toy")
        # a loss that marks no phase is not split
        loss_and_grads(lambda p: (p["w"].square().sum(), None), params,
                       "plain")
    assert torch.equal(g_on["w"], g_off["w"])
    events = _events(prof, tmp_path)
    rng = _ranges(events)
    names = ["toy/bwd_loss", "toy/bwd_second", "toy/bwd_first"]
    assert all(len(rng[n]) == 1 for n in names), rng
    assert not [n for n in rng if n.startswith("plain/bwd")]
    (back,) = rng["toy/backward"]
    spans = [rng[n][0] for n in names]
    # in the backward's order, disjoint, inside the caller's range
    assert back[0] <= spans[0][0]
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert spans[-1][1] <= back[1]
    where = {"TanhBackward0": 0, "SumBackward0": 0, "ExpBackward0": 1,
             "SinBackward0": 2}
    found = set()
    for e in events:
        op = e["name"].rsplit(": ", 1)[-1]
        if e["name"].startswith("autograd::engine::evaluate_function") \
                and op in where and back[0] <= float(e["ts"]) <= back[1]:
            a, b = spans[where[op]]
            assert a <= float(e["ts"]) <= b, (op, e["ts"], spans)
            found.add(op)
    assert found == set(where)


@pytest.fixture(scope="module")
def tiny_fine():
    from esrnerf_tpu_torch.config import load_cfg
    from esrnerf_tpu_torch.models import voxurf_base as tvb
    from esrnerf_tpu_torch.models.voxurff import VoxurfF
    from test_torch_common import OVERRIDES, REPO

    cfg = load_cfg("cfg/app/fine.yaml", OVERRIDES, root_dir=REPO)
    mc = tvb.make_mask_cache(ball_density(), [-1, -1, -1], [1, 1, 1], 1e-6,
                             1e-3, 3, device="cpu")
    model = VoxurfF(cfg, 0.5, 4.0, [-1, -1, -1], [1, 1, 1], mc, S_VAL,
                    NUM_VOXELS)
    params = model.init_params(torch.Generator().manual_seed(0))
    X, Y, Z = model.geo.world_size
    x, y, z = np.mgrid[-1:1:X * 1j, -1:1:Y * 1j, -1:1:Z * 1j]
    r = np.sqrt(x**2 + y**2 + z**2)
    params["sdf"] = torch.from_numpy((r - 0.5).astype(np.float32)[..., None])
    batch = {k: torch.as_tensor(v) for k, v in rays().items()}
    return cfg, model, params, batch


class _GradsOut:
    def step(self, params, grads, state, lr_scales=None):
        return grads, state


def test_fine_step_backward_shows_its_four_phases(tiny_fine, tmp_path):
    from esrnerf_tpu_torch.apps.fine import build_fine_train_step

    cfg, model, params, b = tiny_fine
    step = build_fine_train_step(model, _GradsOut(), cfg, device="cpu")
    args = (None, b, S_VAL, {k: 1.0 for k in params}, 1.0, 0.05, 1e-5, True)
    g_off = step(params, *args)[0]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        g_on = step(params, *args)[0]
    for k in params:
        assert all(torch.equal(g_on[k][n], g_off[k][n]) for n in g_on[k]) \
            if isinstance(g_on[k], dict) else torch.equal(g_on[k], g_off[k])
    rng = _ranges(_events(prof, tmp_path))
    assert all(len(rng.get(n, ())) == 1 for n in BWD), sorted(rng)
    (back,) = rng["fine/backward"]
    spans = [rng[n][0] for n in BWD]
    assert back[0] <= spans[0][0] and spans[-1][1] <= back[1]
    assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
    assert {"fine/march", "fine/features", "fine/heads"} <= set(rng)
    assert all(len(rng[n]) == 1 for n in MARCH)


def test_fine_eval_forward_shows_features_heads_and_the_march(tiny_fine,
                                                              tmp_path):
    _, model, params, b = tiny_fine
    args = (params, b["rays_o"], b["rays_d"], b["viewdirs"], 1,
            torch.eye(3), S_VAL)
    off = model.forward_evaluate(*args)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        on = model.forward_evaluate(*args)
    assert sorted(on) == sorted([
        "srgb/off_rgb", "lin/off_rgb", "srgb/on_rgb", "lin/on_rgb",
        "srgb/emo_rgb", "lin/emo_rgb", "etc/normal", "etc/depth",
        "etc/disp", "etc/white_bg", "srgb/rgb", "lin/rgb", "etc/overflow"])
    assert all(torch.equal(on[k], off[k]) for k in on)
    rng = _ranges(_events(prof, tmp_path))
    (march,) = rng["fine/march"]
    for n in MARCH:
        (s,) = rng[n]
        assert march[0] <= s[0] and s[1] <= march[1], n
    (feat,), (heads,) = rng["fine/features"], rng["fine/heads"]
    assert march[1] <= feat[0] and feat[1] <= heads[0]


def test_fine_eval_heads_take_the_eager_path_on_the_cpu(tiny_fine):
    """On the CPU the eval heads run as eager ops, count
    ``eval.heads_eager`` once a call, and keep the outputs' keys, order and
    shapes."""
    _, model, params, b = tiny_fine
    N = b["rays_o"].shape[0]
    out = model.forward_evaluate(params, b["rays_o"], b["rays_d"],
                                 b["viewdirs"], 0, torch.eye(3), S_VAL)
    assert profiling.snapshot()["counters"] == {"eval.heads_eager": 1}
    assert list(out) == [
        "srgb/off_rgb", "lin/off_rgb", "srgb/on_rgb", "lin/on_rgb",
        "srgb/emo_rgb", "lin/emo_rgb", "etc/normal", "etc/depth",
        "etc/disp", "etc/white_bg", "srgb/rgb", "lin/rgb", "etc/overflow"]
    for k in list(out)[:7] + ["srgb/rgb", "lin/rgb"]:
        assert out[k].shape == (N, 3), k
    assert out["etc/depth"].shape == out["etc/disp"].shape == (N,)
    assert out["etc/white_bg"].shape == (N, 1)
    assert out["srgb/rgb"] is out["srgb/off_rgb"]


def test_fused_eval_heads_refuse_other_heads_and_cpu_tensors():
    """The fused heads kernel is built for the fine configuration's bf16
    heads (85 -> 192 x 3 -> 3, tone-mapper 33 -> 192 -> 3): its launcher
    refuses the CPU tests' 32-wide heads, f32 heads and CPU tensors, in
    that order (a CUDA caller gets the kernel or an error, never the eager
    heads)."""
    from esrnerf_tpu_torch.models import mlp as mlpops
    from esrnerf_tpu_torch.ops import kernels

    g = torch.Generator().manual_seed(0)
    head = mlpops.init_mlp(g, [85, 192, 192, 192, 3])
    tm = mlpops.init_mlp(g, [33, 192, 3])
    assert kernels.eval_heads_fit(head, head, tm, 85)
    assert not kernels.eval_heads_fit(head, head, tm, 84)
    assert not kernels.eval_heads_fit(
        head, head, mlpops.init_mlp(g, [34, 192, 3]), 85)
    small = mlpops.init_mlp(g, [85, 32, 3])
    M, z = 4, torch.zeros
    rows = (z(M, 6), z(M, 6), z(M, 79), z(M, 3), z(M),
            z(M, dtype=torch.int64), z(M, dtype=torch.int64), None, 2, 0.5)
    with pytest.raises(ValueError, match="built for"):
        kernels.eval_heads(*rows, small, small, tm)
    with pytest.raises(ValueError, match="float32 heads"):
        kernels.eval_heads(*rows, head, head, tm, None)
    with pytest.raises(ValueError, match="CUDA"):
        kernels.eval_heads(*rows, head, head, tm)


class _Geo:
    def __init__(self):
        self.points_per_ray, self.points_per_ray_masked = 4, 16


class _Renderer:
    def __init__(self):
        self.geo = _Geo()


def test_eval_chunk_retry_counts_chunks_and_retries():
    app = AppClass.__new__(AppClass)
    app.renderer = _Renderer()
    calls = []

    def fwd(x):
        calls.append(app.renderer.geo.points_per_ray)
        ovf = 0.25 if app.renderer.geo.points_per_ray == 4 else 0.0
        return {"etc/overflow": torch.tensor(ovf), "y": x}

    out = app.eval_chunk_retry(fwd, torch.ones(2))
    assert calls == [4, 8] and float(out["etc/overflow"]) == 0.0
    snap = profiling.snapshot()
    assert snap["counters"] == {"eval.chunks": 1, "eval.retries": 1}
    assert snap["spans"]["eval/overflow_wait"]["count"] == 2
    assert not hasattr(app, "_overflow_retries")


def test_host_ms_reads_each_span_since_the_last_read(monkeypatch):
    clock = iter(range(0, 10**9, 10**6))  # 1 ms a reading
    monkeypatch.setattr(profiling, "time", types.SimpleNamespace(
        perf_counter_ns=lambda: next(clock)))
    log = profiling.HostMs()
    for name in ("t/a", "t/a", "t/b"):
        with profiling.span(name):
            pass
    assert log.read() == {"etc/host_ms/t/a": 1.0, "etc/host_ms/t/b": 1.0}
    with profiling.span("t/a"):
        next(clock)
    assert log.read() == {"etc/host_ms/t/a": 2.0}
    assert log.read() == {}
