"""``kind: train`` -- the stage's training loop, closed: each step is
dispatched as soon as the host can, as the trainer's ``learn`` does.

Set-up makes the weights and the ray pool from the seed, builds the stage's
step, and runs its first ``warmup_steps`` steps through the window's own
calls. The first ``check_steps`` of them are the ones the reference follows:
their losses, the first step's gradient (from Adam's first moment after one
step) and the parameters' change after them. The window then runs steps for
``seconds`` (a CUDA event after each step; the host's spans around the
sampler and the placement); a traced run then runs ``trace_steps`` more
under a profiler of host and device activity and ``trace_steps`` more under
one of device activity alone. After the window the program's state is freed and the
reference runs the check steps from the same weights and batches.

Nothing here knows the stage: the configuration's ``stage`` names the
program's adapter (``benchmark/stages/<stage>.py``, its ``Stage``) and the
plain reference (``benchmark/reference/<stage>.py``), which makes the
weights, follows the check steps and counts a step's operations from the
counters the adapter reads off the step. The adapter's ``start_train``
takes the generator's pool and adds any field of the stage's own that its
sampler needs.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List

import torch

from benchmark.harness import compare, core, trace
from benchmark.harness import traffic as gen


def host_copy(tree):
    return {k: host_copy(v) if isinstance(v, dict)
            else v.detach().to("cpu", copy=True)
            for k, v in tree.items()}


@dataclass
class State:
    stage: Any
    reference: Any
    start: dict                       # the weights, on the host
    step: int                         # the next global step
    batches: List[dict] = field(default_factory=list)
    program: Dict[str, Any] = field(default_factory=dict)
    attempted: int = 0
    failed: int = 0


def setup(ctx) -> State:
    """Weights, pool, step, and the warm-up steps with the check steps'
    readings of the program."""
    config, traffic, dev = ctx.cell.config, ctx.cell.traffic, ctx.device
    stage = core.part("stages", config["stage"]).Stage(config, dev,
                                                            ctx.mark)
    reference = core.part("reference", config["stage"])
    first = int(config["first_step"])
    ctx.mark("stage")
    weights = reference.make_weights(config, ctx.seed, dev)
    st = State(stage, reference, host_copy(weights), first)
    ctx.mark("weights")
    pool = gen.train_pool(traffic, ctx.seed, dev)
    ctx.mark("pool")
    stage.start_train(weights, pool, ctx.seed, first)
    del weights, pool
    ctx.mark("step")
    n_check = int(traffic["check_steps"])
    losses = []
    for j in range(int(traffic["warmup_steps"])):
        hb = stage.sample()
        if j < n_check:
            st.batches.append({k: v.copy() for k, v in hb.items()})
        aux = stage.step(st.step, stage.place(hb), fault=ctx.fault)
        if j < n_check:
            losses.append(aux)
        if j == 0:
            st.program["grads"] = stage.grad_norms()
        if j == n_check - 1:
            st.program["change"] = stage.change_norms(st.start)
        stage.after_step(st.step, aux)
        st.step += 1
    st.program["losses"] = [stage.losses(a) for a in losses]
    core.sync(dev)
    ctx.mark("warm-up")
    return st


def window(ctx, st: State) -> core.Run:
    """The measured window and, in a traced run, the traced one after it."""
    stage, traffic, dev = st.stage, ctx.cell.traffic, ctx.device
    rec = core.Run(kind="train", traced=ctx.trace,
                   setup_s=time.perf_counter() - ctx.t0)
    auxes: List = []

    def one_step(events=None):
        t = time.perf_counter()
        with torch.profiler.record_function("bench/sample"):
            hb = stage.sample()
        with torch.profiler.record_function("bench/place"):
            b = stage.place(hb)
        if events is not None:
            rec.data_ms.append((time.perf_counter() - t) * 1e3)
        with torch.profiler.record_function("bench/step"):
            aux = stage.step(st.step, b, fault=ctx.fault)
        if events:
            events.append(torch.cuda.Event(enable_timing=True))
            events[-1].record()
        with torch.profiler.record_function("bench/after_step"):
            stage.after_step(st.step, aux)
        auxes.append(aux)
        st.step += 1

    events = []
    if dev.type == "cuda":
        events.append(torch.cuda.Event(enable_timing=True))
        events[0].record()
    host = core.HostLoad()
    t = time.perf_counter()
    while time.perf_counter() - t < ctx.seconds or not auxes:
        one_step(events)
    core.sync(dev)
    rec.window_s = time.perf_counter() - t
    rec.unit_ms = [a.elapsed_time(b) for a, b in zip(events, events[1:])]
    host.report("window", rec.unit_ms)
    rec.units = len(auxes)
    rec.rays = rec.units * stage.batch_size
    rec.flops = [st.reference.train_flops(ctx.cell.config, stage.counters(a))
                 for a in auxes]
    rec.memory_peak = core.memory_peak(dev)
    if ctx.trace:
        trace.record(rec, one_step, int(traffic["trace_steps"]), dev,
                     ctx.device_cats)
    st.failed = int(sum(int(stage.bad(a)) for a in auxes))
    st.attempted = len(auxes)
    return rec


def reference_readings(ctx, st: State, precision: str = "f32") -> dict:
    """The reference's check steps from the run's weights and batches."""
    ref = st.reference.train_steps(ctx.cell.config, st.start, st.batches,
                                   ctx.device, precision=precision)
    return compare.train_readings(ref, st.start, st.reference.leaves)


def run(ctx) -> dict:
    st = setup(ctx)
    rec = window(ctx, st)
    st.stage.release()
    st.stage = None
    core.free(ctx.device)
    ref = reference_readings(ctx, st)
    compare.report_leaves(st.program, ref)
    checks = compare.train_checks(st.program, ref,
                                  ctx.cell.config["limits"]["train"])
    return {"run": rec, "attempted": st.attempted, "failed": st.failed,
            "memory_peak_bytes": rec.memory_peak, "checks": checks}
