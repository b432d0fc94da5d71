"""``kind: render`` -- a sweep of whole images through the stage's eval
path, chunk by chunk, each chunk's outputs copied to the host.

Set-up makes the weights and the views from the seed and renders
``warmup_chunks`` chunks of the first view and its last (shorter) chunk.
The window then renders the views' chunks in order, round and round, for
``seconds``; a traced run then renders ``trace_chunks`` more under a
profiler of host and device activity and ``trace_chunks`` more under one of
device activity alone. A reservoir drawn from the seed keeps ``sample_chunks``
of the window's chunks that show geometry (some ray's transmittance below
0.99), with their inputs; after the window the program's state is freed and
the reference renders those chunks from the same weights.

The configuration's ``stage`` names the program's adapter and the plain
reference, as for ``kind: train``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark.drivers.train import host_copy
from benchmark.harness import compare, core, trace
from benchmark.harness import traffic as gen


def chunks(views, size: int):
    """``(view, start, end)`` of every chunk of every view, in order, round
    and round."""
    while True:
        for v in views:
            n = v["rays_o"].shape[0]
            for st in range(0, n, size):
                yield v, st, min(st + size, n)


def run(ctx) -> dict:
    config, traffic, dev = ctx.cell.config, ctx.cell.traffic, ctx.device
    stage = core.part("stages", config["stage"]).Stage(config, dev,
                                                            ctx.mark)
    reference = core.part("reference", config["stage"])
    ctx.mark("stage")
    weights = reference.make_weights(config, ctx.seed, dev)
    start = host_copy(weights)
    ctx.mark("weights")
    stage.start_render(weights)
    del weights
    views = gen.render_views(traffic, ctx.seed)
    size = int(config["cfg"]["app"]["eval"]["batch_size"])
    v0, n0 = views[0], views[0]["rays_o"].shape[0]
    ctx.mark("inputs")
    for j in range(int(traffic["warmup_chunks"])):
        stage.render_chunk(v0, j * size, min((j + 1) * size, n0))
    stage.render_chunk(v0, (n0 - 1) // size * size, n0)
    core.sync(dev)
    ctx.mark("warm-up")
    rec = core.Run(kind="render", traced=ctx.trace,
                   setup_s=time.perf_counter() - ctx.t0)

    rng = np.random.default_rng(int(ctx.seed))
    keep_n = int(traffic["sample_chunks"])
    kept, seen, failed, attempted = [], 0, 0, 0

    def one_chunk(src):
        nonlocal seen, failed, attempted
        v, st, en = next(src)
        with torch.profiler.record_function("bench/chunk"):
            out, ovf = stage.render_chunk(v, st, en)
        if ctx.fault == "altered":
            out["srgb/rgb"] = out["srgb/rgb"] + 0.25
        failed += ovf > 0
        attempted += 1
        if float(out["etc/white_bg"].min()) < 0.99:
            # reservoir sampling over the chunks that show geometry
            item = (v, st, en, out)
            if len(kept) < keep_n:
                kept.append(item)
            else:
                k = int(rng.integers(0, seen + 1))
                if k < keep_n:
                    kept[k] = item
            seen += 1
        return en - st

    src = chunks(views, size)
    counts: list = []
    if ctx.trace:
        stage.observe_march(counts)
    host = core.HostLoad()
    stamps = [time.perf_counter()]
    while stamps[-1] - stamps[0] < ctx.seconds or rec.units == 0:
        rec.rays += one_chunk(src)
        rec.units += 1
        stamps.append(time.perf_counter())
    rec.window_s = stamps[-1] - stamps[0]
    # each chunk ends with its outputs on the host: the host clock times it
    rec.unit_ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    host.report("window", rec.unit_ms)
    stage.observe_march(None)
    # every march of the window (a retry after an overflow marches again
    # with doubled budgets)
    rec.flops = [reference.eval_flops(config, stage.march_counters(c))
                 for c in counts]
    rec.memory_peak = core.memory_peak(dev)
    if ctx.trace:
        trace.record(rec, lambda: one_chunk(src), int(traffic["trace_chunks"]),
                     dev, ctx.device_cats)
    stage.release()
    del stage
    core.free(dev)
    if not kept:
        raise RuntimeError("the window rendered no chunk that shows geometry")
    ref = reference.eval_chunks(config, start,
                                [(v, st, en) for v, st, en, _ in kept], dev)
    prog = [out for *_, out in kept]
    ref = [{k: r[k] for k in out} for r, out in zip(ref, prog)]
    checks = compare.render_checks(prog, ref, config["limits"]["render"])
    return {"run": rec, "attempted": attempted, "failed": int(failed),
            "memory_peak_bytes": rec.memory_peak, "checks": checks}
