#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero:

1. device: the card's name and power limit (nvidia-smi), torch and CUDA
   versions;
2. build: compiles the port's CUDA kernels from esrnerf_tpu_torch/csrc
   (one nvcc per source, in parallel) into the git-ignored build directory;
3. kernels: every kernel of the fine step against its plain PyTorch version
   at the fine step's full-width shapes, on inputs from a seeded numpy
   generator, with timings (CUDA events), the least time the card could
   take (bound) and, where one exists, one PyTorch library call computing
   the same function; K-1 bitwise against its plain version, K-2 bitwise
   against the script's own sequential float32 oracle, and the scan's
   cp.async route timed beside its TMA route; and the K-3 row again with
   every value zero (the atomics' share of its time); then H-1, the fused
   fine eval heads, against the eager heads on the same card tensors at
   the render chunk's shapes (262,144 head rows, 9,800 live, 16,384 rays,
   NaN pad rows), within 3e-4 of each sum's largest magnitude, timed at
   9,800 live rows and with every row live;
4. check: one small fine step, one small alphamask step, one small coarse
   step, one small LTS step, one small PDRA step and one small relighting
   fine-tune step on each of its two paths (from the same random draws)
   on the card against the same steps on the CPU (plain versions): loss
   terms, march counters (both marches of the LTS and PDRA steps; the
   fine-tune's cached slots) and every group's gradient; then
   (grad_small) the small fine and coarse steps again with
   app.model.neus_alpha=grad (the march's NeuS alpha from the SDF
   gradient grid sampled at the phase-1 points);
5. train: the fine-stage train step at full width (cfg/app/fine.yaml: 256^3
   = 16,777,216 voxels, 8,192 rays, 192-wide heads; the benchmark's ball
   scene and budgets) through build_fine_train_step, 3 warm-up and 12
   timed steps; asserts overflow 0, finite losses and that every kernel
   launched during the timed steps; then a torch.profiler breakdown of
   three more steps (one with the TV terms, as in training) by phase and
   by kernel, and each kernel's in-step device ms and launches per step;
   then one more step with the K-1..K-4 launch wrappers wrapped here (not
   in the package) to record every launch's inputs and call site, and a
   replay of each captured launch: kernel against plain version (K-3 at
   rtol 5e-4 / atol 5e-5 of the plain result's max, K-4 and K-1 bitwise,
   K-2 bitwise against the oracle), times with the L2 warm and cold, and
   bound; then (grad_train) the same fine step with
   app.model.neus_alpha=grad, 2 warm-up and 10 timed steps, its profile,
   in-step launches (K-1..K-4 each launched, overflow 0) and captured
   launches replayed as above, and five more steps in a span of the
   port's span record, three of them inside its TraceCapture (a Chrome
   trace that must exist), the record's rays/s beside the host clock's
   and the backward's fine/bwd_* ranges in the trace; then
   (dp_train) data parallelism over two spawned ranks (gloo on one card;
   NCCL with a card a rank where there are two): each of the six small
   steps above (the LTS family on the layout-invariant recipe: Fibonacci
   scattering, eps 0, every march slot selected) on the two ranks' halves
   of its batch against the same step on one rank over the whole batch
   (loss terms at rtol 1e-5, each group's gradient within 1e-4 of its
   max), then the full-width fine step on 4,096 rays a rank: the first
   step's all-reduced gradients (f32 heads) within 1e-4 of each group's
   max of the one-device step on all 8,192 rays, the gradient
   all-reduce's ms, 2 warm-up and 5 timed steps with the config's bf16
   heads (overflow 0, finite losses, K-1..K-4 launched on each rank), a
   profile of three more; then the LTS
   train step at full width (cfg/app/lts.yaml, 256^3,
   8,192 rays, 100 LTS points x 256 secondary rays = 25,600; the budgets
   and ball scene of scripts/bench_lts.py) through build_lts_train_step, 2
   warm-up and 10 timed steps: overflow 0 on both marches, finite losses,
   K-1..K-4 launched (by the secondary march too), a profile by the lts/*
   ranges, peak memory, one lts_eval_chunk of 256 surface points (65,536
   secondary rays) timed, and the first step's launches (captured, when
   every cotangent is still alive) replayed as the fine step's; then the
   PDRA train step at full width (cfg/app/pdra.yaml, 256^3, 8,192
   uncertain + 8,192 certain rays, 100 x 256 secondary rays;
   scripts/bench_pdra.py's budgets 160 / 96 masked and 16 / 12 head
   samples) through build_pdra_train_step, 2 warm-up and 10 timed steps
   with the same asserts, profile and peak memory; the regroup sweep
   (eval_emit over 32 chunks of 4,096 rays) in rays/s; the relighting
   fine-tune at full width (march_ray_slots over a 32,768-ray edit pool,
   timed; then steps of 4,096 + 4,096 rays on 16 cached slots a ray) and
   one relight render chunk (8,192 rays, the 24-channel fused gather);
   the first PDRA step's, the first fine-tune step's and the render
   chunk's launches replayed (the fine-tune's 6-channel and the render's
   24-channel gathers among them);
6. gather benchmarks: the two microbenchmark entry points
   (esrnerf_tpu_torch.scripts.bench_gather_grid, K-5, tight and random
   spans; bench_gather_parts, K-6, modes dma, build and full) run in
   process at their full shapes, each launching its kernel; then each
   kernel against its plain version (bitwise; K-6 dma all zeros), timed
   warm and with the L2 cold, beside an empty launch's time (the launch
   floor); K-6 dma's cold time must not fall below 95% of its HBM bound
   (a kernel that skipped its reads would);
7. trainer: the fine stage end to end through esrnerf_tpu_torch.run.main at
   full width: a synthetic 256x256 scene (12 train, 3 test views), a
   coarse-stage checkpoint (64^3 occupancy ball, 96^3 sphere SDF), 24
   steps with progressive scaling from 4.1M voxels to 256^3 at step 8,
   eval with metrics and a 512^3 mesh, checkpoints; a resume to step 28;
   then the test_nv eval of the saved checkpoint. Asserts finite metrics,
   overflow 0, the eval files, the resume step, and the kernels launched
   in train (K-1..K-4) and in eval (K-1, K-4, H-1). Then the LTS stage
   from that fine checkpoint, found by path: 16 steps (the config's
   budgets), eval with the envmap images and the mesh, checkpoint, a
   resume to step 18 and the test_nv eval of the saved checkpoint, with
   the same asserts;
   then (import) that LTS checkpoint rewritten in the reference's layout
   (torch tensors, its key names, a pickled config whose class's module
   is not installed), imported by python -m
   esrnerf_tpu_torch.scripts.import_reference_ckpt, and one LTS eval chunk
   of 4,096 rays from each checkpoint, held bitwise;
   then the PDRA stage from that LTS checkpoint, found by path: 8 steps of
   8,192 + 8,192 rays (the PDRA step's budgets) with regroups at steps 0,
   3 and 7, eval with the emission IoU and the mesh, checkpoint, a resume
   to step 10 and the test_nv eval of the saved checkpoint; then
   test_nvc, test_nvi and test_nvic on one test view each (20 fine-tune
   steps, the relit render). Asserts finite metrics, overflow 0, the
   IoUs, the eval files and the kernels launched; prints each relight
   phase's first and last fine-tune loss (emo_MSE);
8. chain: the stages upstream of fine and fine itself through
   esrnerf_tpu_torch.run.main on another synthetic 256x256 scene, each
   finding the previous stage's checkpoint by path: alphamask at full
   width (cfg/app/alphamask.yaml: 1,024,000 voxels, 8,192 rays; its
   view-count set-up), 1,000 steps, eval and checkpoint; coarse at full
   width (cfg/app/coarse.yaml: 884,736 voxels, 8,192 rays, 128-wide heads)
   with its DVGO-style ray filter, 60 steps, eval with its mesh,
   checkpoint, a resume to step 64 and the test_nv eval of the saved
   checkpoint; then 4 fine steps at 128^3. Per stage: set-up s, median
   synchronised step ms and rays/s, device busy ms and kernel launches
   per step (three more steps, profiled, and three counted), peak memory,
   eval s per image, mesh s, checkpoint s and bytes. Asserts finite
   metrics, coarse overflow 0, the eval files, the resume step, and the
   kernels launched in alphamask train (K-3), coarse train (K-1..K-4) and
   coarse test_nv (K-1, K-4); then one more alphamask and coarse step
   each is captured and replayed as in phase 5;
9. DTU: the two host decoders built in phase 2 (csrc/png_unfilter.cpp,
   csrc/piz.cpp) on a 1200x1200 RGB PNG with rows of all five filter
   types and an 800x800 half PIZ EXR written by the port's writer, each
   read back bitwise, with their seconds beside the plain Python versions'
   (the PNG's rows; the EXR's Huffman chunks); then a DTU-format scan
   (data.synthetic.write_dtu_scene: scan 97, 49 views of 1200x1200, 70.6 M
   training rays, the Chamfer assets) and the chain alphamask -> coarse ->
   fine -> LTS through esrnerf_tpu_torch.run.main with
   cfg/exp/dtu/97/*.yaml at the configs' widths, each stage finding the
   previous checkpoint by path: 1,000, 60, 12 (the grid rescaled to 256^3
   at step 6; phase 7's fine budgets and sharpness) and 6 steps (the
   budget advisor's 256 / 24 primary and 128 / 12 secondary samples a
   ray: the config's 96 secondary phase-1 samples drop samples on this
   scan), each ending with a test_nv eval (N_vis 1: two
   1200x1200 renders), its mesh and, but for alphamask, the Chamfer
   distance (mesh/CD). Per stage: the datasets' load s and the set-up s,
   median step ms, device busy ms and launches per step (three more
   steps, profiled and counted), peak memory, eval s per image, mesh s,
   cd_s, mesh/CD, checkpoint s and bytes. Asserts finite metrics,
   overflow 0 (coarse, fine, LTS primary and secondary), a finite mesh/CD
   in coarse, fine and LTS, the eval files, and the kernels launched in
   each stage's training (alphamask K-3; coarse K-1..K-4 weighted; fine
   and LTS K-1..K-4); then (advisor) python -m
   esrnerf_tpu_torch.scripts.budget_advisor over the DTU LTS stage's
   metrics.jsonl, its lines printed.

Prints one JSON line per phase (each with ``elapsed_s``, the seconds since
the script started), then the kernel table as one JSON object
(``launches``: the fine step's, but H-1's: the trainer phase's test_nv
eval's; ``launches_lts_step``,
``launches_pdra_step``, ``launches_finetune_step``: those steps';
``launches_grad_step``: the grad-alpha fine step's;
``launches_dp_step``: rank 0's in the dp phase's full-width fine step;
``launches_dtu_step``: per step of each DTU stage),
the nvidia-smi line, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

H100_BYTES_PER_S = 3.35e12  # HBM3, NVIDIA data sheet (SXM)
H100_F32_OPS_PER_S = 67e12  # f32 outside the tensor cores
H100_BF16_OPS_PER_S = 989e12  # bf16 on the tensor cores, dense

# full-width fine step (cfg/app/fine.yaml with the benchmark's overrides)
FINE_OVERRIDES = [
    "app.phase=train", "data.cls=esrnerf.ESRNeRF", "data.root=unused",
    "data.scene=unused",
    "app.model.points_budget_masked_per_ray=432",
    "app.model.points_budget_per_ray=16",
    "app.model.phase1_block=8",
]
N_RAYS = 8192
NUM_VOXELS = 256**3

KERNEL_SOURCES = {
    "gather_grid": ("esrnerf_tpu_torch/csrc/gather_bench.cu",
                    "scripts/bench_gather_grid.py:33"),
    "gather_parts": ("esrnerf_tpu_torch/csrc/gather_bench.cu",
                     "scripts/bench_gather_parts.py:34"),
    "scan_fwd": ("esrnerf_tpu_torch/csrc/scan.cu", "esrnerf_tpu/ops/scan.py:41"),
    "scan_bwd": ("esrnerf_tpu_torch/csrc/scan.cu", "esrnerf_tpu/ops/scan.py:59"),
    "splat": ("esrnerf_tpu_torch/csrc/splat.cu", "esrnerf_tpu/ops/splat.py:50"),
    "gather_weighted": ("esrnerf_tpu_torch/csrc/gather.cu",
                        "esrnerf_tpu/ops/splat.py:403"),
    "gather_raw": ("esrnerf_tpu_torch/csrc/gather.cu",
                   "esrnerf_tpu/ops/splat.py:403"),
    "eval_heads": ("esrnerf_tpu_torch/csrc/heads.cu",
                   "none: XLA ops of esrnerf_tpu/models/voxurff.py:"
                   "forward_evaluate"),
}
# H-1 against the eager heads: largest gap of a per-ray sum over the eager
# sum's largest magnitude (read on an H100: <= 7.9e-5; the same exact bf16
# products summed in another order can round an activation the other way)
HEADS_GAP = 3e-4


_T0 = time.perf_counter()


def emit(obj) -> None:
    """Print one JSON line; a phase line also gets the seconds since the
    script started (``elapsed_s``), so the run's time shows by phase."""
    if "phase" in obj:
        obj = {**obj, "elapsed_s": round(time.perf_counter() - _T0, 1)}
    print(json.dumps(obj), flush=True)


def sync(device) -> None:
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)


def time_ms(fn, device, runs: int = 5, calls: int = 10,
            warmup: int = 2) -> float:
    """Median over ``runs`` of the mean time of ``calls`` back-to-back
    calls of ``fn()`` in ms. On the card: CUDA events around the calls,
    after a spin kernel (``torch.cuda._sleep``) that holds the card while
    the host enqueues them, so the events time the device's work and not
    the host's launch cost (as long as the calls fit the launch queue);
    elsewhere the host clock around synchronised calls."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        if device.type == "cuda":
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize(device)
            host_s = time.perf_counter() - t0  # one call, host and device
            # ~2e9 cycles a second at the H100's boost clock; fewer at a
            # lower clock only lengthens the spin
            torch.cuda._sleep(int(min(2e9, (2 * calls * host_s + 1e-3)
                                      * 2e9)))
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            for _ in range(calls):
                fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b) / calls)
        else:
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            times.append((time.perf_counter() - t0) * 1e3 / calls)
    return float(np.median(times))


def time_cold_ms(fn, device, calls: int = 10) -> float:
    """Median device time in ms of one call of ``fn()`` with the L2 cold:
    each of ``calls`` calls follows a 256 MB write that evicts the 50 MB
    L2, with CUDA events around the call alone, behind a spin kernel as in
    ``time_ms``. Elsewhere (no L2 to evict) ``time_ms``."""
    import torch

    if device.type != "cuda":
        return time_ms(fn, device)
    flush = torch.empty(64 << 20, device=device)
    fn()
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    flush.zero_()
    fn()
    torch.cuda.synchronize(device)
    host_s = time.perf_counter() - t0
    torch.cuda._sleep(int(min(2e9, (2 * calls * host_s + 1e-3) * 2e9)))
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(calls)]
    for a, b in ev:
        flush.zero_()
        a.record()
        fn()
        b.record()
    ev[-1][1].synchronize()
    return float(np.median([a.elapsed_time(b) for a, b in ev]))


def bound_ms(n_bytes: float, n_ops: float):
    t_b = n_bytes / H100_BYTES_PER_S * 1e3
    t_o = n_ops / H100_F32_OPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def max_err(a, b) -> float:
    return float((a.double() - b.double()).abs().max())


def assert_close(name, got, want, rtol, atol) -> float:
    import torch

    if not bool(torch.isfinite(got).all()):
        raise AssertionError(f"{name}: non-finite kernel output")
    bad = (got.double() - want.double()).abs() > atol + rtol * want.double().abs()
    if bool(bad.any()):
        raise AssertionError(
            f"{name}: {int(bad.sum())} elements outside rtol={rtol} "
            f"atol={atol}; max abs err {max_err(got, want):.3e}")
    return max_err(got, want)


def assert_splat_close(name, got, want) -> float:
    """K-3 against its plain version on the plain result's own scale:
    rtol 5e-4, atol 5e-5 x max |want|. The step's gradients are 1e-15 to
    1e-5, where a fixed atol would pass a kernel that wrote nothing; an
    all-zero plain result fails too, as it could not tell."""
    scale = float(want.abs().max())
    if not scale > 0.0:
        raise AssertionError(f"{name}: the plain version's result is all zero")
    return assert_close(name, got, want, 5e-4, 5e-5 * scale)


# ------------------------------------------------------------- phase 3


def _scan_inputs(rng, N, S):
    """``[N, S]`` alphas with, per ray, a band of 24 nonzero alphas in
    [0, 0.5) at a random depth (what the fine march's pre-filtered alphas
    look like; the transmittance ends near the 1e-3 early exit), zeros
    elsewhere; and the cotangents of w and last."""
    alpha = np.zeros((N, S), np.float32)
    start = rng.integers(0, max(1, S - 24), N)
    for j in range(24):
        cols = np.minimum(start + j, S - 1)
        alpha[np.arange(N), cols] = rng.uniform(0, 0.5, N)
    ctw = rng.normal(size=(N, S)).astype(np.float32)
    ctl = rng.normal(size=(N,)).astype(np.float32)
    return alpha, ctw, ctl


def scan_fwd_oracle(alpha, ee):
    """K-1 as a sequential float32 loop over the samples, vectorised over
    the rays of ``alpha [N, S]``: ``(w, t_in [N, S], last [N])``."""
    a = np.ascontiguousarray(np.asarray(alpha, np.float32).T)
    ee, one, zero = np.float32(ee), np.float32(1), np.float32(0)
    T = np.ones(a.shape[1], np.float32)
    w, tin = np.empty_like(a), np.empty_like(a)
    for s in range(a.shape[0]):
        a_eff = np.where(T >= ee, a[s], zero)
        tin[s] = T
        w[s] = a_eff * T
        T = T * (one - a_eff)
    return w.T, tin.T, T


def scan_bwd_oracle(alpha, tin, ctw, ctl, ee):
    """K-2 as a sequential float32 loop from the last sample to the first:
    ``d_alpha [N, S]``."""
    a, t, c = (np.ascontiguousarray(np.asarray(x, np.float32).T)
               for x in (alpha, tin, ctw))
    ee, one, zero = np.float32(ee), np.float32(1), np.float32(0)
    d = np.zeros_like(a)
    if a.shape[0] == 0:
        return d.T
    A = (t[-1] * (one - np.where(t[-1] >= ee, a[-1], zero))) * ctl
    for s in range(a.shape[0] - 1, -1, -1):
        live = t[s] >= ee
        a_eff = np.where(live, a[s], zero)
        grad = t[s] * c[s] - A / np.maximum(one - a_eff, np.float32(1e-10))
        d[s] = np.where(live, grad, zero)
        A = A + (a_eff * t[s]) * c[s]
    return d.T


def check_scan_oracle(name, got, want_np, device):
    """``got`` bitwise equal to the oracle's ``want_np`` on the card; the
    CPU's plain versions (carrying cumprod in double, summing the tail as a
    cumsum difference) within rtol 1e-4 / atol 1e-5."""
    import torch

    want = torch.as_tensor(np.ascontiguousarray(want_np), device=got.device)
    if device.type == "cuda":
        return assert_close(name, got, want, 0.0, 0.0)
    return assert_close(name, got, want, 1e-4, 1e-5)


def check_kernels(device, N, S, M1, n_cells, K2, grid_res, seed=0):
    """Each kernel against its plain version at the given shapes. Returns
    the kernel table rows (without launches)."""
    import torch
    import torch.nn.functional as F

    from esrnerf_tpu_torch.ops import kernels
    from esrnerf_tpu_torch.ops import scan as scanops
    from esrnerf_tpu_torch.ops import splat as splatops

    rng = np.random.default_rng(seed)
    on = lambda x: torch.as_tensor(x, device=device)
    rows = []

    def row(name, err, ms, plain_ms, nbytes, nops, lib_ms):
        b, by = bound_ms(nbytes, nops)
        r = {"name": name, "route": "cuda",
             "source": KERNEL_SOURCES[name][0],
             "replaces": KERNEL_SOURCES[name][1], "launches": 0,
             "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
             "bound_ms": b, "bound_by": by, "library_ms": lib_ms}
        rows.append(r)
        emit({"phase": "kernels", **r})

    kern = device.type == "cuda"
    scan_f = kernels.scan_fwd if kern else scanops._fwd_plain
    scan_b = kernels.scan_bwd if kern else scanops._bwd_plain

    # K-1 / K-2: the [N, S] transmittance scan. K-1 bitwise against its
    # plain version (and the oracle), K-2 bitwise against this script's
    # sequential float32 oracle and within rtol 1e-4 / atol 1e-5 of its
    # plain version (a cumsum difference)
    alpha, ctw, ctl = _scan_inputs(rng, N, S)
    a_ns, ctw_ns, ctl_t = on(alpha), on(ctw), on(ctl)
    ee = 1e-3
    w_k, tin_k, last_k = scan_f(a_ns, ee)
    w_p, tin_p, last_p = scanops._fwd_plain(a_ns, ee)
    err = max(assert_close("scan_fwd w", w_k, w_p, 0.0, 0.0),
              assert_close("scan_fwd t_in", tin_k, tin_p, 0.0, 0.0),
              assert_close("scan_fwd last", last_k, last_p, 0.0, 0.0))
    w_o, tin_o, last_o = scan_fwd_oracle(alpha, ee)
    oracle = {"scan_fwd": max(check_scan_oracle(f"scan_fwd {k} oracle", g, o,
                                                device)
                              for k, g, o in (("w", w_k, w_o),
                                              ("t_in", tin_k, tin_o),
                                              ("last", last_k, last_o)))}
    sn = S * N
    row("scan_fwd", err, time_ms(lambda: scan_f(a_ns, ee), device),
        time_ms(lambda: scanops._fwd_plain(a_ns, ee), device),
        4 * (3 * sn + N), 5 * sn, None)
    da_k = scan_b(a_ns, tin_k, ctw_ns, ctl_t, ee)
    da_p = scanops._bwd_plain(a_ns, tin_k, ctw_ns, ctl_t, ee)
    err = assert_close("scan_bwd", da_k, da_p, 1e-4, 1e-5)
    oracle["scan_bwd"] = check_scan_oracle(
        "scan_bwd oracle", da_k,
        scan_bwd_oracle(alpha, tin_o, ctw, ctl, ee), device)
    row("scan_bwd", err,
        time_ms(lambda: scan_b(a_ns, tin_k, ctw_ns, ctl_t, ee), device),
        time_ms(lambda: scanops._bwd_plain(a_ns, tin_k, ctw_ns, ctl_t, ee),
                device),
        4 * (4 * sn + N), 9 * sn, None)
    routes = {}
    if kern:
        # the cp.async route at the same shape: alpha from a base 4 bytes
        # past a 16-byte boundary (S % 4 == 0 and aligned bases take TMA)
        a_off = torch.empty(sn + 1, device=device)[1:].view(N, S)
        a_off.copy_(a_ns)
        cp_f = lambda: kernels.scan_fwd(a_off, ee)
        cp_b = lambda: kernels.scan_bwd(a_off, tin_k, ctw_ns, ctl_t, ee)
        for g, k in zip(cp_f(), (w_k, tin_k, last_k)):
            assert_close("scan_fwd cp.async route", g, k, 0.0, 0.0)
        assert_close("scan_bwd cp.async route", cp_b(), da_k, 0.0, 0.0)
        routes = {"tma": kernels.scan_tma_ok(S, a_ns),
                  "cp_async_route": not kernels.scan_tma_ok(S, a_off),
                  "cp_async_fwd_ms": time_ms(cp_f, device),
                  "cp_async_bwd_ms": time_ms(cp_b, device),
                  "ring_fwd": kernels.scan_config(S, N, False),
                  "ring_bwd": kernels.scan_config(S, N, True)}
    emit({"phase": "scan_checks", "N": N, "S": S, "oracle_max_abs_err": oracle,
          **routes})
    del w_k, tin_k, last_k, w_p, tin_p, last_p, da_k, da_p

    # K-3: the SDF grid gradient (grid_sample_3d's adjoint): 8 corner
    # streams of M1 updates into the full grid
    X = Y = Z = grid_res
    offs = [(d >> 2 & 1) * Y * Z + (d >> 1 & 1) * Z + (d & 1)
            for d in range(8)]
    base = on(np.sort(rng.integers(0, n_cells - max(offs) - 1, M1))
              .astype(np.int32))
    vals = on(rng.normal(size=(8, 1, M1)).astype(np.float32))
    out_k = torch.zeros((n_cells, 1), device=device)
    out_p = torch.zeros((n_cells, 1), device=device)
    splat_k = ((lambda o: kernels.splat(base, vals, offs, o)) if kern
               else (lambda o: splatops._splat_plain(base, vals, offs, o)))
    splat_k(out_k)
    splatops._splat_plain(base, vals, offs, out_p)
    err = assert_close("splat", out_k, out_p, 5e-4, 5e-5)
    idx_all = (base.long()[None, :] + on(np.asarray(offs))[:, None]).reshape(-1)
    vals_all = vals.reshape(-1, 1)
    row("splat", err, time_ms(lambda: splat_k(out_k), device),
        time_ms(lambda: splatops._splat_plain(base, vals, offs, out_p),
                device),
        4 * M1 + 4 * 8 * M1 + 4 * n_cells, 8 * M1,
        time_ms(lambda: out_p.index_add_(0, idx_all, vals_all), device))
    # the atomics' share of that time: with every value an exact zero the
    # launch still reads base and vals and finds the runs, but adds nothing
    zvals = torch.zeros_like(vals)
    splat_z = ((lambda: kernels.splat(base, zvals, offs, out_k)) if kern
               else (lambda: splatops._splat_plain(base, zvals, offs, out_k)))
    emit({"phase": "splat_zero_vals", "ms": rows[-1]["ms"],
          "zero_vals_ms": time_ms(splat_z, device)})
    del zvals

    # K-4 weighted: the fused off/emo color-grid read (C = 12, 8 corners)
    # at the march's cell-sorted points; rows past n_valid are pad
    nv = int(0.1 * K2)
    table = on(rng.normal(size=(n_cells, 12)).astype(np.float32))
    gbase = on(np.sort(rng.integers(0, n_cells - max(offs) - 1, K2))
               .astype(np.int32))
    wts = on(rng.uniform(size=(K2, 8)).astype(np.float32))
    nv_t = torch.tensor(nv, dtype=torch.int32, device=device)
    gw = ((lambda: kernels.gather_weighted(table, gbase, wts, offs, nv_t))
          if kern else (lambda: splatops._gather_plain(
              table, gbase, wts, offs, False, nv_t)))
    gw_p = lambda: splatops._gather_plain(table, gbase, wts, offs, False, nv_t)
    err = assert_close("gather_weighted", gw(), gw_p(), 0.0, 0.0)
    n_live = -(-nv // splatops.GATHER_CHUNK) * splatops.GATHER_CHUNK
    idx_w = torch.clamp(gbase.long()[:, None] + on(np.asarray(offs))[None, :],
                        0, n_cells - 1)
    uniq = int(torch.unique(idx_w[:n_live]).numel())
    row("gather_weighted", err, time_ms(gw, device), time_ms(gw_p, device),
        4 * (n_live * (1 + 8) + uniq * 12 + K2 * 12), 2 * 8 * 12 * n_live,
        time_ms(lambda: F.embedding_bag(idx_w, table, mode="sum",
                                        per_sample_weights=wts), device))

    # K-4 raw: one axis of the displaced SDF taps (4 cross-axis corners x
    # a 6-wide window along z), 24 offsets into the [n_cells, 1] SDF grid
    sdf = on(rng.normal(size=(n_cells, 1)).astype(np.float32))
    roffs = [db * Y * Z + dc * Z + jj for db in (0, 1) for dc in (0, 1)
             for jj in range(6)]
    gr = ((lambda: kernels.gather_raw(sdf, gbase, roffs, nv_t)) if kern
          else (lambda: splatops._gather_plain(sdf, gbase, None, roffs, True,
                                               nv_t)))
    gr_p = lambda: splatops._gather_plain(sdf, gbase, None, roffs, True, nv_t)
    err = assert_close("gather_raw", gr(), gr_p(), 0.0, 0.0)
    idx_r = torch.clamp(gbase.long()[:, None] + on(np.asarray(roffs))[None, :],
                        0, n_cells - 1)
    uniq = int(torch.unique(idx_r[:n_live]).numel())
    row("gather_raw", err, time_ms(gr, device), time_ms(gr_p, device),
        4 * (n_live + uniq + K2 * 24), 0,
        time_ms(lambda: torch.take(sdf, idx_r), device))
    return rows


def check_eval_heads(device, M=262144, n_rays=16384, n_valid=9800, seed=0):
    """H-1 (``kernels.eval_heads``) against the eager heads
    (``VoxurfF._eval_heads_eager``) on the same card tensors at the render
    chunk's shapes: ``M`` head rows (the march's 16-a-ray budget), ``n_rays``
    rays, ``n_valid`` live rows on three quarters of the rays, NaN in the
    pad rows; fine widths, bf16 heads. Every sum within ``HEADS_GAP``, the
    sums of rays without a live row exactly 0. Times both at ``n_valid``
    and the kernel with every row live, against its bound (bf16 tensor
    cores against bytes). Returns its kernel-table row (without
    launches)."""
    import types

    import torch

    from esrnerf_tpu_torch.models.voxurff import EVAL_SUMS
    from esrnerf_tpu_torch.ops import kernels

    _, model = build_fine(device, 32**3, mask_res=16)
    params = model.init_params(torch.Generator(device=device).manual_seed(seed))
    rng = np.random.default_rng(seed)
    on = lambda a: torch.as_tensor(a, device=device)
    live = 3 * n_rays // 4

    def rows(nv):
        ray_id = np.full(M, n_rays, np.int64)
        ray_id[:nv] = rng.integers(0, live, nv)
        step_id = np.zeros(M, np.int64)
        step_id[:nv] = rng.integers(0, 432, nv)
        w = np.zeros(M, np.float32)
        w[:nv] = rng.uniform(0, 1, nv)
        x = [rng.normal(size=(M, c)).astype(np.float32) for c in (79, 6, 6)]
        x.append(rng.uniform(0, 1, (M, 3)).astype(np.float32))
        for a in x:
            a[nv:] = np.nan
        m = types.SimpleNamespace(weights=on(w), ray_id=on(ray_id),
                                  step_id=on(step_id), n_rays=n_rays,
                                  n_valid=on(np.int32(nv)))
        return m, [on(a) for a in x]

    def fused(m, feat, off_gv, emo_gv, nrm):
        return kernels.eval_heads(
            off_gv, emo_gv, feat, nrm, m.weights, m.ray_id, m.step_id,
            m.n_valid, m.n_rays, model.geo.stepdist, params["off_rgbnet"],
            params["emo_rgbnet"], params["tonemapper"])

    m, x = rows(n_valid)
    got = fused(m, *x)
    want = model._eval_heads_eager(params, m, *x)
    gap = 0.0
    for k, g, w in zip(EVAL_SUMS, got, want):
        if not bool(torch.isfinite(g).all()):
            raise AssertionError(f"eval_heads {k}: non-finite")
        if bool(g[live:].any()):
            raise AssertionError(f"eval_heads {k}: a ray without a live row "
                                 f"has a non-zero sum")
        e = float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
        if not e <= HEADS_GAP:
            raise AssertionError(f"eval_heads {k}: gap/max {e:.3e} > "
                                 f"{HEADS_GAP}")
        gap = max(gap, e)
    ms = time_ms(lambda: fused(m, *x), device)
    plain_ms = time_ms(lambda: model._eval_heads_eager(params, m, *x), device)
    m_all, x_all = rows(M)
    all_live_ms = time_ms(lambda: fused(m_all, *x_all), device)

    n_w = sum(v.numel() for k in ("off_rgbnet", "emo_rgbnet", "tonemapper")
              for v in params[k].values())
    mlp_flops = lambda k: 2 * sum(v.numel() for kk, v in params[k].items()
                                  if kk.startswith("w"))
    # both heads on each row, the tone-mapper on off, emo and on
    flops_row = (mlp_flops("off_rgbnet") + mlp_flops("emo_rgbnet")
                 + 3 * mlp_flops("tonemapper"))
    # feat, both grid samples, nrm and the weight in f32; ray and step ids
    bytes_row = 4 * (79 + 2 * 6 + 3 + 1) + 2 * 8

    def bound(nv):
        t_b = (nv * bytes_row + 4 * n_w + 4 * 22 * n_rays) / H100_BYTES_PER_S
        t_o = nv * flops_row / H100_BF16_OPS_PER_S
        return (t_b * 1e3, "bytes") if t_b >= t_o else (t_o * 1e3, "operations")

    b, by = bound(n_valid)
    b_all, by_all = bound(M)
    r = {"name": "eval_heads", "route": "cuda",
         "source": KERNEL_SOURCES["eval_heads"][0],
         "replaces": KERNEL_SOURCES["eval_heads"][1], "launches": 0,
         "max_rel_gap": gap, "rows": M, "live_rows": n_valid,
         "n_rays": n_rays, "ms": ms, "plain_ms": plain_ms, "bound_ms": b,
         "bound_by": by, "all_live_ms": all_live_ms, "all_live_bound_ms": b_all,
         "all_live_bound_by": by_all, "library_ms": None}
    emit({"phase": "kernels", **r})
    return r


# --------------------------------------------------------- phases 4 and 5


def make_batch(seed, n, device):
    """The benchmark's batch generator (bench.py:177-188)."""
    import torch

    r = np.random.default_rng(seed)
    o = r.normal(size=(n, 3)).astype(np.float32)
    o = o / np.linalg.norm(o, axis=-1, keepdims=True) * 2.0
    tgt = r.normal(scale=0.3, size=(n, 3)).astype(np.float32)
    d = (tgt - o).astype(np.float32)
    vd = d / np.linalg.norm(d, axis=-1, keepdims=True)
    b = {"rays_o": o, "rays_d": d, "viewdirs": vd,
         "em_modes": r.integers(0, 2, n),
         "rgbs": r.uniform(0, 1, (n, 3)).astype(np.float32)}
    return {k: torch.as_tensor(v, device=device) for k, v in b.items()}


def build_fine(device, num_voxels, overrides=(), mask_res=64):
    """cfg/app/fine.yaml model on ``device`` over the benchmark's ball
    scene: a radius-0.7 occupancy ball as the previous stage's mask."""
    from esrnerf_tpu_torch.config import load_cfg
    from esrnerf_tpu_torch.models.voxurf_base import make_mask_cache
    from esrnerf_tpu_torch.models.voxurff import VoxurfF

    cfg = load_cfg("cfg/app/fine.yaml", FINE_OVERRIDES + list(overrides),
                   root_dir=REPO)
    g = np.linspace(-1, 1, mask_res)
    xx, yy, zz = np.meshgrid(g, g, g, indexing="ij")
    r = np.sqrt(xx**2 + yy**2 + zz**2)
    density = np.where(r < 0.7, 20.0, -20.0).astype(np.float32)[..., None]
    mc = make_mask_cache(density, [-1, -1, -1], [1, 1, 1], 1e-6, 1e-3, 3,
                         device=device)
    model = VoxurfF(cfg, 0.5, 4.0, [-1, -1, -1], [1, 1, 1], mc, s_val=80.0,
                    num_voxels=num_voxels)
    return cfg, model


def step_args(cfg, i, n_rays):
    """Trainer schedule at step i: TV every tv_every steps, dense TV."""
    tr = cfg.app.trainer
    tv_on = tr.tv_from < i < tr.tv_end and i % tr.tv_every == 0
    return dict(s_val=80.0, lr_scales={k: 1.0 for k in tr.lrs},
                tv_flag=1.0 if tv_on else 0.0,
                smooth_grad_tv=float(tr.tvs["smooth_grad"]),
                sdf_tv_w=float(tr.weight_tv_density * tr.tvs["sdf"] / n_rays),
                tv_dense=i < tr.tv_dense_before)


class _GradsOut:
    """Optimizer stand-in that returns the step's gradients."""

    def step(self, params, grads, state, lr_scales=None, per_lr=None):
        return grads, state


def assert_grads_close(g_c, g_d):
    """Every group's gradient on the card within 1e-4 of the group's
    largest |g| on the CPU; returns the worst ratio."""
    worst = 0.0
    for grp, gc in g_c.items():
        lc = gc if isinstance(gc, dict) else {"": gc}
        ld = g_d[grp] if isinstance(g_d[grp], dict) else {"": g_d[grp]}
        scale = max(float(v.abs().max()) for v in lc.values())
        for k in lc:
            e = float((ld[k].cpu() - lc[k]).abs().max()) / max(scale, 1e-30)
            if not e <= 1e-4:
                raise AssertionError(f"grad {grp}/{k}: err/max|g| {e:.3e}")
            worst = max(worst, e)
    return worst


def check_small_step(device, seed=0, extra=()):
    """One small fine step on ``device`` against the plain versions on the
    CPU: same parameters and batch; loss terms at rtol 1e-4 and each
    group's gradient within 1e-4 of its max |g|. ``extra``: config
    overrides (the march's alpha variant)."""
    import torch

    from esrnerf_tpu_torch.apps.fine import build_fine_train_step

    ov = ["app.model.rgbnet_width=32", "app.model.rgbnet_depth=2",
          "app.model.tonemap_width=32", "system.compute_dtype=float32",
          *extra]
    out = {}
    params_cpu = None
    for dev in (torch.device("cpu"), device):
        cfg, model = build_fine(dev, 32**3, ov, mask_res=16)
        if params_cpu is None:
            params_cpu = model.init_params(torch.Generator().manual_seed(seed))
            rng = np.random.default_rng(seed)
            for g in ("off_color", "emo_color"):
                params_cpu[g] = torch.as_tensor(rng.normal(
                    scale=0.3, size=params_cpu[g].shape).astype(np.float32))
        params = {k: ({kk: vv.to(dev) for kk, vv in v.items()}
                      if isinstance(v, dict) else v.to(dev))
                  for k, v in params_cpu.items()}
        step = build_fine_train_step(model, _GradsOut(), cfg, device=dev)
        a = step_args(cfg, 3, 64)  # a step with the TV terms on
        grads, _, aux = step(params, None, make_batch(seed, 64, dev),
                             a["s_val"], a["lr_scales"], a["tv_flag"],
                             a["smooth_grad_tv"], a["sdf_tv_w"], a["tv_dense"])
        out[dev.type] = (grads, [float(x) for x in aux])
    (g_c, aux_c), (g_d, aux_d) = out["cpu"], out[device.type]
    if aux_c[2:] != aux_d[2:]:
        raise AssertionError(f"march counters differ: {aux_c} vs {aux_d}")
    np.testing.assert_allclose(aux_d[:2], aux_c[:2], rtol=1e-4)
    return {"mse": aux_d[0], "mse_cpu": aux_c[0], "k1_frac": aux_d[3],
            "k2_frac": aux_d[4], "max_grad_err_rel": assert_grads_close(g_c, g_d)}


def _ball_mask_cache(dev, mask_res=16):
    from esrnerf_tpu_torch.models.voxurf_base import make_mask_cache

    g = np.linspace(-1, 1, mask_res)
    xx, yy, zz = np.meshgrid(g, g, g, indexing="ij")
    density = np.where(np.sqrt(xx**2 + yy**2 + zz**2) < 0.7, 20.0, -20.0)
    return make_mask_cache(density.astype(np.float32)[..., None], [-1] * 3,
                           [1] * 3, 1e-6, 1e-3, 3, device=dev)


def check_small_upstream_steps(device, seed=0, coarse_extra=()):
    """One small alphamask step and one small coarse step on ``device``
    against the same steps on the CPU (plain versions), from the same
    parameters, batch and ray shifts: the MSE at rtol 1e-4, the coarse
    march's counters equal, and each group's gradient within 1e-4 of its
    max |g|. ``coarse_extra``: the coarse config's overrides."""
    import torch

    from esrnerf_tpu_torch.apps.alphamask import build_alphamask_train_step
    from esrnerf_tpu_torch.apps.coarse import build_coarse_train_step
    from esrnerf_tpu_torch.config import load_cfg
    from esrnerf_tpu_torch.models.dvgo import DVGO
    from esrnerf_tpu_torch.models.voxurfc import VoxurfC

    rng = np.random.default_rng(seed)
    shift = rng.uniform(size=(64, 1)).astype(np.float32)
    base = ["app.phase=train", "data.cls=x", "data.root=x", "data.scene=x",
            "system.compute_dtype=float32"]
    a_cfg = load_cfg("cfg/app/alphamask.yaml",
                     base + ["app.model.num_voxels=32768"], root_dir=REPO)
    c_cfg = load_cfg("cfg/app/coarse.yaml",
                     base + ["app.model.num_voxels=32768",
                             "app.model.rgbnet_width=32", *coarse_extra],
                     root_dir=REPO)
    out, a_params, c_params = {}, None, None
    for dev in (torch.device("cpu"), device):
        on = lambda tree: {k: ({kk: vv.to(dev) for kk, vv in v.items()}
                               if isinstance(v, dict) else v.to(dev))
                           for k, v in tree.items()}
        dvgo = DVGO(a_cfg, 0.5, 4.0, [-1] * 3, [1] * 3, device=dev)
        vox = VoxurfC(c_cfg, 0.5, 4.0, [-1] * 3, [1] * 3,
                      _ball_mask_cache(dev), s_val=20.0)
        if a_params is None:
            a_params = dvgo.init_params()
            a_params["density"] = torch.as_tensor(rng.normal(
                12.0, 3.0, a_params["density"].shape).astype(np.float32))
            for g in ("off_color", "emo_color"):
                a_params[g] = torch.as_tensor(rng.normal(
                    size=a_params[g].shape).astype(np.float32))
            c_params = vox.init_params(torch.Generator().manual_seed(seed))
            for g in ("off_color", "emo_color"):
                c_params[g] = torch.as_tensor(rng.normal(
                    scale=0.3, size=c_params[g].shape).astype(np.float32))
        batch = make_batch(seed, 64, dev)
        per_lr = {"density": torch.full_like(a_params["density"], 0.5)}
        ga, _, mse_a = build_alphamask_train_step(
            dvgo, _GradsOut(), a_cfg, device=dev)(
            on(a_params), None, batch, 1.0, on(per_lr),
            rand_shift=torch.as_tensor(shift, device=dev))
        gc, _, aux_c = build_coarse_train_step(
            vox, _GradsOut(), c_cfg, device=dev)(
            on(c_params), None, batch, 20.0, {k: 1.0 for k in c_params},
            1.0, 0.1, 0.05)
        out[dev.type] = (ga, float(mse_a), gc, [float(x) for x in aux_c])
    (ga_c, ma_c, gc_c, ac_c), (ga_d, ma_d, gc_d, ac_d) = \
        out["cpu"], out[device.type]
    if ac_c[1:] != ac_d[1:]:
        raise AssertionError(f"coarse march counters differ: {ac_c} vs {ac_d}")
    np.testing.assert_allclose(ma_d, ma_c, rtol=1e-4)
    np.testing.assert_allclose(ac_d[0], ac_c[0], rtol=1e-4)
    return {"alphamask": {"mse": ma_d, "mse_cpu": ma_c,
                          "max_grad_err_rel": assert_grads_close(ga_c, ga_d)},
            "coarse": {"mse": ac_d[0], "mse_cpu": ac_c[0],
                       "k1_frac": ac_d[2], "k2_frac": ac_d[3],
                       "max_grad_err_rel": assert_grads_close(gc_c, gc_d)}}


# the grad-variant NeuS alpha of the march (coarse and fine stages)
GRAD = ["app.model.neus_alpha=grad"]


def check_small_grad_steps(device, seed=0):
    """grad_small: :func:`check_small_step` and the coarse half of
    :func:`check_small_upstream_steps` with ``app.model.neus_alpha=grad``:
    the gradient grid sampled at the phase-1 points, its splat back."""
    return {"fine": check_small_step(device, seed, extra=GRAD),
            "coarse": check_small_upstream_steps(
                device, seed, coarse_extra=GRAD)["coarse"]}


def train_full_width(device, num_voxels, n_rays, warmup=3, timed=12,
                     overrides=(), trace_dir=None):
    """The fine train step at full width (``overrides`` on the config);
    returns its metrics and the launches per kernel over the timed steps.
    With ``trace_dir``, five more steps run in the span ``smoke/step``
    with steps 2-4 traced by ``TraceCapture`` (``system.profile_*``) into
    a Chrome trace there."""
    import torch

    from esrnerf_tpu_torch.apps.fine import build_fine_train_step
    from esrnerf_tpu_torch.ops import kernels
    from esrnerf_tpu_torch.optim import Adam

    t0 = time.perf_counter()
    cfg, model = build_fine(device, num_voxels, overrides)
    gen = torch.Generator(device=device).manual_seed(0)
    params = model.init_params(gen)
    opt = Adam(dict(cfg.app.trainer.lrs))
    state = opt.init(params)
    step = build_fine_train_step(model, opt, cfg, device=device)
    batches = [make_batch(i, n_rays, device) for i in range(4)]
    sync(device)
    setup_s = time.perf_counter() - t0

    def run(i):
        nonlocal params, state
        a = step_args(cfg, i, n_rays)
        params, state, aux = step(params, state, batches[i % 4], a["s_val"],
                                  a["lr_scales"], a["tv_flag"],
                                  a["smooth_grad_tv"], a["sdf_tv_w"],
                                  a["tv_dense"])
        return aux

    t0 = time.perf_counter()
    for i in range(warmup):
        run(i)
    sync(device)
    warm_s = time.perf_counter() - t0

    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    kernels.reset_launches()
    t0 = time.perf_counter()
    auxes = [run(warmup + i) for i in range(timed)]
    sync(device)
    dt = time.perf_counter() - t0
    launches = dict(kernels.launches)

    aux = torch.stack([torch.stack(a) for a in auxes]).cpu().numpy()
    if not np.isfinite(aux).all():
        raise AssertionError(f"non-finite loss terms: {aux}")
    if aux[:, 2].max() != 0.0:
        raise AssertionError(f"march overflow {aux[:, 2].max()} > 0")
    res = {
        "num_voxels": num_voxels, "world_size": list(model.geo.world_size),
        "n_rays": n_rays, "timed_steps": timed,
        "step_ms": dt / timed * 1e3, "rays_per_s": n_rays * timed / dt,
        "setup_s": setup_s, "warmup_s": warm_s,
        "mse_first": float(aux[0, 0]), "mse_last": float(aux[-1, 0]),
        "overflow_max": float(aux[:, 2].max()),
        "k1_frac": float(aux[:, 3].max()), "k2_frac": float(aux[:, 4].max()),
        "launches_per_step": {k: v / timed for k, v in launches.items()},
    }
    if device.type == "cuda":
        res["max_memory_allocated_gb"] = \
            torch.cuda.max_memory_allocated(device) / 2**30
    res["profile"] = prof = profile_steps(device, lambda i: run(99 + i))
    # idle share against the unprofiled step time
    res["idle_share"] = max(0.0, 1 - prof["device_busy_ms_per_step"]
                            / res["step_ms"])
    captured = capture_launches(lambda: run(200))
    sync(device)
    if trace_dir is not None:
        res["trace"] = traced_steps(device, run, n_rays, trace_dir)
    return res, launches, captured


def traced_steps(device, run, n_rays, trace_dir, first=300):
    """Five synchronised steps ``run(first ..)``, each in the span
    ``smoke/step``, steps 2-4 inside a ``TraceCapture`` configured as a
    run's ``system.profile_*`` keys; the trace file must exist and hold
    the backward's four ``fine/bwd_*`` ranges. Returns the span record's
    rays/s beside the host clock's over the same steps, and the trace's
    size."""
    from esrnerf_tpu_torch.utils import profiling

    cap = profiling.TraceCapture({"system": {"profile_dir": trace_dir,
                                             "profile_from": first + 1,
                                             "profile_steps": 3}})
    before = profiling.snapshot()["spans"].get("smoke/step",
                                               {"total_ns": 0})
    t0 = time.perf_counter()
    for i in range(first, first + 5):
        cap.step(i)
        with profiling.span("smoke/step"):
            run(i)
            sync(device)
    host = 5 * n_rays / (time.perf_counter() - t0)
    cap.close()
    span_ns = (profiling.snapshot()["spans"]["smoke/step"]["total_ns"]
               - before["total_ns"])
    if cap.path is None or not os.path.exists(cap.path):
        raise AssertionError(f"TraceCapture wrote no trace in {trace_dir}")
    with open(cap.path) as f:
        events = json.load(f)["traceEvents"]
    names = {e.get("name") for e in events if e.get("ph") == "X"}
    want = {f"fine/bwd_{p}" for p in ("loss", "heads", "features", "march")}
    if not want <= names:
        raise AssertionError(f"ranges {sorted(want - names)} not in "
                             f"{cap.path}")
    return {"trace_bytes": os.path.getsize(cap.path),
            "span_rays_per_s": 5 * n_rays / (span_ns / 1e9),
            "host_rays_per_s": host}


# ------------------------------------------------- the LTS step (phase 5)

# full-width LTS step: cfg/app/lts.yaml with scripts/bench_lts.py's budgets
# (phase 1: 160 masked samples per primary ray, 96 per secondary ray; heads:
# 8 per ray each), 8,192 rays, 100 LTS points x 256 secondary rays
LTS_OVERRIDES = [
    "app.phase=train", "data.cls=esrnerf.ESRNeRF", "data.root=unused",
    "data.scene=unused", f"app.trainer.batch_size={N_RAYS}",
    "app.model.points_budget_masked_per_ray=160",
    "app.model.points_budget_masked_per_2ndray=96",
    "app.model.phase1_block=8",
    "app.model.points_budget_per_ray=8",
    "app.model.points_budget_per_2ndray=8",
]
# bench_lts.py's step arguments: s_val, TV on, smooth-grad TV, SDF TV weight
LTS_S_VAL = 220.0
LTS_TV = dict(tv_flag=1.0, smooth_grad_tv=0.02, sdf_tv_w=1e-4, tv_dense=True)


def build_lts(device, num_voxels, overrides=(), mask_res=64):
    """cfg/app/lts.yaml's ESRNeRF on ``device`` over the benchmark's ball
    scene (a radius-0.7 occupancy ball as the previous stage's mask)."""
    from esrnerf_tpu_torch.config import load_cfg
    from esrnerf_tpu_torch.models.esrnerf import ESRNeRF

    cfg = load_cfg("cfg/app/lts.yaml", LTS_OVERRIDES + list(overrides),
                   root_dir=REPO)
    model = ESRNeRF(cfg, 0.5, 4.0, [-1, -1, -1], [1, 1, 1],
                    _ball_mask_cache(device, mask_res), s_val=LTS_S_VAL,
                    num_voxels=num_voxels)
    return cfg, model


def make_lts_batch(seed, n, device):
    """scripts/bench_lts.py's batch generator (with ``uncert_masks``)."""
    import torch

    r = np.random.default_rng(seed)
    o = r.normal(size=(n, 3)).astype(np.float32)
    o = o / np.linalg.norm(o, axis=-1, keepdims=True) * 2.0
    d = (r.normal(scale=0.3, size=(n, 3)) - o).astype(np.float32)
    vd = d / np.linalg.norm(d, axis=-1, keepdims=True)
    b = {"rays_o": o, "rays_d": d, "viewdirs": vd,
         "em_modes": r.integers(0, 2, n),
         "uncert_masks": r.uniform(size=n) > 0.3,
         "rgbs": r.uniform(0, 1, (n, 3)).astype(np.float32)}
    return {k: torch.as_tensor(v, device=device) for k, v in b.items()}


# the small card-against-CPU steps: 32^3, 32-wide heads, 16 LTS points x 4
# secondary rays, budgets with overflow 0 on the ball
SMALL_ESR = ["app.model.rgbnet_width=32", "app.model.rgbnet_depth=2",
             "app.model.tonemap_width=32", "app.model.brdfnet_width=32",
             "app.model.brdfnet_depth=2", "app.model.num_ltspts=16",
             "app.model.num_2ndrays=4",
             "app.model.points_budget_masked_per_ray=432",
             "app.model.points_budget_per_ray=16",
             "app.model.points_budget_masked_per_2ndray=128",
             "app.model.points_budget_per_2ndray=16",
             "system.compute_dtype=float32"]


def _small_esr_params(model, seed):
    """Seeded CPU parameters with a sphere SDF and random colour and BRDF
    grids (every group gets a gradient)."""
    import torch

    params = model.init_params(torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed)
    X, Y, Z = model.geo.world_size
    x, y, z = np.mgrid[-1:1:X * 1j, -1:1:Y * 1j, -1:1:Z * 1j]
    sdf = np.sqrt(x**2 + y**2 + z**2) - 0.5 + rng.normal(scale=0.03,
                                                        size=x.shape)
    params["sdf"] = torch.as_tensor(sdf.astype(np.float32)[..., None])
    for g in ("off_color", "emo_color", "brdf"):
        params[g] = torch.as_tensor(rng.normal(
            scale=0.3, size=params[g].shape).astype(np.float32))
    return params


def _to(tree, dev):
    return ({k: _to(v, dev) for k, v in tree.items()}
            if isinstance(tree, dict) else tree.to(dev))


def check_small_lts_step(device, seed=0):
    """One small LTS step on ``device`` against the plain versions on the
    CPU: same parameters, batch and random draws; the loss terms at rtol
    1e-4, both marches' counters equal, and each group's gradient within
    1e-4 of its max |g|."""
    import torch

    from esrnerf_tpu_torch.apps.lts import build_lts_train_step
    from esrnerf_tpu_torch.models.esrnerf import LTSDraws

    out, params_cpu, draws_cpu = {}, None, None
    for dev in (torch.device("cpu"), device):
        cfg, model = build_lts(dev, 32**3, SMALL_ESR, mask_res=16)
        if params_cpu is None:
            params_cpu = _small_esr_params(model, seed)
            draws_cpu = model.training_draws(
                torch.Generator().manual_seed(seed + 1), 64 * 16)
        step = build_lts_train_step(model, _GradsOut(), cfg, device=dev)
        grads, _, aux = step(_to(params_cpu, dev), None,
                             make_lts_batch(seed, 64, dev), 40.0,
                             {k: 1.0 for k in params_cpu}, 1.0, 0.05, 1e-4,
                             True, draws=LTSDraws(
                                 *(d.to(dev) for d in draws_cpu)))
        out[dev.type] = (grads, [float(x) for x in aux])
    (g_c, aux_c), (g_d, aux_d) = out["cpu"], out[device.type]
    if aux_c[4:] != aux_d[4:]:
        raise AssertionError(f"LTS march counters differ: {aux_c} vs {aux_d}")
    np.testing.assert_allclose(aux_d[:4], aux_c[:4], rtol=1e-4)
    return {"mse": aux_d[0], "mse_cpu": aux_c[0], "off_mse": aux_d[2],
            "emo_mse": aux_d[3], "overflow": aux_d[4],
            "k1_frac": aux_d[5], "k2_frac": aux_d[6],
            "k1_frac_2nd": aux_d[7], "k2_frac_2nd": aux_d[8],
            "max_grad_err_rel": assert_grads_close(g_c, g_d)}


# kernels the LTS step launches from its secondary march (by shape: that
# march's N = num_ltspts * num_2ndrays rays, its K2 = N * 8 points)
def _secondary_launches(records, n_sec):
    out = {}
    for r in records:
        if r["kernel"] in ("scan_fwd", "scan_bwd"):
            hit = r["alpha"].shape[0] == n_sec
        else:
            hit = "_secondary_radiance" in r["site"]
        if hit:
            out[r["kernel"]] = out.get(r["kernel"], 0) + 1
    return out


def train_lts_full_width(device, num_voxels, n_rays, warmup=2, timed=10):
    """The LTS train step at full width (scripts/bench_lts.py's set-up);
    returns its metrics, the launches per kernel over the timed steps, the
    captured launches of the first warm-up step, and the live model and
    parameters (for the eval chunk)."""
    import torch

    from esrnerf_tpu_torch.apps.lts import build_lts_train_step
    from esrnerf_tpu_torch.ops import kernels
    from esrnerf_tpu_torch.ops.keyed import DrawKey
    from esrnerf_tpu_torch.optim import Adam

    t0 = time.perf_counter()
    cfg, model = build_lts(device, num_voxels)
    params = model.init_params(torch.Generator(device=device).manual_seed(0))
    opt = Adam({k: 1e-2 for k in params})  # bench_lts.py's learning rates
    state = opt.init(params)
    step = build_lts_train_step(model, opt, cfg, device=device)
    batches = [make_lts_batch(i, n_rays, device) for i in range(4)]
    lrs = {k: 1.0 for k in params}
    sync(device)
    setup_s = time.perf_counter() - t0

    def run(i):
        nonlocal params, state
        params, state, aux = step(params, state, batches[i % 4], LTS_S_VAL,
                                  lrs, *LTS_TV.values(), key=DrawKey(1, i))
        return aux

    # the first warm-up step is captured for the launch replay: from the
    # seed-0 weights every gradient is alive (after ~10 Adam steps at the
    # benchmark's lr 1e-2 the emo heads saturate and the secondary
    # march's emo-grid cotangents underflow to exactly 0)
    t0 = time.perf_counter()
    warm = []
    captured = records_to(capture_launches(lambda: warm.append(run(0)),
                                           depth=8), "cpu")  # off the peak
    warm += [run(i) for i in range(1, warmup)]
    sync(device)
    warm_s = time.perf_counter() - t0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    kernels.reset_launches()
    t0 = time.perf_counter()
    auxes = [run(warmup + i) for i in range(timed)]
    sync(device)
    dt = time.perf_counter() - t0
    launches = dict(kernels.launches)

    aux = torch.stack([torch.stack(a) for a in warm + auxes]).cpu().numpy()
    if not np.isfinite(aux).all():
        raise AssertionError(f"non-finite LTS loss terms: {aux}")
    if aux[:, 4].max() != 0.0:
        raise AssertionError(f"LTS march overflow {aux[:, 4].max()} > 0 "
                             "(primary or secondary)")
    n_sec = model.num_ltspts * model.num_2ndrays
    res = {
        "num_voxels": num_voxels, "world_size": list(model.geo.world_size),
        "n_rays": n_rays, "secondary_rays": n_sec, "timed_steps": timed,
        "step_ms": dt / timed * 1e3, "rays_per_s": n_rays * timed / dt,
        "secondary_rays_per_s": n_sec * timed / dt,
        "setup_s": setup_s, "warmup_s": warm_s,
        "mse_first": float(aux[0, 0]), "mse_last": float(aux[-1, 0]),
        "off_mse_last": float(aux[-1, 2]), "emo_mse_last": float(aux[-1, 3]),
        "overflow_max": float(aux[:, 4].max()),
        **{f"{k}_max": float(aux[:, i].max()) for i, k in
           ((5, "k1_frac"), (6, "k2_frac"), (7, "k1_frac_2nd"),
            (8, "k2_frac_2nd"))},
        "launches_per_step": {k: v / timed for k, v in launches.items()},
    }
    if device.type == "cuda":
        res["max_memory_allocated_gb"] = \
            torch.cuda.max_memory_allocated(device) / 2**30
    res["profile"] = prof = profile_steps(device, lambda i: run(99 + i))
    res["idle_share"] = max(0.0, 1 - prof["device_busy_ms_per_step"]
                            / res["step_ms"])
    res["secondary_launches"] = _secondary_launches(captured, n_sec)
    return res, launches, captured, (model, params)


def lts_eval_chunk_timed(device, model, params, chunk=256, seed=0):
    """One ``lts_eval_chunk`` of ``chunk`` surface points (``chunk`` x
    num_2ndrays secondary rays) from an eval forward of the benchmark's
    batch: finite, overflow 0, device ms per call."""
    import torch

    b = make_lts_batch(seed, N_RAYS, device)
    out = model.forward_evaluate(params, b["rays_o"], b["rays_d"],
                                 b["viewdirs"], 1, torch.eye(3, device=device),
                                 LTS_S_VAL, render_pbr=True)
    pp = out["pbr_points"]
    n_live = int((~pp["pad"]).sum())
    if n_live < chunk:
        raise AssertionError(f"{n_live} surface points, want >= {chunk}")
    args = [pp[k][:chunk] for k in ("pts", "viewdirs", "normal", "basecolor",
                                    "roughness", "metallic")]
    gen = torch.Generator(device=device).manual_seed(seed)
    draws = torch.randn((chunk, model.num_2ndrays, 3), generator=gen,
                        device=device)
    fn = lambda: model.lts_eval_chunk(params, draws, *args, LTS_S_VAL)
    res = fn()
    ovf = float(res.pop("etc/overflow"))
    for k, v in res.items():
        if not bool(torch.isfinite(v).all()):
            raise AssertionError(f"lts_eval_chunk {k}: non-finite")
    if ovf != 0.0:
        raise AssertionError(f"lts_eval_chunk secondary overflow {ovf}")
    return {"chunk": chunk, "secondary_rays": chunk * model.num_2ndrays,
            "surface_points": n_live, "overflow": ovf,
            "ms": time_ms(fn, device, runs=3, calls=3),
            "env_dir_mean": float(res["lin/env_dir"].mean())}


# ------------------------------------- the PDRA step and relighting (phase 5)

# full-width PDRA step: cfg/app/pdra.yaml with scripts/bench_pdra.py's
# set-up (phase 1: 160 masked samples per primary ray, 96 per secondary ray;
# heads: 16 and 12), 8,192 uncertain + 8,192 certain rays, 100 LTS points x
# 256 secondary rays
PDRA_BATCH = 8192
PDRA_OVERRIDES = [
    "app.phase=train", "data.cls=esrnerf.ESRNeRF", "data.root=unused",
    "data.scene=unused", f"app.trainer.uncert_batch_size={PDRA_BATCH}",
    f"app.trainer.cert_batch_size={PDRA_BATCH}",
    "app.model.points_budget_masked_per_ray=160",
    "app.model.points_budget_masked_per_2ndray=96",
    "app.model.phase1_block=8",
    "app.model.points_budget_per_ray=16",
    "app.model.points_budget_per_2ndray=12",
]
# the relighting fine-tune at full width: cfg/app/pdra.yaml's eval batches
# (4,096 + 4,096 rays) and cached slots (16 a ray), its eval lrs and weight
FT_BATCH = 4096
FT_PPR = 16
FT_LRS = {"emo_color": 1e-3, "emo_rgbnet": 1e-5}
# the fine-tune's kernels (its secondary march runs without gradients: no
# K-2)
FT_KERNELS = ("scan_fwd", "splat", "gather_weighted", "gather_raw")
FT_WEIGHT = 0.5
def build_pdra(device, num_voxels, overrides=(), mask_res=64):
    """cfg/app/pdra.yaml's ESRNeRF in PDRA mode on ``device`` over the
    benchmark's ball scene."""
    from esrnerf_tpu_torch.config import load_cfg
    from esrnerf_tpu_torch.models.esrnerf import ESRNeRF

    cfg = load_cfg("cfg/app/pdra.yaml", PDRA_OVERRIDES + list(overrides),
                   root_dir=REPO)
    model = ESRNeRF(cfg, 0.5, 4.0, [-1, -1, -1], [1, 1, 1],
                    _ball_mask_cache(device, mask_res), s_val=LTS_S_VAL,
                    num_voxels=num_voxels)
    model.pdra_mode = True
    return cfg, model


def make_pdra_batch(seed, batch, device):
    """scripts/bench_pdra.py's batch: 2 x ``batch`` rays, the first half
    uncertain, as ``RayGroupManager.sample`` concatenates the pools."""
    import torch

    b = make_lts_batch(seed, 2 * batch, device)
    b["uncert_masks"] = torch.arange(2 * batch, device=device) < batch
    return b


def make_ft_batch(seed, n, device):
    """A fine-tune batch: rays as ``make_lts_batch``'s and every edit
    (modes 0-4, intensities, hue and saturation)."""
    import torch

    b = make_lts_batch(seed, n, device)
    r = np.random.default_rng(seed + 1000)
    b["em_modes"] = torch.as_tensor(r.integers(0, 5, n), device=device)
    b["em_intensities"] = torch.as_tensor(
        r.uniform(0.2, 2.0, n).astype(np.float32), device=device)
    b["em_colors"] = torch.as_tensor(
        r.uniform(0, 1, (n, 2)).astype(np.float32), device=device)
    return b


def ft_split(params):
    """The fine-tune's trainable clones and frozen rest (with the
    ``emit_color`` clone of ``emo_color``), as ``PDRA.finetune_radiance``
    makes them."""
    import torch

    from esrnerf_tpu_torch.apps.pdra import FT_GROUPS
    from esrnerf_tpu_torch.optim.adam import tree_map

    frozen = {k: v for k, v in params.items() if k not in FT_GROUPS}
    frozen["emit_color"] = params["emo_color"].clone()
    return {k: tree_map(torch.clone, params[k]) for k in FT_GROUPS}, frozen


def check_small_pdra_step(device, seed=0):
    """One small PDRA step on ``device`` against the plain versions on the
    CPU: same parameters, batch (certain and uncertain rays) and draws;
    the loss terms (off and emo L1s, the emo pair's second half, the
    suppression, the emission smoothness) at rtol 1e-4, both marches'
    counters equal, each group's gradient within 1e-4 of its max |g|."""
    import torch

    from esrnerf_tpu_torch.apps.pdra import build_pdra_train_step
    from esrnerf_tpu_torch.models.esrnerf import LTSDraws

    out, params_cpu, draws_cpu = {}, None, None
    for dev in (torch.device("cpu"), device):
        cfg, model = build_pdra(dev, 32**3, SMALL_ESR, mask_res=16)
        if params_cpu is None:
            params_cpu = _small_esr_params(model, seed)
            draws_cpu = model.training_draws(
                torch.Generator().manual_seed(seed + 1), 64 * 16)
        step = build_pdra_train_step(model, _GradsOut(), cfg, device=dev)
        grads, _, aux = step(_to(params_cpu, dev), None,
                             make_lts_batch(seed, 64, dev), 40.0,
                             {k: 1.0 for k in params_cpu}, 1.0, 0.05, 1e-4,
                             True, draws=LTSDraws(
                                 *(d.to(dev) for d in draws_cpu)))
        out[dev.type] = (grads, [float(x) for x in aux])
    (g_c, aux_c), (g_d, aux_d) = out["cpu"], out[device.type]
    if aux_c[4:9] != aux_d[4:9]:
        raise AssertionError(f"PDRA march counters differ: {aux_c} vs "
                             f"{aux_d}")
    terms = [0, 1, 2, 3, 9, 10, 11]
    np.testing.assert_allclose([aux_d[i] for i in terms],
                               [aux_c[i] for i in terms], rtol=1e-4)
    return {"mse": aux_d[0], "mse_cpu": aux_c[0], "off_l1": aux_d[2],
            "emo_l1": aux_d[3], "emo_r1": aux_d[9], "emit_supp": aux_d[10],
            "emit_smooth": aux_d[11], "overflow": aux_d[4],
            "k1_frac": aux_d[5], "k2_frac": aux_d[6],
            "k1_frac_2nd": aux_d[7], "k2_frac_2nd": aux_d[8],
            "max_grad_err_rel": assert_grads_close(g_c, g_d)}


def check_small_finetune(device, seed=0, ppr=8):
    """One small relighting fine-tune step on ``device`` against the plain
    versions on the CPU, on both of its paths (the per-step march, and
    slots from ``march_ray_slots``: the card's slots equal the CPU's, the
    points at rtol 1e-4 / atol 1e-5): same parameters, batch and draws;
    the loss at rtol 1e-4, the secondary march's overflow equal, the
    ``emo_color`` and ``emo_rgbnet`` gradients within 1e-4 of their max."""
    import torch

    from esrnerf_tpu_torch.apps.pdra import build_finetune_step

    res = {}
    for cached in (False, True):
        out, params_cpu, slots_cpu, draws_cpu = {}, None, None, None
        for dev in (torch.device("cpu"), device):
            _, model = build_pdra(dev, 32**3, SMALL_ESR, mask_res=16)
            b = make_ft_batch(seed, 64, dev)
            if params_cpu is None:
                params_cpu = _small_esr_params(model, seed)
            params = _to(params_cpu, dev)
            ft = {}
            if cached:
                p, ok, (cnt, drop) = model.geo.march_ray_slots(
                    params["sdf"], b["rays_o"], b["rays_d"], b["viewdirs"],
                    40.0, model.fastcolor_thres, model.neus_alpha, ppr)
                if slots_cpu is None:
                    slots_cpu = (p, ok, cnt, drop)
                else:
                    for name, x, y in zip(("valid", "counts", "dropped"),
                                          (ok, cnt, drop), slots_cpu[1:]):
                        if not torch.equal(x.cpu(), y):
                            raise AssertionError(f"march_ray_slots {name} "
                                                 "differs from the CPU's")
                    assert_close("march_ray_slots pts", p.cpu(),
                                 slots_cpu[0], 1e-4, 1e-5)
                ft = {"ft_pts": slots_cpu[0].to(dev),
                      "ft_valid": slots_cpu[1].to(dev)}
            if draws_cpu is None:
                n_rows = 64 * (ppr if cached else model.geo.points_per_ray)
                draws_cpu = model.finetune_draws(
                    torch.Generator().manual_seed(seed + 2), n_rows)
            trainable, frozen = ft_split(params)
            step = build_finetune_step(model, _GradsOut(), FT_WEIGHT)
            grads, _, (loss, ovf) = step(
                trainable, None, frozen, b, 40.0,
                draws=type(draws_cpu)(*(d.to(dev) for d in draws_cpu)), **ft)
            out[dev.type] = (grads, float(loss), float(ovf))
        (g_c, l_c, o_c), (g_d, l_d, o_d) = out["cpu"], out[device.type]
        if o_c != o_d:
            raise AssertionError(f"fine-tune overflow {o_d} vs CPU {o_c}")
        np.testing.assert_allclose(l_d, l_c, rtol=1e-4)
        res["cached" if cached else "march"] = {
            "loss": l_d, "loss_cpu": l_c, "overflow": o_d,
            "max_grad_err_rel": assert_grads_close(g_c, g_d)}
    return res


def regroup_sweep_timed(device, model, params, chunk=4096, n_chunks=32):
    """The regroup's ``eval_emit`` sweep at its 4,096-ray chunks over
    ``n_chunks`` chunks of the benchmark's rays (synchronised host clock):
    rays/s, overflow 0, finite emission, launches per chunk."""
    import torch

    from esrnerf_tpu_torch.ops import kernels

    chunks = [make_lts_batch(100 + i, chunk, device) for i in range(4)]
    args = lambda i: [chunks[i % 4][k] for k in ("rays_o", "rays_d",
                                                  "viewdirs")]
    model.eval_emit(params, *args(0), LTS_S_VAL)  # warm
    sync(device)
    kernels.reset_launches()
    t0 = time.perf_counter()
    outs = [model.eval_emit(params, *args(i), LTS_S_VAL)
            for i in range(n_chunks)]
    sync(device)
    dt = time.perf_counter() - t0
    launches = dict(kernels.launches)
    ovf = max(float(o) for _, o in outs)
    emit = torch.stack([e for e, _ in outs])
    if ovf != 0.0 or not bool(torch.isfinite(emit).all()):
        raise AssertionError(f"regroup sweep: overflow {ovf}, or non-finite")
    return {"chunk": chunk, "chunks": n_chunks, "s": dt,
            "rays_per_s": chunk * n_chunks / dt, "overflow": ovf,
            "emit_max_mean": float(emit.max(-1).values.mean()),
            "launches_per_chunk": {k: v / n_chunks
                                   for k, v in launches.items() if v}}


def finetune_full_width(device, model, params, warmup=2, timed=10,
                        n_pool_chunks=4):
    """The relighting fine-tune step at full width: ``march_ray_slots``
    over an edit pool of 2 x ``n_pool_chunks`` x 4,096 rays (timed: rays
    per s), then fine-tune steps of 4,096 + 4,096 rays on the cached slots
    (16 a ray) with the eval's Adam, 100 LTS points x 256 secondary rays;
    the first step's launches captured, then the timed steps' launches
    and ms. Also one relight render chunk (``forward_evaluate`` with
    ``emit_grid_key="emit_color"``: the 24-channel fused gather) timed and
    captured."""
    import torch

    from esrnerf_tpu_torch.apps.pdra import build_finetune_step
    from esrnerf_tpu_torch.ops import kernels
    from esrnerf_tpu_torch.optim import Adam

    trainable, frozen = ft_split(params)
    pool = [make_ft_batch(300 + i, FT_BATCH, device)
            for i in range(2 * n_pool_chunks)]
    sync(device)
    t0 = time.perf_counter()
    slots = [model.geo.march_ray_slots(
        frozen["sdf"], b["rays_o"], b["rays_d"], b["viewdirs"], LTS_S_VAL,
        model.fastcolor_thres, model.neus_alpha, FT_PPR) for b in pool]
    sync(device)
    slots_s = time.perf_counter() - t0
    counts = torch.cat([c for _, _, (c, _) in slots]).double()
    drops = torch.cat([d for _, _, (_, d) in slots]).double()

    def batch(i):
        u, c = i % n_pool_chunks, n_pool_chunks + i % n_pool_chunks
        b = {k: torch.cat([pool[u][k], pool[c][k]]) for k in pool[u]}
        b["ft_pts"] = torch.cat([slots[u][0], slots[c][0]])
        b["ft_valid"] = torch.cat([slots[u][1], slots[c][1]])
        return b

    batches = [batch(i) for i in range(n_pool_chunks)]
    opt = Adam(FT_LRS)
    state = opt.init(trainable)
    step = build_finetune_step(model, opt, FT_WEIGHT)
    gen = torch.Generator(device=device).manual_seed(2)

    def run(i):
        nonlocal trainable, state
        b = batches[i % n_pool_chunks]
        trainable, state, aux = step(trainable, state, frozen, b, LTS_S_VAL,
                                     generator=gen, ft_pts=b["ft_pts"],
                                     ft_valid=b["ft_valid"])
        return aux

    warm = []
    captured = records_to(capture_launches(lambda: warm.append(run(0)),
                                           depth=8), "cpu")
    warm += [run(i) for i in range(1, warmup)]
    sync(device)
    kernels.reset_launches()
    t0 = time.perf_counter()
    auxes = [run(warmup + i) for i in range(timed)]
    sync(device)
    dt = time.perf_counter() - t0
    launches = dict(kernels.launches)
    aux = torch.stack([torch.stack(a) for a in warm + auxes]).cpu().numpy()
    if not np.isfinite(aux).all() or aux[:, 1].max() != 0.0:
        raise AssertionError(f"fine-tune loss or overflow: {aux}")
    res = {"batch": 2 * FT_BATCH, "ppr": FT_PPR,
           "secondary_rays": model.num_ltspts * model.num_2ndrays,
           "slots_rays": len(pool) * FT_BATCH, "slots_s": slots_s,
           "slots_rays_per_s": len(pool) * FT_BATCH / slots_s,
           "slots_dropped_frac": float(drops.sum() / counts.sum()),
           "step_ms": dt / timed * 1e3, "timed_steps": timed,
           "loss_first": float(aux[0, 0]), "loss_last": float(aux[-1, 0]),
           "launches_per_step": {k: v / timed for k, v in launches.items()}}
    res["profile"] = profile_steps(device, lambda i: run(50 + i))

    # one relight render chunk: the off, emo, BRDF and emit_color grids in
    # one 24-channel gather
    full = {**frozen, **trainable}
    b = make_lts_batch(7, 8192, device)
    eye = torch.eye(3, device=device)
    fwd = lambda: model.forward_evaluate(
        full, b["rays_o"], b["rays_d"], b["viewdirs"], 1, eye, LTS_S_VAL,
        emit_grid_key="emit_color")
    rec = records_to(capture_launches(fwd, depth=8), "cpu")
    out = fwd()
    if float(out["etc/overflow"]) != 0.0 or not bool(
            torch.isfinite(out["lin/rgb"]).all()):
        raise AssertionError("relight render chunk: overflow or non-finite")
    res["relight_chunk"] = {"rays": 8192,
                            "ms": time_ms(fwd, device, runs=3, calls=3)}
    return res, launches, captured, rec


def train_pdra_full_width(device, num_voxels, batch, warmup=2, timed=10,
                          overrides=()):
    """The PDRA train step at full width (scripts/bench_pdra.py's set-up);
    returns its metrics (with the regroup sweep and the fine-tune), the
    launches per kernel over the timed PDRA steps and over the timed
    fine-tune steps, and the captured launches of the first PDRA step, the
    first fine-tune step and one relight render chunk."""
    import torch

    from esrnerf_tpu_torch.apps.pdra import build_pdra_train_step
    from esrnerf_tpu_torch.ops import kernels
    from esrnerf_tpu_torch.ops.keyed import DrawKey
    from esrnerf_tpu_torch.optim import Adam

    t0 = time.perf_counter()
    cfg, model = build_pdra(device, num_voxels, overrides)
    params = model.init_params(torch.Generator(device=device).manual_seed(0))
    opt = Adam({k: 1e-2 for k in params})  # bench_pdra.py's learning rates
    state = opt.init(params)
    step = build_pdra_train_step(model, opt, cfg, device=device)
    batches = [make_pdra_batch(i, batch, device) for i in range(4)]
    lrs = {k: 1.0 for k in params}
    sync(device)
    setup_s = time.perf_counter() - t0

    def run(i):
        nonlocal params, state
        params, state, aux = step(params, state, batches[i % 4], LTS_S_VAL,
                                  lrs, *LTS_TV.values(), key=DrawKey(1, i))
        return aux

    # the first step is captured (every cotangent alive, as in the LTS
    # step)
    t0 = time.perf_counter()
    warm = []
    captured = records_to(capture_launches(lambda: warm.append(run(0)),
                                           depth=8), "cpu")
    warm += [run(i) for i in range(1, warmup)]
    sync(device)
    warm_s = time.perf_counter() - t0
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    kernels.reset_launches()
    t0 = time.perf_counter()
    auxes = [run(warmup + i) for i in range(timed)]
    sync(device)
    dt = time.perf_counter() - t0
    launches = dict(kernels.launches)

    aux = torch.stack([torch.stack(a) for a in warm + auxes]).cpu().numpy()
    if not np.isfinite(aux).all():
        raise AssertionError(f"non-finite PDRA loss terms: {aux}")
    if aux[:, 4].max() != 0.0:
        raise AssertionError(f"PDRA march overflow {aux[:, 4].max()} > 0 "
                             "(primary or secondary)")
    n_sec = model.num_ltspts * model.num_2ndrays
    res = {
        "num_voxels": num_voxels, "world_size": list(model.geo.world_size),
        "n_rays": 2 * batch, "secondary_rays": n_sec, "timed_steps": timed,
        "step_ms": dt / timed * 1e3, "rays_per_s": 2 * batch * timed / dt,
        "setup_s": setup_s, "warmup_s": warm_s,
        "mse_first": float(aux[0, 0]), "mse_last": float(aux[-1, 0]),
        **{f"{k}_last": float(aux[-1, i]) for i, k in
           ((2, "off_l1"), (3, "emo_l1"), (9, "emo_r1"), (10, "emit_supp"),
            (11, "emit_smooth"))},
        "overflow_max": float(aux[:, 4].max()),
        **{f"{k}_max": float(aux[:, i].max()) for i, k in
           ((5, "k1_frac"), (6, "k2_frac"), (7, "k1_frac_2nd"),
            (8, "k2_frac_2nd"))},
        "launches_per_step": {k: v / timed for k, v in launches.items()},
    }
    if device.type == "cuda":
        res["max_memory_allocated_gb"] = \
            torch.cuda.max_memory_allocated(device) / 2**30
    res["profile"] = prof = profile_steps(device, lambda i: run(99 + i))
    res["idle_share"] = max(0.0, 1 - prof["device_busy_ms_per_step"]
                            / res["step_ms"])
    res["secondary_launches"] = _secondary_launches(captured, n_sec)
    # the sweep and the fine-tune from the seed-0 weights: after the steps
    # at lr 1e-2 the emo heads saturate, and the fine-tune's emo-grid
    # cotangents underflow to zeros that no replay could check
    del state, opt, params
    params = model.init_params(torch.Generator(device=device).manual_seed(0))
    res["regroup"] = regroup_sweep_timed(device, model, params)
    ft, ft_launches, ft_captured, relight_captured = finetune_full_width(
        device, model, params)
    res["finetune"] = ft
    return res, launches, ft_launches, (captured, ft_captured,
                                        relight_captured)


# record_function ranges of the stages' train steps (``<stage>/<phase>``)
STAGE_RANGES = ("fine/", "alphamask/", "coarse/", "lts/", "pdra/",
                "relight/", "fsdp/")


def profile_steps(device, run, n=3):
    """Device time by kernel over ``n`` steps (torch.profiler), and by the
    step phases' ``record_function`` ranges."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    sync(device)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(n):
            run(i)
        sync(device)
        wall = time.perf_counter() - t0
    avgs = prof.key_averages()
    attr = ("self_device_time_total"
            if hasattr(avgs[0], "self_device_time_total")
            else "self_cuda_time_total")
    dev_us = lambda e: getattr(e, attr, 0) or 0
    # device-side events only (kernels, memsets, copies): the operator rows
    # carry the same device time again
    ev = sorted((e for e in avgs
                 if str(e.device_type).endswith("CUDA") and dev_us(e) > 0
                 and not e.key.startswith(STAGE_RANGES)),
                key=lambda e: -dev_us(e))
    busy = sum(dev_us(e) for e in ev) / 1e3 / n
    top = [{"name": e.key[:90], "ms_per_step": dev_us(e) / 1e3 / n,
            "calls_per_step": e.count / n} for e in ev[:30]]
    # device time of the kernels launched inside each named step phase
    # (CPU-side ranges; their GPU-side annotation spans are left out)
    phases = {}
    for e in prof.events():
        if (e.name.startswith(STAGE_RANGES)
                and str(e.device_type).endswith("CPU")):
            t = (getattr(e, "device_time_total", None)
                 or getattr(e, "cuda_time_total", 0) or 0)
            ph = phases.setdefault(e.name, {"device_ms": 0.0, "host_ms": 0.0})
            ph["device_ms"] += t / 1e3 / n
            ph["host_ms"] += e.cpu_time_total / 1e3 / n
    from esrnerf_tpu_torch.ops import kernels

    ours = {k: sum(dev_us(e) for e in ev if f"{k}_kernel" in e.key) / 1e3 / n
            for k in kernels.launches}
    return {"wall_ms_per_step_profiled": wall / n * 1e3,
            "device_busy_ms_per_step": busy,
            "device_launches_per_step": sum(e.count for e in ev) / n,
            "phases_ms_per_step": phases,
            "port_kernels_ms_per_step": ours, "top": top}


# ------------------------------------------------- captured step launches

# functions that only pass a launch through: a call site is named by the
# first frame above them
_FUNNELS = {"sorted_streams_splat", "sorted_corner_gather", "trilinear_splat",
            "displaced_taps_splat", "_sorted_trilinear_sample_impl",
            "_displaced_taps_fwd_impl", "scan_forward", "scan_backward",
            "alpha2weights_scan"}
_CAPTURED = ("splat", "gather_weighted", "gather_raw", "scan_fwd",
             "scan_bwd")


def call_site(depth: int = 2) -> str:
    """Up to ``depth`` frames of the port's package that lead to the
    current call, innermost first, leaving out ``ops/kernels.py`` and the
    pass-through functions in ``_FUNNELS``: ``"path:line Qual.name < ..."``.
    A launch from an autograd backward shows the backward's frame."""
    import esrnerf_tpu_torch

    pkg = os.path.dirname(esrnerf_tpu_torch.__file__)
    root = os.path.dirname(pkg)
    f, out = sys._getframe(1), []
    while f is not None and len(out) < depth:
        fn, code = f.f_code.co_filename, f.f_code
        if (fn.startswith(pkg) and not fn.endswith("kernels.py")
                and code.co_name not in _FUNNELS):
            out.append(f"{os.path.relpath(fn, root)}:{f.f_lineno} "
                       f"{code.co_qualname}")
        f = f.f_back
    return " < ".join(out)


def capture_launches(fn, depth=2):
    """Run ``fn()`` with the K-1..K-4 launch wrappers of ``ops/kernels.py``
    wrapped (here only, restored after): each launch records its kernel,
    its call site (``depth`` frames) and clones of its arguments (``out``,
    the splat table accumulated into, only by shape) before it runs."""
    import inspect

    import torch

    from esrnerf_tpu_torch.ops import kernels

    records, orig = [], {n: getattr(kernels, n) for n in _CAPTURED}

    def wrap(name):
        f = orig[name]
        sig = inspect.signature(f)

        def recording(*args, **kwargs):
            a = sig.bind(*args, **kwargs)
            a.apply_defaults()
            rec = {"kernel": name, "site": call_site(depth)}
            for k, v in a.arguments.items():
                if k == "out":
                    rec["out_shape"] = tuple(v.shape)
                elif torch.is_tensor(v):
                    rec[k] = v.detach().clone()
                else:
                    rec[k] = (tuple(int(o) for o in v) if k == "offsets"
                              else v)
            records.append(rec)
            return f(*args, **kwargs)
        return recording

    for n in _CAPTURED:
        setattr(kernels, n, wrap(n))
    try:
        fn()
    finally:
        for n, f in orig.items():
            setattr(kernels, n, f)
    return records


def records_to(records, device):
    """Captured launch records with their tensors moved to ``device``."""
    import torch

    return [{k: v.to(device) if torch.is_tensor(v) else v
             for k, v in r.items()} for r in records]


def replay_launches(records, device):
    """Each captured launch again: the kernel against its plain version on
    the captured inputs (K-3 on a zero table within ``assert_splat_close``,
    K-4 bitwise; the scan's launches in ``replay_scan``), its time (the
    median of 5 runs of 10 back-to-back calls, CUDA events) and the plain
    version's (one run of 10 calls), its time with the L2 cold before each
    call (the step
    meets most tables cold; ``time_cold_ms``), and its bound from the
    captured shapes and n_valid
    (inputs of the live rows read once; the distinct table rows the splat
    adds to written once, the distinct rows the gather reads read once, the
    gather's output written once). Returns one row per launch."""
    import torch

    from esrnerf_tpu_torch.ops import kernels
    from esrnerf_tpu_torch.ops import splat as splatops

    kern = device.type == "cuda"
    rows = []
    for i, r in enumerate(records):
        label = f"{r['kernel']} #{i} {r['site']}"
        if r["kernel"] in ("scan_fwd", "scan_bwd"):
            rows.append(replay_scan(r, label, device))
            continue
        base, offs, nv = r["base"], r["offsets"], r["n_valid"]
        M = base.shape[0]
        n_live = M if nv is None else min(M, int(nv))
        offs_t = torch.as_tensor(offs, device=device)
        if r["kernel"] == "splat":
            vals = r["vals"]
            S, C, _ = vals.shape
            n_cells = r["out_shape"][0]
            zeros = lambda: torch.zeros(r["out_shape"], device=device)
            fn = ((lambda o: kernels.splat(base, vals, offs, o, nv)) if kern
                  else (lambda o: splatops._splat_plain(base, vals, offs, o,
                                                        nv)))
            plain = lambda o: splatops._splat_plain(base, vals, offs, o, nv)
            want = plain(zeros())
            scale = float(want.abs().max())
            err = assert_splat_close(label, fn(zeros()), want)
            del want
            o_k, o_p = zeros(), zeros()
            ms = time_ms(lambda: fn(o_k), device)
            cold_ms = time_cold_ms(lambda: fn(o_k), device)
            plain_ms = time_ms(lambda: plain(o_p), device, runs=1)
            rows_hit = base[:n_live].long()[None, :] + offs_t[:, None]
            rows_hit = rows_hit[(rows_hit >= 0) & (rows_hit < n_cells)]
            uniq = int(torch.unique(rows_hit).numel())
            nbytes = 4 * (n_live + S * C * n_live + C * uniq)
            nops = S * C * n_live
            del o_k, o_p
            # share of live updates that join the run of an earlier lane of
            # their warp (equal base): the atomics the kernel combines away
            b = base[:n_live].long()
            lane0 = torch.arange(n_live, device=device) % 32 == 0
            heads = lane0 | torch.cat([b.new_ones(1, dtype=torch.bool),
                                       b[1:] != b[:-1]])
            extra = {"run_share": 1 - int(heads.sum()) / max(n_live, 1),
                     "scale": scale}
        else:
            table = r["table"]
            R, C = table.shape
            raw = r["kernel"] == "gather_raw"
            w = None if raw else r["weights"]
            S = len(offs)
            if kern:
                fn = ((lambda: kernels.gather_raw(table, base, offs, nv))
                      if raw else (lambda: kernels.gather_weighted(
                          table, base, w, offs, nv)))
            else:
                fn = lambda: splatops._gather_plain(table, base, w, offs, raw,
                                                    nv)
            plain = lambda: splatops._gather_plain(table, base, w, offs, raw,
                                                   nv)
            err = assert_close(label, fn(), plain(), 0.0, 0.0)
            ms, plain_ms = time_ms(fn, device), time_ms(plain, device,
                                                         runs=1)
            cold_ms = time_cold_ms(fn, device)
            if nv is not None:
                g = splatops.GATHER_CHUNK
                n_live = min(M, -(-int(nv) // g) * g)
            idx = torch.clamp(base[:n_live].long()[:, None] + offs_t[None, :],
                              0, R - 1)
            uniq = int(torch.unique(idx).numel())
            out_w = S if raw else C
            nbytes = 4 * (n_live * (1 + (0 if raw else S)) + uniq * C
                          + M * out_w)
            nops = 0 if raw else 2 * S * C * n_live
            extra = {}
        b, by = bound_ms(nbytes, nops)
        row = {"kernel": r["kernel"], "site": r["site"], "S": S, "C": C,
               "M": M, "n_valid": None if nv is None else int(nv),
               "max_abs_err": err, "ms": ms, "cold_ms": cold_ms,
               "plain_ms": plain_ms, "bound_ms": b, "bound_by": by, **extra}
        rows.append(row)
        emit({"phase": "captured", **row})
    return rows


def replay_scan(r, label, device):
    """One captured K-1/K-2 launch again: K-1 bitwise against its plain
    version, K-2 bitwise against this script's oracle and within rtol 1e-4
    / atol 1e-5 of its plain version; its time warm, cold and plain's; and
    its bound from the captured shapes (inputs read once, outputs written
    once). ``S`` is samples per ray and ``M`` rays."""
    from esrnerf_tpu_torch.ops import kernels
    from esrnerf_tpu_torch.ops import scan as scanops

    kern = device.type == "cuda"
    a, ee = r["alpha"], r["early_exit"]
    N, S = a.shape
    sn = N * S
    if r["kernel"] == "scan_fwd":
        fn = ((lambda: kernels.scan_fwd(a, ee)) if kern
              else (lambda: scanops._fwd_plain(a, ee)))
        plain = lambda: scanops._fwd_plain(a, ee)
        err = max(assert_close(f"{label} {k}", g, p, 0.0, 0.0)
                  for k, g, p in zip(("w", "t_in", "last"), fn(), plain()))
        nbytes, nops = 4 * (3 * sn + N), 5 * sn
    else:
        tin, ctw, ctl = r["t_in"], r["ct_w"], r["ct_last"]
        fn = ((lambda: kernels.scan_bwd(a, tin, ctw, ctl, ee)) if kern
              else (lambda: scanops._bwd_plain(a, tin, ctw, ctl, ee)))
        plain = lambda: scanops._bwd_plain(a, tin, ctw, ctl, ee)
        got = fn()
        err = assert_close(label, got, plain(), 1e-4, 1e-5)
        check_scan_oracle(f"{label} oracle", got, scan_bwd_oracle(
            *(x.cpu().numpy() for x in (a, tin, ctw, ctl)), ee), device)
        del got
        nbytes, nops = 4 * (4 * sn + N), 9 * sn
    ms, plain_ms = time_ms(fn, device), time_ms(plain, device, runs=1)
    cold_ms = time_cold_ms(fn, device)
    b, by = bound_ms(nbytes, nops)
    # what the step's data holds that synthetic inputs may not: opaque
    # samples (alpha exactly 1) and zero cotangents
    shares = {"alpha_one_share": float((a == 1).float().mean())}
    if r["kernel"] == "scan_bwd":
        shares["ct_w_zero_share"] = float((ctw == 0).float().mean())
    row = {"kernel": r["kernel"], "site": r["site"], "S": S, "C": 1, "M": N,
           "n_valid": None, "max_abs_err": err, "ms": ms, "cold_ms": cold_ms,
           "plain_ms": plain_ms, "bound_ms": b, "bound_by": by, **shares}
    emit({"phase": "captured", **row})
    return row


# ------------------------------------------------------------- phase 6


def _parts_words(mode, npiece, device):
    """Table words K-6 reads in ``build`` and ``full`` mode (flat index)."""
    import torch

    from esrnerf_tpu_torch.ops import gather_bench as gb

    G = gb.GROUP
    k = torch.arange(gb.K, device=device)[:, None, None, None]
    w = torch.arange(gb.W, device=device)[None, :, None, None]
    g = torch.arange(gb.GROUPS, device=device)[None, None, :, None]
    j = torch.arange(G, device=device)[None, None, None, :]
    r = (3 * j + gb.FAMILY_STRIDE * k - 5).expand(-1, gb.W, gb.GROUPS, -1)
    words = []
    for p in range(npiece):
        t0 = ((13 * p + 7 * g + k) % gb.NCAP_T).expand(-1, gb.W, -1, G)
        base = gb.GCAP * p
        if mode == "full":
            hit = (r >= 0) & (r < gb.GCAP) & (r - G * t0 >= 0) \
                & (r - G * t0 < 2 * G)
            words.append((base + r + w)[hit])
        else:
            x0 = base + G * t0 + j + w
            words += [x0.reshape(-1), (x0 + G).reshape(-1)]
    return torch.cat(words)


def check_gather_bench(device, nch=64, npiece=64):
    """K-5 and K-6 through their entry points' ``main`` (the launch counts
    are read around each call), then each kernel against its plain version
    on the same inputs, bitwise (those launches are not counted), timed
    warm and cold beside the launch floor: an empty launch
    (``torch.cuda._sleep(0)``) timed by the same ``time_ms``. Raises if K-6
    ``dma`` runs cold in less than 95% of its HBM bound. Returns the
    kernel table rows."""
    import torch

    from esrnerf_tpu_torch.ops import gather_bench as gb
    from esrnerf_tpu_torch.ops import kernels
    from esrnerf_tpu_torch.scripts import bench_gather_grid as k5
    from esrnerf_tpu_torch.scripts import bench_gather_parts as k6

    kern = device.type == "cuda"
    dev_arg = ["--device", device.type]
    rows = []
    empty = (lambda: torch.cuda._sleep(0)) if kern else (lambda: None)
    floor_ms = time_ms(empty, device)
    emit({"phase": "gather_bench", "floor_ms": floor_ms,
          "cold_floor_ms": time_cold_ms(empty, device)})

    def row(kernel, variant, launches, err, fn, plain, nbytes):
        b, by = bound_ms(nbytes, 0)
        r = {"name": f"{kernel}_{variant}", "route": "cuda",
             "source": KERNEL_SOURCES[kernel][0],
             "replaces": KERNEL_SOURCES[kernel][1], "launches": launches,
             "max_abs_err": err, "ms": time_ms(fn, device),
             "plain_ms": time_ms(plain, device), "bound_ms": b,
             "bound_by": by, "library_ms": None,
             "cold_ms": time_cold_ms(fn, device), "floor_ms": floor_ms}
        rows.append(r)
        emit({"phase": "gather_bench", **r})
        return r

    for span in ("tight", "random"):
        kernels.reset_launches()
        k5.main(dev_arg + ["--span", span, "--size", str(nch)])
        launches = kernels.launches["gather_grid"]
        a = k5.to_device(k5.make_inputs(span == "tight", nch), device)
        args = (a["idx"], a["w0"], a["gf"], a["gl"])
        flat = a["tbl"].reshape(-1)
        fn = ((lambda: kernels.gather_grid(a["tbl"], *args)) if kern
              else (lambda: gb._gather_grid_plain(flat, *args)))
        plain = lambda: gb._gather_grid_plain(flat, *args)
        err = assert_close(f"gather_grid {span}", fn(), plain(), 0.0, 0.0)
        pos, ok = gb.grid_taps(*args)
        uniq = int(torch.unique(pos[ok.expand_as(pos)]).numel())
        nbytes = 4 * (nch * 24 * 2048 + nch * 2048 + nch * 33 + uniq)
        row("gather_grid", span, launches, err, fn, plain, nbytes)

    tbl = torch.as_tensor(k6.make_table(npiece), device=device)
    flat = tbl.reshape(-1)
    for mode in gb.MODES:
        kernels.reset_launches()
        k6.main(dev_arg + ["--mode", mode, "--size", str(npiece)])
        launches = kernels.launches[f"gather_parts_{mode}"]
        fn = ((lambda: kernels.gather_parts(tbl, mode, npiece)) if kern
              else (lambda: gb._gather_parts_plain(flat, mode, npiece)))
        plain = lambda: gb._gather_parts_plain(flat, mode, npiece)
        err = assert_close(f"gather_parts {mode}", fn(), plain(), 0.0, 0.0)
        out_bytes = 4 * 24 * 2048
        if mode == "dma":
            read = npiece * (gb.NCAP_T + gb.EXT_T) * gb.GROUP
        else:
            read = int(torch.unique(_parts_words(mode, npiece,
                                                 device)).numel())
        r = row("gather_parts", mode, launches, err, fn, plain,
                out_bytes + 4 * read)
        if kern and mode == "dma" and r["cold_ms"] < 0.95 * r["bound_ms"]:
            raise AssertionError(
                f"gather_parts dma: cold {r['cold_ms']:.5f} ms is below 95% "
                f"of its {r['bound_ms']:.5f} ms HBM bound: the table was "
                "not read")
    return rows


# ------------------------------------------------------------- phase 7


def write_coarse_ckpt(path, mask_res=64, coarse_res=96, radius=0.5):
    """A coarse-stage checkpoint in the JAX package's schema: the
    benchmark's occupancy ball (radius 0.7) as the mask density and a
    sphere SDF on the coarse grid of cfg/app/coarse.yaml (96^3 = 884,736
    voxels)."""
    from esrnerf_tpu_torch.utils.checkpoint import save_checkpoint

    def r_grid(n):
        g = np.linspace(-1, 1, n)
        x, y, z = np.meshgrid(g, g, g, indexing="ij")
        return np.sqrt(x**2 + y**2 + z**2)

    lo, hi = np.full(3, -1, np.float32), np.ones(3, np.float32)
    save_checkpoint(path, {
        "renderer": {
            "cfg": {}, "near": 0.5, "far": 6.0, "xyz_min": lo, "xyz_max": hi,
            "s_val": 20.0, "mask_xyz_min": lo, "mask_xyz_max": hi,
            "mask_alpha_init": 1e-6,
            "mask_density": np.where(r_grid(mask_res) < 0.7, 20.0, -20.0)
            .astype(np.float32)[..., None],
            "params": {"sdf": (r_grid(coarse_res) - radius)
                       .astype(np.float32)[..., None]},
        },
        "trainer": {"global_step": 0},
    })
    return path


def _alloc_stats(device):
    """Caching-allocator counters since the last reset: device allocations
    (cudaMalloc), frees and retries after a failed allocation."""
    import torch

    if device.type != "cuda":
        return None
    st = torch.cuda.memory_stats(device)
    return {k: st.get(k, 0) for k in ("num_device_alloc", "num_device_free",
                                       "num_alloc_retries")}


def train_stage(device, work, wh=256, n_train=12, n_test=3,
                num_voxels=NUM_VOXELS, n_rays=N_RAYS, n_iters=24,
                resume_iters=28, pg_step=8, extra=(), mask_res=64,
                coarse_res=96):
    """The fine stage through ``esrnerf_tpu_torch.run.main``: train, resume,
    then the test_nv eval of the saved checkpoint, in ``work``."""
    import torch

    from esrnerf_tpu_torch import run
    from esrnerf_tpu_torch.data.synthetic import write_scene
    from esrnerf_tpu_torch.ops import kernels

    t0 = time.perf_counter()
    write_scene(os.path.join(work, "data"), wh=wh, n_train=n_train,
                n_test=n_test)
    coarse = write_coarse_ckpt(os.path.join(work, "coarse.ckpt"), mask_res,
                               coarse_res)
    setup_s = time.perf_counter() - t0
    cfg = os.path.join(REPO, "cfg/exp/esrnerf/giftbox_w/fine.yaml")
    # s_start 200: the NeuS sharpness that keeps the step's 16-sample head
    # budget per ray (points_budget_per_ray) free of overflow on this scene
    ov = ["-cn", cfg, *FINE_OVERRIDES[1:], f"data.root={work}/data",
          "data.scene=synth_ball", f"log.root={work}/logs", "log.name=smoke",
          "log.offline=true", "system.debug=true",
          # log, and so synchronise, after every step: per-step times
          "system.tqdm_iters=1", f"system.device={device.type}",
          f"app.trainer.num_voxels={num_voxels}",
          f"app.trainer.batch_size={n_rays}",
          f"app.trainer.pg_scale=[{pg_step}]", "app.trainer.save_every=12",
          "app.trainer.vis_every=24", "app.trainer.N_vis=2",
          "app.trainer.s_start=200", f"app.trainer.ckpt={coarse}", *extra]

    def count(args):
        kernels.reset_launches()
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
            torch.cuda.reset_accumulated_memory_stats(device)
        t = time.perf_counter()
        app = run.main(args)
        sync(device)
        return app, dict(kernels.launches), time.perf_counter() - t

    app, train_launches, train_s = count(
        ov + ["app.phase=train", f"app.trainer.n_iters={n_iters}"])
    alloc = _alloc_stats(device)
    peak = (torch.cuda.max_memory_allocated(device) / 2**30
            if device.type == "cuda" else None)
    ld = app.cfg.log["dir"]
    metrics_path = os.path.join(ld, "metrics.jsonl")
    n_first = sum(1 for _ in open(metrics_path))
    app2, _, resume_s = count(
        ov + ["app.phase=train", f"app.trainer.n_iters={resume_iters}"])
    alloc_resume = _alloc_stats(device)
    ckpt = os.path.join(ld, "checkpoints", "last.ckpt")
    app3, eval_launches, eval_s = count(
        ov + ["app.phase=test_nv", f"app.eval.ckpt={ckpt}"])

    rows = [json.loads(ln) for ln in open(metrics_path)]
    for r in rows:
        bad = [k for k, v in r.items() if not np.isfinite(v)]
        if bad:
            raise AssertionError(f"non-finite metrics at step {r['step']}: "
                                 f"{bad}")
    train = [r for r in rows if "train/metric/srgb/MSE" in r]
    if [r["step"] for r in train] != list(range(resume_iters)):
        raise AssertionError(f"train steps logged: {[r['step'] for r in train]}")
    if rows[n_first]["step"] != n_iters:
        raise AssertionError("the resumed run did not start at step "
                             f"{n_iters}")
    ovf = max(r["train/metric/etc/overflow"] for r in train)
    if ovf != 0.0:
        raise AssertionError(f"train march overflow {ovf} > 0")
    evals = [r for r in rows if "test_nv/metric/srgb/PSNR" in r]
    if len(evals) != 2:
        raise AssertionError(f"{len(evals)} eval rows in training, want 2")
    ld3 = app3.cfg.log["dir"]
    evals += [json.loads(ln) for ln in
              open(os.path.join(ld3, "metrics.jsonl"))]
    for d, step in ((ld, n_iters - 1), (ld, resume_iters - 1),
                    (ld3, resume_iters - 1)):
        mean = open(os.path.join(d, "text", f"{step:010}", "mean.txt")).read()
        for key in ("srgb/PSNR", "srgb/SSIM", "srgb/LPIPS_ALEX"):
            if key not in mean:
                raise AssertionError(f"{d} mean.txt at step {step} lacks {key}")
        with open(os.path.join(d, "mesh", f"{step:010}", "mesh.ply"),
                  "rb") as f:
            head = f.read(200).decode("latin1")
        if int(head.split("element vertex ")[1].split()[0]) <= 0:
            raise AssertionError(f"{d}: empty mesh at step {step}")
    if not np.isfinite(evals[-1]["test_nv/metric/srgb/PSNR"]):
        raise AssertionError(f"test_nv metrics: {evals[-1]}")
    missing = ([k for k in ("scan_fwd", "scan_bwd", "splat",
                            "gather_weighted", "gather_raw")
                if train_launches[k] == 0]
               + [f"eval {k}" for k in ("scan_fwd", "gather_weighted",
                                        "gather_raw", "eval_heads")
                  if eval_launches[k] == 0])
    if missing and device.type == "cuda":
        raise AssertionError(f"kernels not launched by the trainer: {missing}")

    # per-step times at the full grid, leaving out the first step after
    # the rescale, the steps after an eval or checkpoint, and the first
    # step of the resumed run; TV steps (every tv_every-th) do more work
    skip = {pg_step, n_iters} | {k + 1 for k in range(resume_iters)
                                 if k % 12 == 11}
    tv_every = int(app.cfg.app.trainer.tv_every)

    def step_ms(first_run, tv):
        return [r["train/metric/etc/sec_per_step"] * 1e3 for r in train
                if r["train/metric/etc/num_voxels"] == num_voxels
                and r["step"] not in skip
                and (r["step"] < n_iters) == first_run
                and (r["step"] % tv_every == 0) == tv]

    return {
        "scene": {"wh": wh, "n_train": n_train, "n_test": n_test},
        "num_voxels": num_voxels, "n_rays": n_rays,
        "world_size": list(app.renderer.geo.world_size),
        "setup_s": setup_s, "train_s": train_s, "resume_s": resume_s,
        "test_nv_s": eval_s,
        "median_step_ms_full_grid": float(np.median(
            [t for run in (True, False) for tv in (True, False)
             for t in step_ms(run, tv)])),
        "step_ms_full_grid": {
            f"{run}_{kind}": step_ms(run == "train", kind == "tv")
            for run in ("train", "resumed") for kind in ("tv", "no_tv")},
        "allocator_train": alloc, "allocator_resumed": alloc_resume,
        "eval_s_per_image": app3.timings["eval_s_per_image"],
        "mesh_s": app3.timings["mesh_s"],
        "mesh_verts": app3.timings["mesh_verts"],
        "ckpt_s": app2.timings["ckpt_s"],
        "ckpt_bytes": app2.timings["ckpt_bytes"],
        "train_peak_memory_gb": peak,
        "k1_frac_max": max(r["train/metric/etc/k1_frac"] for r in train),
        "k2_frac_max": max(r["train/metric/etc/k2_frac"] for r in train),
        "mse_first": train[0]["train/metric/srgb/MSE"],
        "mse_last": train[-1]["train/metric/srgb/MSE"],
        "test_nv": {k.split("/metric/")[1]: v for k, v in evals[-1].items()
                    if "/metric/" in k},
        "launches_train": train_launches, "launches_test_nv": eval_launches,
    }


def counted_run(device, args):
    """``esrnerf_tpu_torch.run.main(args)`` with the launch counts and the
    peak memory reset before it: ``(app, launches, seconds, peak GiB)``."""
    import torch

    from esrnerf_tpu_torch import run
    from esrnerf_tpu_torch.ops import kernels

    kernels.reset_launches()
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    t = time.perf_counter()
    app = run.main(args)
    sync(device)
    peak = (torch.cuda.max_memory_allocated(device) / 2**30
            if device.type == "cuda" else None)
    return app, dict(kernels.launches), time.perf_counter() - t, peak


LTS_TRAIN_KERNELS = ("scan_fwd", "scan_bwd", "splat", "gather_weighted",
                     "gather_raw")
LTS_EVAL_KERNELS = ("scan_fwd", "gather_weighted", "gather_raw")


def lts_stage(device, work, n_rays=N_RAYS, n_iters=16, resume_iters=18,
              extra=()):
    """The LTS stage through ``esrnerf_tpu_torch.run.main`` in ``work``,
    after ``train_stage``: it finds that fine run's checkpoint by path (the
    same ``log.root`` and ``log.name``), trains ``n_iters`` steps, evals
    (``N_vis`` 1: renders, the envmap images, the mesh) and checkpoints,
    resumes to ``resume_iters``, then evaluates the saved checkpoint
    (test_nv)."""
    ov = ["-cn", os.path.join(REPO, "cfg/exp/esrnerf/giftbox_w/lts.yaml"),
          f"data.root={work}/data", "data.scene=synth_ball",
          f"log.root={work}/logs", "log.name=smoke", "log.offline=true",
          "system.debug=true", "system.tqdm_iters=1",
          f"system.device={device.type}", f"app.trainer.batch_size={n_rays}",
          "app.trainer.N_vis=1", *extra]

    count = lambda args: counted_run(device, args)

    train = lambda n: ov + ["app.phase=train", f"app.trainer.n_iters={n}",
                            f"app.trainer.save_every={n}",
                            f"app.trainer.vis_every={n}"]
    app, launches, train_s, peak = count(train(n_iters))
    ld = app.cfg.log["dir"]
    n_first = len(_stage_rows(app))
    app2, _, resume_s, _ = count(train(resume_iters))
    if app2.global_step != resume_iters - 1:
        raise AssertionError(f"LTS resume ended at {app2.global_step}")
    ckpt = os.path.join(ld, "checkpoints", "last.ckpt")
    app3, ev_launches, test_nv_s, _ = count(
        ov + ["app.phase=test_nv", f"app.eval.ckpt={ckpt}"])

    rows = _stage_rows(app2)
    train_rows = [r for r in rows if "train/metric/srgb/MSE" in r]
    if [r["step"] for r in train_rows] != list(range(resume_iters)):
        raise AssertionError(
            f"LTS steps logged: {[r['step'] for r in train_rows]}")
    if rows[n_first]["step"] != n_iters:
        raise AssertionError(f"the resumed LTS run did not start at {n_iters}")
    ovf = max(r["train/metric/etc/overflow"] for r in train_rows)
    if ovf != 0.0:
        raise AssertionError(f"LTS train march overflow {ovf} > 0")
    for a, step in ((app, n_iters - 1), (app2, resume_iters - 1),
                    (app3, resume_iters - 1)):
        _assert_eval_files(a, step, mesh=True)
        for name in ("envmap.png", "envmap_gamma.png"):
            path = os.path.join(a.cfg.log["dir"], "image", f"{step:010}",
                                "etc", name)
            if not os.path.getsize(path):
                raise AssertionError(f"empty {path}")
    missing = ([k for k in LTS_TRAIN_KERNELS if launches[k] == 0]
               + [f"test_nv {k}" for k in LTS_EVAL_KERNELS
                  if ev_launches[k] == 0])
    if missing and device.type == "cuda":
        raise AssertionError(f"kernels not launched by the LTS stage: "
                             f"{missing}")
    # synchronised steps (logged every step) but the first of each run
    steps = [r["train/metric/etc/sec_per_step"] * 1e3 for r in train_rows
             if r["step"] not in (0, n_iters)]
    ev = _stage_rows(app3)[-1]
    return {
        "ckpt": ckpt,
        "n_rays": n_rays, "world_size": list(app.renderer.geo.world_size),
        "setup_s": app.timings["setup_s"], "train_s": train_s,
        "resume_s": resume_s, "test_nv_s": test_nv_s,
        "median_step_ms": float(np.median(steps)), "step_ms": steps,
        "eval_s_per_image": app3.timings["eval_s_per_image"],
        "mesh_s": app3.timings["mesh_s"],
        "mesh_verts": app3.timings["mesh_verts"],
        "ckpt_s": app2.timings["ckpt_s"],
        "ckpt_bytes": app2.timings["ckpt_bytes"],
        "train_peak_memory_gb": peak,
        "mse_first": train_rows[0]["train/metric/srgb/MSE"],
        "mse_last": train_rows[-1]["train/metric/srgb/MSE"],
        **{f"{k}_max": max(r[f"train/metric/etc/{k}"] for r in train_rows)
           for k in ("k1_frac", "k2_frac", "k1_frac_2nd", "k2_frac_2nd")},
        "test_nv": {k.split("/metric/")[1]: v for k, v in ev.items()
                    if "/metric/" in k},
        "launches_train": {k: v for k, v in launches.items() if v},
        "launches_test_nv": {k: v for k, v in ev_launches.items() if v},
    }


def save_with_absent_cfg_class(obj, path):
    """``torch.save(obj)`` with ``obj["renderer"]["cfg"]`` an instance of
    ``omegaconf.dictconfig.DictConfig`` from modules that exist only while
    it saves: a reference checkpoint as read where Hydra's ``omegaconf`` is
    not installed."""
    import types

    import torch

    mod = types.ModuleType("omegaconf.dictconfig")
    mod.DictConfig = type("DictConfig", (), {"__module__": mod.__name__})
    cfg = mod.DictConfig()
    cfg.__dict__["_content"] = {"app": {"cls": "fine.LTS"}}
    obj["renderer"]["cfg"] = cfg
    sys.modules.update({"omegaconf": types.ModuleType("omegaconf"),
                        "omegaconf.dictconfig": mod})
    try:
        torch.save(obj, path)
    finally:
        del sys.modules["omegaconf"], sys.modules["omegaconf.dictconfig"]


def import_reference(device, work, ckpt, n_rays=4096, extra=()):
    """The LTS checkpoint ``ckpt`` rewritten in the reference's layout
    (``[1, C, X, Y, Z]`` grids, ``[out, in]`` Linear weights, the
    reference's key names, torch tensors, a pickled config whose class's
    module is not installed) under a ``fine.LTS`` path, imported by
    ``python -m esrnerf_tpu_torch.scripts.import_reference_ckpt`` (kind
    from the path), then one LTS eval chunk (``n_rays`` rays with the PBR
    decomposition) from each checkpoint through the LTS stage's eval
    model: every output bitwise equal (deterministic algorithms on, so the
    per-ray ``index_add`` sums in one order)."""
    import torch

    from esrnerf_tpu_torch.apps.lts import LTS
    from esrnerf_tpu_torch.config import customize_cfg, load_cfg
    from esrnerf_tpu_torch.utils import checkpoint as ckpt_io
    from esrnerf_tpu_torch.utils.import_torch_ckpt import \
        reference_state_dict

    payload = ckpt_io.load_checkpoint(ckpt)
    r, t = payload["renderer"], payload["trainer"]
    T = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    ref = {"renderer": {
        "near": r["near"], "far": r["far"], "xyz_min": T(r["xyz_min"]),
        "xyz_max": T(r["xyz_max"]),
        "s_val": torch.tensor(r["s_val"], dtype=torch.float64),
        "num_voxels": r["num_voxels"],
        "mask_density": T(np.moveaxis(r["mask_density"], -1, 0)[None]),
        "mask_xyz_min": T(r["mask_xyz_min"]),
        "mask_xyz_max": T(r["mask_xyz_max"]),
        "mask_alpha_init": r["mask_alpha_init"],
        "params": {k: T(v) for k, v in
                   reference_state_dict(r["params"], "esrnerf").items()}},
        "trainer": {"global_step": t["global_step"]}}
    src = os.path.join(work, "reference", "fine.LTS", "last.ckpt")
    dst = os.path.join(work, "imported", "last.ckpt")
    os.makedirs(os.path.dirname(src))
    save_with_absent_cfg_class(ref, src)
    t0 = time.perf_counter()
    cmd = [sys.executable, "-m",
           "esrnerf_tpu_torch.scripts.import_reference_ckpt", src, dst]
    proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600,
                          cwd=REPO, env={**os.environ, "PYTHONPATH": REPO})
    import_s = time.perf_counter() - t0
    if proc.returncode != 0 or "kind=esrnerf" not in proc.stdout:
        raise AssertionError(f"import_reference_ckpt failed ({proc.returncode})"
                             f": {proc.stdout[-1000:]} {proc.stderr[-2000:]}")

    b = make_batch(0, n_rays, device)
    outs = []
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        for path in (ckpt, dst):
            cfg = customize_cfg(load_cfg(
                os.path.join(REPO, "cfg/exp/esrnerf/giftbox_w/lts.yaml"),
                ["app.phase=test_nv", f"app.eval.ckpt={path}",
                 f"data.root={work}/data", "data.scene=synth_ball",
                 f"log.root={work}/logs", "log.name=import",
                 "log.offline=true", f"system.device={device.type}",
                 *extra], root_dir=REPO))
            app = LTS(cfg)
            app.load_model()
            with torch.no_grad():
                out = app._eval_chunk(b["rays_o"], b["rays_d"],
                                      b["viewdirs"], 1,
                                      torch.eye(3, device=device),
                                      float(app.renderer.s_val))
            outs.append({k: v.cpu() for k, v in out.items()})
            del app
    finally:
        torch.use_deterministic_algorithms(False)
    orig, imp = outs
    if orig.keys() != imp.keys():
        raise AssertionError(f"eval keys {sorted(orig)} vs {sorted(imp)}")
    differ = [k for k in orig if not torch.equal(orig[k], imp[k])]
    if differ:
        raise AssertionError(f"imported checkpoint's eval differs: {differ}")
    hit = float((orig["etc/white_bg"] < 0.5).float().mean())
    if not hit > 0:
        raise AssertionError("the eval chunk hit no surface")
    return {"reference_bytes": os.path.getsize(src),
            "imported_bytes": os.path.getsize(dst), "import_s": import_s,
            "stdout": proc.stdout.strip().splitlines()[-1],
            "eval_rays": n_rays, "eval_keys": len(orig), "hit_share": hit,
            "bitwise": True}


def advise(work, stage_cls="fine.LTS"):
    """``python -m esrnerf_tpu_torch.scripts.budget_advisor`` over the log
    dirs of ``stage_cls`` under ``work``: its printed lines."""
    logs = [d for d, _, fs in os.walk(work)
            if "metrics.jsonl" in fs and stage_cls in d]
    if not logs:
        raise AssertionError(f"no {stage_cls} metrics.jsonl under {work}")
    proc = subprocess.run(
        [sys.executable, "-m", "esrnerf_tpu_torch.scripts.budget_advisor",
         *logs], capture_output=True, text=True, timeout=300, cwd=REPO,
        env={**os.environ, "PYTHONPATH": REPO})
    lines = [ln for ln in proc.stdout.splitlines() if ln.strip()]
    if proc.returncode != 0 or not any("k1_frac_2nd" in ln for ln in lines):
        raise AssertionError(f"budget_advisor failed ({proc.returncode}): "
                             f"{proc.stdout[-1000:]} {proc.stderr[-1000:]}")
    return {"logs": [os.path.relpath(d, work) for d in logs],
            "lines": lines}


PDRA_TRAIN_KERNELS = LTS_TRAIN_KERNELS
RELIGHT_KERNELS = FT_KERNELS
RELIGHT_PHASES = ("test_nvc", "test_nvi", "test_nvic")


def _keep_first_frame(work, phase):
    """Cut the scene's ``transforms_<phase>.json`` to its first view."""
    path = os.path.join(work, "data", "synth_ball", "transforms",
                        f"transforms_{phase}.json")
    with open(path) as f:
        t = json.load(f)
    t["frames"] = t["frames"][:1]
    with open(path, "w") as f:
        json.dump(t, f)


def pdra_stage(device, work, batch=PDRA_BATCH, n_iters=8, resume_iters=10,
               group_interval=4, ft_iters=20, extra=()):
    """The PDRA stage through ``esrnerf_tpu_torch.run.main`` in ``work``,
    after ``lts_stage``: it finds that LTS run's checkpoint by path, regroups
    at step 0 and every ``group_interval`` steps, trains ``n_iters`` steps
    of ``batch`` + ``batch`` rays, evals test_nv with the emission IoU
    (``N_vis`` 1) and checkpoints, resumes to ``resume_iters``, evaluates
    the saved checkpoint (test_nv), then runs the three relighting phases
    on one test view each (``ft_iters`` fine-tune steps, then the relit
    render)."""
    ov = ["-cn", os.path.join(REPO, "cfg/exp/esrnerf/giftbox_w/pdra.yaml"),
          f"data.root={work}/data", "data.scene=synth_ball",
          f"log.root={work}/logs", "log.name=smoke", "log.offline=true",
          "system.debug=true", "system.tqdm_iters=1",
          f"system.device={device.type}",
          f"app.trainer.uncert_batch_size={batch}",
          f"app.trainer.cert_batch_size={batch}",
          f"app.trainer.group_interval={group_interval}",
          "app.trainer.N_vis=1", f"app.eval.n_iters={ft_iters}",
          # scripts/bench_pdra.py's budgets: the configs' 64 head samples a
          # primary ray use 8% of them on this scene (LTS stage)
          *PDRA_OVERRIDES[6:], *extra]

    count = lambda args: counted_run(device, args)

    train = lambda n: ov + ["app.phase=train", f"app.trainer.n_iters={n}",
                            f"app.trainer.save_every={n}",
                            f"app.trainer.vis_every={n}"]
    app, launches, train_s, peak = count(train(n_iters))
    ld = app.cfg.log["dir"]
    n_first = len(_stage_rows(app))
    app2, _, resume_s, _ = count(train(resume_iters))
    if app2.global_step != resume_iters - 1:
        raise AssertionError(f"PDRA resume ended at {app2.global_step}")
    ckpt = os.path.join(ld, "checkpoints", "last.ckpt")
    app3, ev_launches, test_nv_s, _ = count(
        ov + ["app.phase=test_nv", f"app.eval.ckpt={ckpt}"])

    rows = _stage_rows(app2)
    train_rows = [r for r in rows if "train/metric/srgb/MSE" in r]
    if [r["step"] for r in train_rows] != list(range(resume_iters)):
        raise AssertionError(
            f"PDRA steps logged: {[r['step'] for r in train_rows]}")
    if rows[n_first]["step"] != n_iters:
        raise AssertionError(f"the resumed PDRA run did not start at "
                             f"{n_iters}")
    regroups = [r for r in rows if "train/metric/etc/k_val" in r]
    if len(regroups) < 3:
        raise AssertionError(f"{len(regroups)} regroups, want >= 3")
    ovf = max(r["train/metric/etc/overflow"] for r in train_rows)
    if ovf != 0.0:
        raise AssertionError(f"PDRA train march overflow {ovf} > 0")
    ious = [r["test_nv/metric/etc/IoU"] for r in rows + _stage_rows(app3)
            if "test_nv/metric/etc/IoU" in r]
    if len(ious) != 3 or not all(0.0 <= v <= 1.0 for v in ious):
        raise AssertionError(f"test_nv IoUs: {ious}")
    for a, step in ((app, n_iters - 1), (app2, resume_iters - 1),
                    (app3, resume_iters - 1)):
        _assert_eval_files(a, step, mesh=True)
    missing = ([k for k in PDRA_TRAIN_KERNELS if launches[k] == 0]
               + [f"test_nv {k}" for k in LTS_EVAL_KERNELS
                  if ev_launches[k] == 0])

    relight = {}
    for phase in RELIGHT_PHASES:
        _keep_first_frame(work, phase)
        a, rl, s, pk = count(ov + [f"app.phase={phase}",
                                   f"app.eval.ckpt={ckpt}"])
        r = _stage_rows(a)[-1]
        m = {k.split("/metric/")[1]: v for k, v in r.items()
             if "/metric/" in k}
        if not all(np.isfinite(m[k]) for k in (
                "lin/PSNR", "etc/emo_MSE_first", "etc/emo_MSE_last")):
            raise AssertionError(f"{phase}: {m}")
        if a.timings["ft_overflow_max"] != 0.0:
            raise AssertionError(f"{phase}: fine-tune overflow "
                                 f"{a.timings['ft_overflow_max']}")
        missing += [f"{phase} {k}" for k in RELIGHT_KERNELS if rl[k] == 0]
        print(f"[{phase}] emo_MSE first {m['etc/emo_MSE_first']} last "
              f"{m['etc/emo_MSE_last']}", flush=True)
        relight[phase] = {
            "s": s, "peak_memory_gb": pk,
            "s_per_image": a.timings["relight_s_per_image"],
            "images": a.timings["relight_images"],
            "ft_filter_s": a.timings["ft_filter_s"],
            "ft_cache_s": a.timings["ft_cache_s"],
            "ft_steps_s": a.timings["ft_steps_s"],
            "ft_step_ms": a.timings["ft_steps_s"] / ft_iters * 1e3,
            "ft_edit_rays": a.timings["ft_n_edit_rays"],
            "ft_cache_dropped": a.timings["ft_cache_dropped"],
            "metrics": m, "launches": {k: v for k, v in rl.items() if v}}
    if missing and device.type == "cuda":
        raise AssertionError(f"kernels not launched by the PDRA stage: "
                             f"{missing}")
    steps = [r["train/metric/etc/sec_per_step"] * 1e3 for r in train_rows
             if r["step"] not in (0, n_iters)
             and r["step"] % group_interval != group_interval - 1]
    ev = _stage_rows(app3)[-1]
    return {
        "n_rays": 2 * batch, "world_size": list(app.renderer.geo.world_size),
        "setup_s": app.timings["setup_s"], "train_s": train_s,
        "resume_s": resume_s, "test_nv_s": test_nv_s,
        "median_step_ms": float(np.median(steps)), "step_ms": steps,
        "regroups": [{"step": r["step"], "k_val": r["train/metric/etc/k_val"],
                      "n_uncertain": r["train/metric/etc/n_uncertain"],
                      "n_certain": r["train/metric/etc/n_certain"],
                      "s": r["train/metric/etc/regroup_s"]}
                     for r in regroups],
        "eval_s_per_image": app3.timings["eval_s_per_image"],
        "mesh_s": app3.timings["mesh_s"],
        "ckpt_s": app2.timings["ckpt_s"],
        "ckpt_bytes": app2.timings["ckpt_bytes"],
        "train_peak_memory_gb": peak,
        "mse_first": train_rows[0]["train/metric/srgb/MSE"],
        "mse_last": train_rows[-1]["train/metric/srgb/MSE"],
        **{f"{k}_max": max(r[f"train/metric/etc/{k}"] for r in train_rows)
           for k in ("k1_frac", "k2_frac", "k1_frac_2nd", "k2_frac_2nd")},
        "test_nv": {k.split("/metric/")[1]: v for k, v in ev.items()
                    if "/metric/" in k},
        "ious": ious, "relight": relight,
        "launches_train": {k: v for k, v in launches.items() if v},
        "launches_test_nv": {k: v for k, v in ev_launches.items() if v},
    }


# ------------------------------------------------------------- phase 8

# kernels each path of the chain must launch
CHAIN_KERNELS = {
    "alphamask train": ("splat",),
    "coarse train": ("scan_fwd", "scan_bwd", "splat", "gather_weighted"),
    "coarse test_nv": ("scan_fwd", "gather_weighted"),
}


def stage_step(app, stage):
    """``run(i)``: one more train step of ``stage`` (alphamask, coarse,
    fine or LTS) on the trainer's live state (parameters, optimizer, sampler
    and schedule after its run), through the stage's own step builder."""
    from esrnerf_tpu_torch.apps.alphamask import (build_alphamask_train_step,
                                                  step_generator)
    from esrnerf_tpu_torch.apps.coarse import build_coarse_train_step
    from esrnerf_tpu_torch.apps.fine import build_fine_train_step

    if stage == "lts":
        step = app._train_step()
    else:
        build = {"alphamask": build_alphamask_train_step,
                 "coarse": build_coarse_train_step,
                 "fine": build_fine_train_step}[stage]
        step = build(app.renderer, app.opt, app.cfg, device=app.device)
    gen = step_generator(app.device, 1, app.global_step)

    def run(i):
        gs = app.global_step
        batch = app.place_batch(app.sampler.sample())
        if stage == "alphamask":
            args = (app.lr_scale, app.per_lr)
            kw = {"generator": gen}
        elif stage == "coarse":
            args = (app.s_val_at(gs), dict(app.lr_scales),
                    1.0 if app.tv_on(gs) else 0.0, float(app.tvs["sdf"]),
                    float(app.tvs["smooth_grad"]))
            kw = {}
        else:
            tv = app.tv_from < gs < app.tv_end and gs % app.tv_every == 0
            args = (app.s_val_at(gs), dict(app.lr_scales), 1.0 if tv else 0.0,
                    float(app.tvs["smooth_grad"]),
                    float(app.weight_tv_density * app.tvs["sdf"]
                          / app.train_bs), gs < app.tv_dense_before)
            kw = {}
            if stage == "lts":
                app.renderer.s_val = args[0]
                kw = {"generator": gen}
        app.params, app.opt_state, aux = step(app.params, app.opt_state,
                                              batch, *args, **kw)
        return aux

    return run


def _stage_rows(app):
    with open(os.path.join(app.cfg.log["dir"], "metrics.jsonl")) as f:
        rows = [json.loads(ln) for ln in f]
    for r in rows:
        bad = [k for k, v in r.items() if not np.isfinite(v)]
        if bad:
            raise AssertionError(f"{app.cfg.app['cls']}: non-finite metrics "
                                 f"at step {r['step']}: {bad}")
    return rows


def _assert_eval_files(app, step, mesh):
    d = app.cfg.log["dir"]
    with open(os.path.join(d, "text", f"{step:010}", "mean.txt")) as f:
        mean = f.read()
    for key in ("srgb/PSNR", "srgb/SSIM", "srgb/LPIPS_ALEX"):
        if key not in mean:
            raise AssertionError(f"{d} mean.txt at step {step} lacks {key}")
    if mesh:
        with open(os.path.join(d, "mesh", f"{step:010}", "mesh.ply"),
                  "rb") as f:
            head = f.read(200).decode("latin1")
        if int(head.split("element vertex ")[1].split()[0]) <= 0:
            raise AssertionError(f"{d}: empty mesh at step {step}")


def chain_stages(device, work, device_line=None, wh=256, n_train=12,
                 n_test=3, am_iters=1000, co_iters=60, co_resume_iters=64,
                 fine_iters=4, fine_voxels=128**3, extra=None, co_extra=(),
                 prof_steps=3):
    """The three stages through ``esrnerf_tpu_torch.run.main`` on one
    synthetic scene, each finding the previous stage's checkpoint by path
    (one ``log.root`` and ``log.name``): alphamask (train, eval,
    checkpoint), coarse (train, eval with its mesh, checkpoint, a resume,
    then the test_nv eval of the saved checkpoint) and a few fine steps at
    ``fine_voxels``. Stages run at their configs' full widths unless
    ``extra`` (stage -> overrides) cuts them. After each stage's training
    run, ``prof_steps`` more steps are profiled and counted, and one more is
    captured for the launch replay. Each stage's result is printed as a
    ``chain`` line (with ``device_line``) as soon as it is measured.
    Returns ``(rows, captured)``: the results and the captured alphamask
    and coarse launches."""
    import torch

    from esrnerf_tpu_torch import run
    from esrnerf_tpu_torch.data.synthetic import write_scene
    from esrnerf_tpu_torch.ops import kernels

    extra = extra or {}
    t0 = time.perf_counter()
    write_scene(os.path.join(work, "data"), wh=wh, n_train=n_train,
                n_test=n_test)
    scene_s = time.perf_counter() - t0

    def args(stage, *ov):
        return ["-cn", os.path.join(REPO, f"cfg/exp/esrnerf/giftbox_w/"
                                          f"{stage}.yaml"),
                f"data.root={work}/data", "data.scene=synth_ball",
                f"log.root={work}/logs", "log.name=chain",
                "log.offline=true", "system.debug=true",
                # log, and so synchronise, after every step
                "system.tqdm_iters=1", f"system.device={device.type}",
                "app.trainer.N_vis=2", *extra.get(stage, ()), *ov]

    def count(argv):
        kernels.reset_launches()
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        t = time.perf_counter()
        app = run.main(argv)
        sync(device)
        peak = (torch.cuda.max_memory_allocated(device) / 2**30
                if device.type == "cuda" else None)
        return app, dict(kernels.launches), time.perf_counter() - t, peak

    def measure(stage, app, launches, secs, peak, first_step=0):
        """The stage's row: its run's timings and launches, the median
        synchronised step, then a profile and a launch count of more
        steps."""
        rows = _stage_rows(app)
        train = [r for r in rows if "train/metric/srgb/MSE" in r]
        steps = [r["train/metric/etc/sec_per_step"] * 1e3 for r in train
                 if r["step"] > first_step]
        med = float(np.median(steps))
        bs = int(app.train_bs)
        runner = stage_step(app, stage)
        prof = profile_steps(device, runner, n=prof_steps)
        kernels.reset_launches()
        for i in range(prof_steps):
            runner(i)
        sync(device)
        per_step = {k: v / prof_steps for k, v in kernels.launches.items()
                    if v}
        return {
            "stage": stage, "run_s": secs,
            "setup_s": app.timings["setup_s"],
            "steps": len(train), "median_step_ms": med,
            "rays_per_s": bs / med * 1e3, "n_rays": bs,
            "device_busy_ms_per_step": prof["device_busy_ms_per_step"],
            "device_launches_per_step": prof["device_launches_per_step"],
            "phases_ms_per_step": prof["phases_ms_per_step"],
            "port_kernels_ms_per_step": prof["port_kernels_ms_per_step"],
            "kernel_launches_per_step": per_step,
            "run_launches": {k: v for k, v in launches.items() if v},
            "peak_memory_gb": peak,
            "mse_first": train[0]["train/metric/srgb/MSE"],
            "mse_last": train[-1]["train/metric/srgb/MSE"],
            **{f"{k}_max": max(r.get(f"train/metric/etc/{k}", 0.0)
                               for r in train)
               for k in ("overflow", "k1_frac", "k2_frac")},
            **{k: v for k, v in app.timings.items() if k != "setup_s"},
        }, runner

    out, captured = [], []

    # 1. alphamask: frustum bbox, near-camera mask, view counts (K-3)
    am, launches, secs, peak = count(args(
        "alphamask", "app.phase=train", f"app.trainer.n_iters={am_iters}"))
    row, runner = measure("alphamask", am, launches, secs, peak)
    # the voxels coarse's bbox takes in (alpha > bbox_thres at interval 1)
    alpha = am.renderer.activate_density(am.params["density"], 1.0)
    row.update(world_size=list(am.renderer.world_size),
               num_voxels=int(np.prod(am.renderer.world_size)),
               n_samples=am.renderer.n_samples, scene_s=scene_s,
               occupied_voxels=int((alpha > 1e-3).sum()))
    _assert_eval_files(am, am_iters - 1, mesh=False)
    captured += [dict(r, site="alphamask: " + r["site"])
                 for r in capture_launches(lambda: runner(0))]
    out.append(row)
    emit({"phase": "chain", **row, "device": device_line})
    del runner
    missing = [k for k in CHAIN_KERNELS["alphamask train"]
               if launches[k] == 0]

    # 2. coarse: from alphamask's checkpoint by path
    co_args = lambda n: args("coarse", "app.phase=train",
                             f"app.trainer.n_iters={n}",
                             f"app.trainer.save_every={co_iters}",
                             f"app.trainer.vis_every={co_iters}", *co_extra)
    co, launches, secs, peak = count(co_args(co_iters))
    missing += [f"coarse train {k}" for k in CHAIN_KERNELS["coarse train"]
                if launches[k] == 0]
    row, runner = measure("coarse", co, launches, secs, peak)
    row.update(world_size=list(co.renderer.geo.world_size),
               num_voxels=int(np.prod(co.renderer.geo.world_size)),
               n_samples=co.renderer.geo.n_samples,
               bbox=[co.renderer.geo.xyz_min.tolist(),
                     co.renderer.geo.xyz_max.tolist()])
    if row["overflow_max"] != 0.0:
        raise AssertionError(f"coarse march overflow {row['overflow_max']}")
    _assert_eval_files(co, co_iters - 1, mesh=True)
    captured += [dict(r, site="coarse: " + r["site"])
                 for r in capture_launches(lambda: runner(0))]
    del runner
    co2, _, row["resume_s"], _ = count(co_args(co_resume_iters))
    rows = _stage_rows(co2)
    resumed = [r["step"] for r in rows if "train/metric/srgb/MSE" in r]
    if resumed != list(range(co_resume_iters)):
        raise AssertionError(f"coarse steps logged: {resumed}")
    if co2.global_step != co_resume_iters - 1:
        raise AssertionError(f"coarse resume ended at {co2.global_step}")
    if max(r["train/metric/etc/overflow"] for r in rows
           if "train/metric/etc/overflow" in r) != 0.0:
        raise AssertionError("coarse march overflow after the resume")
    ckpt = os.path.join(co2.cfg.log["dir"], "checkpoints", "last.ckpt")
    ev, ev_launches, row["test_nv_s"], _ = count(args(
        "coarse", "app.phase=test_nv", f"app.eval.ckpt={ckpt}"))
    missing += [f"coarse test_nv {k}" for k in CHAIN_KERNELS["coarse test_nv"]
                if ev_launches[k] == 0]
    _assert_eval_files(ev, co_resume_iters - 1, mesh=True)
    row.update(test_nv={k.split("/metric/")[1]: v
                        for k, v in _stage_rows(ev)[-1].items()
                        if "/metric/" in k},
               test_nv_launches={k: v for k, v in ev_launches.items() if v},
               test_nv_eval_s_per_image=ev.timings["eval_s_per_image"],
               test_nv_mesh_s=ev.timings["mesh_s"])
    out.append(row)
    emit({"phase": "chain", **row, "device": device_line})
    del co, co2, ev

    # 3. a few fine steps from coarse's checkpoint by path
    fi, launches, secs, peak = count(args(
        "fine", "app.phase=train", f"app.trainer.n_iters={fine_iters}",
        f"app.trainer.num_voxels={fine_voxels}", "app.trainer.pg_scale=[]"))
    row, runner = measure("fine", fi, launches, secs, peak)
    row.update(world_size=list(fi.renderer.geo.world_size),
               num_voxels=fi.renderer.num_voxels)
    _assert_eval_files(fi, fine_iters - 1, mesh=True)
    out.append(row)
    emit({"phase": "chain", **row, "device": device_line})
    del fi, runner
    if missing and device.type == "cuda":
        raise AssertionError(f"kernels not launched by the chain: {missing}")
    return out, captured


# ------------------------------------------------------------- phase 9


def check_decoders(work, png_wh=1200, exr_wh=800):
    """The two host decoders on full-size images: a ``png_wh`` square RGB
    PNG with rows of every filter type in turn, and an ``exr_wh`` square
    half RGB EXR written with PIZ by the port's writer, each read back
    bitwise; their seconds, and the plain Python versions' on the same PNG
    rows and on one Huffman stream of the EXR's half-float bits (as many
    symbols as the image has samples)."""
    from esrnerf_tpu_torch.utils import exr, piz, png

    yy, xx = np.mgrid[:png_wh, :png_wh] / png_wh
    noise = np.random.default_rng(0).integers(0, 24, (png_wh, png_wh, 3))
    img = (np.stack([np.sin(7 * xx) * yy, xx * yy, np.cos(5 * yy)], -1)
           * 100 + 120 + noise).clip(0, 255).astype(np.uint8)
    path = os.path.join(work, "filters.png")
    types = np.arange(png_wh) % 5
    png.write(path, img, filters=types)
    raw = png._filter_rows(img.reshape(png_wh, png_wh * 3), 3, types)
    png_bytes = os.path.getsize(path)
    t = time.perf_counter()
    got = png.read(path)
    png_s = time.perf_counter() - t
    if not np.array_equal(got, img):
        raise AssertionError("the native PNG unfilter is not bitwise")
    t = time.perf_counter()
    plain = png._unfilter_plain(raw, png_wh, png_wh * 3, 3)
    png_plain_s = time.perf_counter() - t
    t = time.perf_counter()
    native = png._unfilter(raw, png_wh, png_wh * 3, 3)
    unfilter_s = time.perf_counter() - t
    if not np.array_equal(plain, native):
        raise AssertionError("the PNG unfilter disagrees with its plain "
                             "version")

    yy, xx = np.mgrid[:exr_wh, :exr_wh] / exr_wh
    hdr = (np.stack([np.sin(6 * xx) * yy, xx * yy, np.cos(3 * yy)], -1)
           * 2).astype(np.float16)
    path = os.path.join(work, "piz.exr")
    t = time.perf_counter()
    exr.imwrite(path, hdr, half=True, compression="piz")
    exr_write_s = time.perf_counter() - t
    t = time.perf_counter()
    back = exr.imread(path)
    exr_s = time.perf_counter() - t
    if not np.array_equal(back[..., :3], hdr.astype(np.float32)):
        raise AssertionError("the PIZ EXR did not read back bitwise")
    sym = hdr.view(np.uint16).reshape(-1)
    data = piz.huf_compress(sym)
    t = time.perf_counter()
    a = piz.huf_uncompress(data, sym.size)
    huf_s = time.perf_counter() - t
    t = time.perf_counter()
    b = piz._huf_uncompress_plain(data, sym.size)
    huf_plain_s = time.perf_counter() - t
    if not (np.array_equal(a, sym) and np.array_equal(b, sym)):
        raise AssertionError("the PIZ Huffman decode is not bitwise")
    return {"png": {"wh": png_wh, "read_s": png_s,
                    "unfilter_s": unfilter_s,
                    "unfilter_plain_s": png_plain_s,
                    "bytes": png_bytes},
            "exr_piz": {"wh": exr_wh, "write_s": exr_write_s,
                        "read_s": exr_s, "huf_s": huf_s,
                        "huf_plain_s": huf_plain_s, "symbols": int(sym.size),
                        "huf_bytes": len(data)}}


# the DTU chain's kernels, by stage's train run
DTU_KERNELS = {"alphamask": CHAIN_KERNELS["alphamask train"],
               "coarse": CHAIN_KERNELS["coarse train"],
               "fine": LTS_TRAIN_KERNELS, "lts": LTS_TRAIN_KERNELS}
DTU_ITERS = {"alphamask": 1000, "coarse": 60, "fine": 12, "lts": 6}
# fine: FINE_OVERRIDES' budgets and the trainer phase's sharpness, the grid
# rescaled once to the config's 256^3 half way; LTS: the budget advisor's
# sizes for this scan (primary 256 masked / 24 head samples a ray,
# secondary 128 / 12; the config's 96 secondary phase-1 samples overflow on
# the first step)
DTU_EXTRA = {
    "fine": [*FINE_OVERRIDES[4:], "app.trainer.s_start=200",
             "app.trainer.pg_scale=[6]"],
    "lts": ["app.model.points_budget_masked_per_ray=256",
            "app.model.points_budget_per_ray=24",
            "app.model.points_budget_masked_per_2ndray=128",
            "app.model.points_budget_per_2ndray=12"],
}


def dtu_stages(device, work, device_line=None, n_views=49, wh=1200,
               iters=None, extra=None, prof_steps=3):
    """alphamask -> coarse -> fine -> LTS through ``esrnerf_tpu_torch.run
    .main`` on a DTU-format scan (``write_dtu_scene``: ``n_views`` views of
    ``wh`` x ``wh``, the Chamfer assets), each stage finding the previous
    one's checkpoint by path, at the configs' widths unless ``extra``
    (stage -> overrides) cuts them. Each stage trains ``iters[stage]``
    steps and ends with a test_nv eval (``N_vis`` 1), its mesh and, but for
    alphamask, ``mesh/CD``; then ``prof_steps`` more steps are profiled and
    counted. Each stage's row is printed as a ``dtu`` line."""
    import torch

    from esrnerf_tpu_torch.data.synthetic import write_dtu_scene
    from esrnerf_tpu_torch.ops import kernels

    iters = {**DTU_ITERS, **(iters or {})}
    extra = {**DTU_EXTRA, **(extra or {})}
    t0 = time.perf_counter()
    write_dtu_scene(os.path.join(work, "data"), scan=97, n_views=n_views,
                    wh=wh)
    scene = {"n_views": n_views, "wh": wh, "rays": n_views * wh * wh,
             "write_s": time.perf_counter() - t0,
             "bytes": sum(os.path.getsize(os.path.join(d, f))
                          for d, _, fs in os.walk(os.path.join(work, "data"))
                          for f in fs)}
    emit({"phase": "dtu_scene", **scene, "iters": iters, "extra": extra,
          "device": device_line})

    def args(stage):
        n = iters[stage]
        return ["-cn", os.path.join(REPO, f"cfg/exp/dtu/97/{stage}.yaml"),
                "app.phase=train", f"data.root={work}/data",
                f"log.root={work}/logs", "log.name=dtu", "log.offline=true",
                "system.debug=true", "system.tqdm_iters=1",
                f"system.device={device.type}", "app.trainer.N_vis=1",
                f"app.trainer.n_iters={n}", f"app.trainer.vis_every={n}",
                f"app.trainer.save_every={n}", *extra.get(stage, ())]

    out, missing = [], []
    for stage in ("alphamask", "coarse", "fine", "lts"):
        app, launches, secs, peak = counted_run(device, args(stage))
        n = iters[stage]
        rows = _stage_rows(app)
        train = [r for r in rows if "train/metric/srgb/MSE" in r]
        if [r["step"] for r in train] != list(range(n)):
            raise AssertionError(f"dtu {stage} steps logged: "
                                 f"{[r['step'] for r in train]}")
        # overflow 0, and every march keeps samples on every step (an empty
        # march has no overflow either)
        fracs = {"coarse": ("k1_frac", "k2_frac"),
                 "fine": ("k1_frac", "k2_frac"),
                 "lts": ("k1_frac", "k2_frac", "k1_frac_2nd",
                         "k2_frac_2nd")}.get(stage, ())
        seen = {k: [r[f"train/metric/etc/{k}"] for r in train]
                for k in ("overflow",) + fracs if fracs}
        if fracs and max(seen["overflow"]) != 0.0:
            raise AssertionError(f"dtu {stage} march overflow: {seen}")
        if any(min(seen[k]) <= 0.0 for k in fracs):
            raise AssertionError(f"dtu {stage}: a march kept no sample on "
                                 f"some step: {seen}")
        ev = [r for r in rows if "test_nv/metric/srgb/PSNR" in r]
        if len(ev) != 1:
            raise AssertionError(f"dtu {stage}: {len(ev)} eval rows")
        ev = {k.split("/metric/")[1]: v for k, v in ev[0].items()
              if "/metric/" in k}
        cd = ev.get("mesh/CD")
        if stage != "alphamask" and not (cd is not None and np.isfinite(cd)):
            raise AssertionError(f"dtu {stage}: mesh/CD {cd}")
        _assert_eval_files(app, n - 1, mesh=stage != "alphamask")
        missing += [f"{stage} {k}" for k in DTU_KERNELS[stage]
                    if launches[k] == 0]
        # synchronised steps but the first and the one after a rescale
        skip = {0} | {int(k) + 1 for k in
                      (app.cfg.app.trainer.get("pg_scale") or ())
                      if stage == "fine"}
        steps = [r["train/metric/etc/sec_per_step"] * 1e3 for r in train
                 if r["step"] not in skip]
        runner = stage_step(app, stage)
        prof = profile_steps(device, runner, n=prof_steps)
        kernels.reset_launches()
        for i in range(prof_steps):
            runner(i)
        sync(device)
        row = {
            "stage": stage, "steps": n, "n_rays": int(app.train_bs),
            "run_s": secs, "data_s": app.timings["data_s"],
            "setup_s": app.timings["setup_s"],
            "median_step_ms": float(np.median(steps)),
            "device_busy_ms_per_step": prof["device_busy_ms_per_step"],
            "device_launches_per_step": prof["device_launches_per_step"],
            "kernel_launches_per_step": {
                k: v / prof_steps for k, v in kernels.launches.items() if v},
            "run_launches": {k: v for k, v in launches.items() if v},
            "peak_memory_gb": peak,
            "eval_s_per_image": app.timings["eval_s_per_image"],
            "mesh_s": app.timings.get("mesh_s"),
            "mesh_verts": app.timings.get("mesh_verts"),
            "cd_s": app.timings.get("cd_s"), "mesh/CD": cd,
            "ckpt_s": app.timings["ckpt_s"],
            "ckpt_bytes": app.timings["ckpt_bytes"],
            "mse_first": train[0]["train/metric/srgb/MSE"],
            "mse_last": train[-1]["train/metric/srgb/MSE"],
            **{f"{k}_max": max(r.get(f"train/metric/etc/{k}", 0.0)
                               for r in train)
               for k in ("overflow", "k1_frac", "k2_frac", "k1_frac_2nd",
                         "k2_frac_2nd")},
            "test_nv": ev,
            **{k: v for k, v in app.timings.items()
               if k in ("count_views_s", "ray_filter_s", "rays_kept")},
        }
        out.append(row)
        emit({"phase": "dtu", **row, "device": device_line})
        del app, runner
        if device.type == "cuda":
            torch.cuda.empty_cache()
    if missing and device.type == "cuda":
        raise AssertionError(f"kernels not launched by the DTU chain: "
                             f"{missing}")
    return scene, out


# ------------------------------------------ the data-parallel phase (dp)

# two ranks: on one card over gloo (the driver's machine has one), one card
# a rank over NCCL where there are two
DP_RANKS = 2
DP_TIMEOUT_S = 240  # a collective that waits longer raises: no hang
# head samples a ray raised 16 -> 24 for the small steps: a rank's block of
# 32 of the 64 rays overflows its own budget at 16 (the whole batch does
# not)
DP_BUDGET = ["app.model.points_budget_per_ray=24"]
# the LTS-family steps' layout-invariant recipe (the JAX package's
# tests/test_parallel.py): Fibonacci scattering, eps 0, every slot of the
# march selected (num_ltspts = rays x head budget), smoothness weight 0
DP_RECIPE = [*SMALL_ESR, *DP_BUDGET, "app.model.ray_sampling=fib",
             "app.trainer.normal_eps=0.0", "app.trainer.emit_eps=0.0",
             "app.trainer.weight_normal_smooth=0.0",
             f"app.model.num_ltspts={64 * 24}"]
# the gspmd small steps: the LTS family with its real draws (random
# scattering, the configs' perturbation eps, 16 surface points chosen over
# both ranks' head rows)
DP_REAL = [*SMALL_ESR, *DP_BUDGET]
DP_FT_PPR = 8
DP_KINDS = ("fine", "alphamask", "coarse", "lts", "pdra", "finetune")
# loss-term positions in each small step's aux
DP_TERMS = {"fine": [0, 1], "alphamask": [0], "coarse": [0],
            "lts": [0, 1, 2, 3], "pdra": [0, 1, 2, 3, 9, 10, 11],
            "finetune": [0]}
# the overflow's position in each small step's aux (alphamask has none)
DP_OVERFLOW = {"fine": 2, "alphamask": None, "coarse": 1, "lts": 4,
               "pdra": 4, "finetune": 1}


def dp_small_step(kind, device, sh, seed=0, gspmd=False):
    """One small step of ``kind`` (the check phases' set-ups, the LTS
    family on the layout-invariant recipe, or with ``gspmd`` on its real
    draws) on the rank's block of its 64-ray batch with the ranks' helpers
    ``sh`` (``gspmd`` ones for a gspmd step; the one-device step with the
    world-1 helpers); returns the step's (all-reduced) gradients on the CPU
    and its aux."""
    import torch

    from esrnerf_tpu_torch.apps.alphamask import build_alphamask_train_step
    from esrnerf_tpu_torch.apps.coarse import build_coarse_train_step
    from esrnerf_tpu_torch.apps.fine import build_fine_train_step
    from esrnerf_tpu_torch.apps.lts import build_lts_train_step
    from esrnerf_tpu_torch.apps.pdra import (build_finetune_step,
                                             build_pdra_train_step)
    from esrnerf_tpu_torch.config import load_cfg
    from esrnerf_tpu_torch.models.dvgo import DVGO
    from esrnerf_tpu_torch.models.voxurfc import VoxurfC
    from esrnerf_tpu_torch.parallel.mesh import shard_rows

    rows = lambda b: {k: shard_rows(v, sh.rank, sh.n) for k, v in b.items()}
    rng = np.random.default_rng(seed)
    cpu = torch.Generator().manual_seed(seed)
    if kind == "fine":
        cfg, model = build_fine(device, 32**3, [
            "app.model.rgbnet_width=32", "app.model.rgbnet_depth=2",
            "app.model.tonemap_width=32", "system.compute_dtype=float32",
            *DP_BUDGET], mask_res=16)
        params = model.init_params(cpu)
        for g in ("off_color", "emo_color"):
            params[g] = torch.as_tensor(rng.normal(
                scale=0.3, size=params[g].shape).astype(np.float32))
        a = step_args(cfg, 3, 64)
        step = build_fine_train_step(model, _GradsOut(), cfg, device=device,
                                     sh=sh)
        out = step(_to(params, device), None, rows(make_batch(seed, 64,
                                                              device)),
                   a["s_val"], a["lr_scales"], a["tv_flag"],
                   a["smooth_grad_tv"], a["sdf_tv_w"], a["tv_dense"])
    elif kind in ("alphamask", "coarse"):
        base = ["app.phase=train", "data.cls=x", "data.root=x",
                "data.scene=x", "system.compute_dtype=float32",
                "app.model.num_voxels=32768"]
        batch = rows(make_batch(seed, 64, device))
        if kind == "alphamask":
            cfg = load_cfg("cfg/app/alphamask.yaml", base, root_dir=REPO)
            model = DVGO(cfg, 0.5, 4.0, [-1] * 3, [1] * 3, device=device)
            params = model.init_params()
            params["density"] = torch.as_tensor(rng.normal(
                12.0, 3.0, params["density"].shape).astype(np.float32))
            for g in ("off_color", "emo_color"):
                params[g] = torch.as_tensor(rng.normal(
                    size=params[g].shape).astype(np.float32))
            params = _to(params, device)
            shift = torch.as_tensor(rng.uniform(size=(64, 1)).astype(
                np.float32), device=device)
            per_lr = {"density": torch.full_like(params["density"], 0.5)}
            out = build_alphamask_train_step(
                model, _GradsOut(), cfg, device=device, sh=sh)(
                params, None, batch, 1.0, per_lr,
                rand_shift=shard_rows(shift, sh.rank, sh.n))
            out = (out[0], out[1], (out[2],))
        else:
            cfg = load_cfg("cfg/app/coarse.yaml",
                           base + ["app.model.rgbnet_width=32"],
                           root_dir=REPO)
            model = VoxurfC(cfg, 0.5, 4.0, [-1] * 3, [1] * 3,
                            _ball_mask_cache(device), s_val=20.0)
            params = model.init_params(cpu)
            for g in ("off_color", "emo_color"):
                params[g] = torch.as_tensor(rng.normal(
                    scale=0.3, size=params[g].shape).astype(np.float32))
            out = build_coarse_train_step(
                model, _GradsOut(), cfg, device=device, sh=sh)(
                _to(params, device), None, batch, 20.0,
                {k: 1.0 for k in params}, 1.0, 0.1, 0.05)
    else:
        build = build_lts if kind == "lts" else build_pdra
        extra = DP_REAL if gspmd else DP_RECIPE + (
            [f"app.model.num_ltspts={64 * DP_FT_PPR}"]
            if kind == "finetune" else [])
        cfg, model = build(device, 32**3, extra, mask_res=16)
        model.lts_points_divisor = 1 if gspmd else sh.n
        params = _to(_small_esr_params(model, seed), device)
        gen = sh.fold_generator(device, seed, 0)
        if kind == "finetune":
            b = make_ft_batch(seed, 64, device)
            trainable, frozen = ft_split(params)
            p, ok, _ = model.geo.march_ray_slots(
                frozen["sdf"], b["rays_o"], b["rays_d"], b["viewdirs"],
                40.0, model.fastcolor_thres, model.neus_alpha, DP_FT_PPR)
            b.update(ft_pts=p, ft_valid=ok)
            b = rows(b)
            out = build_finetune_step(model, _GradsOut(), FT_WEIGHT, sh)(
                trainable, None, frozen, b, 40.0, generator=gen,
                ft_pts=b["ft_pts"], ft_valid=b["ft_valid"])
        else:
            b = rows(make_lts_batch(seed, 64, device) if kind == "lts"
                     else make_pdra_batch(seed, 32, device))
            step = (build_lts_train_step if kind == "lts"
                    else build_pdra_train_step)(model, _GradsOut(), cfg,
                                                device=device, sh=sh)
            out = step(params, None, b, 40.0, {k: 1.0 for k in params},
                       1.0, 0.05, 1e-4, True, generator=gen)
    grads, _, aux = out
    return _to(grads, "cpu"), [float(x) for x in aux]


def _persistent_bytes(params, state) -> int:
    """Bytes the rank keeps between steps: parameters and Adam moments."""
    from esrnerf_tpu_torch.apps.base import tree_leaves

    return sum(t.numel() * t.element_size()
               for tree in (params, state.mu, state.nu)
               for _, t in tree_leaves(tree))


def dp_full_width(device, sh, warmup=2, timed=3):
    """The fine step at full width (``train_full_width``'s set-up: 256^3,
    192-wide heads, 8,192 rays) on the rank's 8,192 / n rays: the first
    step's all-reduced gradients with f32 heads (against the one-device
    step on all 8,192 rays, on rank 0: bf16 heads round the two layouts'
    partial sums apart), the gradient all-reduce's ms (host clock around a
    synchronised call, five calls); then, with the config's bf16 heads as
    the train phase, ``warmup`` + ``timed`` Adam steps (synchronised host
    clock; overflow and losses), launches, peak memory and a profile of
    three more steps."""
    import torch

    from esrnerf_tpu_torch.apps.fine import build_fine_train_step
    from esrnerf_tpu_torch.ops import kernels
    from esrnerf_tpu_torch.optim import Adam
    from esrnerf_tpu_torch.parallel.mesh import ShardHelpers, shard_rows

    cfg, model = build_fine(device, NUM_VOXELS,
                            ["system.compute_dtype=float32"])
    params = model.init_params(torch.Generator(device=device).manual_seed(0))
    batches = [make_batch(i, N_RAYS, device) for i in range(4)]
    local = [{k: shard_rows(v, sh.rank, sh.n) for k, v in b.items()}
             for b in batches]

    def args(i):
        a = step_args(cfg, i, N_RAYS)
        return (a["s_val"], a["lr_scales"], a["tv_flag"],
                a["smooth_grad_tv"], a["sdf_tv_w"], a["tv_dense"])

    out = {}
    grads = build_fine_train_step(model, _GradsOut(), cfg, device=device,
                                  sh=sh)(params, None, local[0], *args(0))[0]
    if sh.rank == 0:
        want = build_fine_train_step(
            model, _GradsOut(), cfg, device=device, sh=ShardHelpers())(
            params, None, batches[0], *args(0))[0]
        out["first_step_grad_err_rel"] = assert_grads_close(
            _to(want, "cpu"), grads)
        del want
    ar = []
    for _ in range(5):
        sync(device)
        t0 = time.perf_counter()
        sh.all_reduce_grads(grads)
        sync(device)
        ar.append((time.perf_counter() - t0) * 1e3)
    out["allreduce_ms"] = float(np.median(ar))
    out["allreduce_ms_all"] = ar
    out["allreduce_mb"] = sum(
        g.numel() * g.element_size()
        for g in (v for gg in grads.values()
                  for v in (gg.values() if isinstance(gg, dict) else [gg]))
    ) / 2**20
    del grads, model

    cfg, model = build_fine(device, NUM_VOXELS)
    opt = Adam(dict(cfg.app.trainer.lrs))
    state = opt.init(params)
    step = build_fine_train_step(model, opt, cfg, device=device, sh=sh)

    def run(i):
        nonlocal params, state
        params, state, aux = step(params, state, local[i % 4], *args(i))
        return aux

    for i in range(warmup):
        run(i)
    sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    kernels.reset_launches()
    times, auxes = [], []
    for i in range(timed):
        t0 = time.perf_counter()
        auxes.append(run(warmup + i))
        sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
    launches = dict(kernels.launches)
    aux = torch.stack([torch.stack(a) for a in auxes]).cpu().numpy()
    if not np.isfinite(aux).all():
        raise AssertionError(f"dp rank {sh.rank}: non-finite losses {aux}")
    if aux[:, 2].max() != 0.0:
        raise AssertionError(f"dp rank {sh.rank}: march overflow "
                             f"{aux[:, 2].max()}")
    missing = [k for k in _CAPTURED if launches[k] == 0]
    if missing and device.type == "cuda":
        raise AssertionError(f"dp rank {sh.rank}: kernels not launched: "
                             f"{missing}")
    prof = profile_steps(device, lambda i: run(50 + i))
    out.update({
        "rays_per_rank": N_RAYS // sh.n, "timed_steps": timed,
        "persistent_bytes": _persistent_bytes(params, state),
        "step_ms_median": float(np.median(times)), "step_ms_all": times,
        "device_busy_ms_per_step": prof["device_busy_ms_per_step"],
        "device_launches_per_step": prof["device_launches_per_step"],
        "allreduce_phase_device_ms": prof["phases_ms_per_step"].get(
            "fine/grad_allreduce", {}).get("device_ms"),
        "allreduce_phase_host_ms": prof["phases_ms_per_step"].get(
            "fine/grad_allreduce", {}).get("host_ms"),
        "launches_per_step": {k: v / timed for k, v in launches.items()
                              if v},
        "peak_gib": (torch.cuda.max_memory_allocated(device) / 2**30
                     if device.type == "cuda" else None),
        "mse_first": float(aux[0, 0]), "mse_last": float(aux[-1, 0]),
        "overflow_max": float(aux[:, 2].max()),
        "k1_frac_max": float(aux[:, 3].max()),
        "k2_frac_max": float(aux[:, 4].max()),
    })
    return out


def dp_fsdp_full_width(device, sh, warmup=2, timed=3):
    """The fine step at full width under ``gspmd`` + ``fsdp`` (``sh``: the
    ranks' gspmd helpers): 256^3, 192-wide heads, 8,192 rays, the rank's
    8,192 / n of them, every grid and its Adam moments kept as the rank's
    X-slab. The first f32 step's slab gradients, gathered, against the
    one-device step on all 8,192 rays (rank 0; each group within 1e-4 of
    its largest); the slabs' all-gather and the gradients' reduce-scatter
    ms (host clock around synchronised calls, three each); then with the
    config's bf16 heads ``warmup`` + ``timed`` Adam steps (overflow 0,
    finite losses, K-1..K-4 launched), a profile of three more (busy ms,
    launches, the all-gather, reduce-scatter and SDF TV phases), the peak
    memory and the persistent parameter-plus-moment bytes."""
    import torch

    from esrnerf_tpu_torch.apps.base import tree_leaves
    from esrnerf_tpu_torch.apps.fine import build_fine_train_step
    from esrnerf_tpu_torch.ops import kernels
    from esrnerf_tpu_torch.optim import Adam
    from esrnerf_tpu_torch.parallel.mesh import (ParamLayout, ShardHelpers,
                                                shard_rows)

    cfg, model = build_fine(device, NUM_VOXELS,
                            ["system.compute_dtype=float32"])
    params = model.init_params(torch.Generator(device=device).manual_seed(0))
    layout = ParamLayout(sh, fsdp=True)
    slabs = layout.place(params)
    batches = [make_batch(i, N_RAYS, device) for i in range(4)]
    local = [{k: shard_rows(v, sh.rank, sh.n) for k, v in b.items()}
             for b in batches]

    def args(i):
        a = step_args(cfg, i, N_RAYS)
        return (a["s_val"], a["lr_scales"], a["tv_flag"],
                a["smooth_grad_tv"], a["sdf_tv_w"], a["tv_dense"])

    out = {"sharded": sorted("/".join(p) for p in layout.paths)}
    grads = build_fine_train_step(model, _GradsOut(), cfg, device=device,
                                  sh=sh, layout=layout)(
        slabs, None, local[0], *args(0))[0]
    whole_grads = layout.gather(grads)
    if sh.rank == 0:
        want = build_fine_train_step(
            model, _GradsOut(), cfg, device=device, sh=ShardHelpers())(
            params, None, batches[0], *args(0))[0]
        out["first_step_grad_err_rel"] = assert_grads_close(
            _to(want, "cpu"), whole_grads)
        del want
    del params

    def timed_ms(fn, runs=5):
        ms = []
        for _ in range(runs):
            sync(device)
            t0 = time.perf_counter()
            fn()
            sync(device)
            ms.append((time.perf_counter() - t0) * 1e3)
        return ms

    grid_grads = [g for p, g in tree_leaves(whole_grads)
                  if p in layout.paths]
    ag = timed_ms(lambda: layout.gather(slabs), runs=3)
    rs = timed_ms(lambda: [sh.reduce_scatter_flat(g) for g in grid_grads],
                  runs=3)
    out.update({
        "all_gather_ms": float(np.median(ag)), "all_gather_ms_all": ag,
        "reduce_scatter_ms": float(np.median(rs)),
        "reduce_scatter_ms_all": rs,
        "gathered_mb": sum(g.numel() * g.element_size()
                           for g in grid_grads) / 2**20,
    })
    del grads, whole_grads, grid_grads, model

    cfg, model = build_fine(device, NUM_VOXELS)
    opt = Adam(dict(cfg.app.trainer.lrs))
    state = opt.init(slabs)
    step = build_fine_train_step(model, opt, cfg, device=device, sh=sh,
                                 layout=layout)

    def run(i):
        nonlocal slabs, state
        slabs, state, aux = step(slabs, state, local[i % 4], *args(i))
        return aux

    for i in range(warmup):
        run(i)
    sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    kernels.reset_launches()
    times, auxes = [], []
    for i in range(timed):
        t0 = time.perf_counter()
        auxes.append(run(warmup + i))
        sync(device)
        times.append((time.perf_counter() - t0) * 1e3)
    launches = dict(kernels.launches)
    aux = torch.stack([torch.stack(a) for a in auxes]).cpu().numpy()
    if not np.isfinite(aux).all():
        raise AssertionError(f"fsdp rank {sh.rank}: non-finite losses {aux}")
    if aux[:, 2].max() != 0.0:
        raise AssertionError(f"fsdp rank {sh.rank}: march overflow "
                             f"{aux[:, 2].max()}")
    missing = [k for k in _CAPTURED if launches[k] == 0]
    if missing and device.type == "cuda":
        raise AssertionError(f"fsdp rank {sh.rank}: kernels not launched: "
                             f"{missing}")
    peak = (torch.cuda.max_memory_allocated(device) / 2**30
            if device.type == "cuda" else None)
    prof = profile_steps(device, lambda i: run(50 + i))
    phase = lambda k: prof["phases_ms_per_step"].get(k, {})
    out.update({
        "rays_per_rank": N_RAYS // sh.n, "timed_steps": timed,
        "persistent_bytes": _persistent_bytes(slabs, state),
        "step_ms_median": float(np.median(times)), "step_ms_all": times,
        "device_busy_ms_per_step": prof["device_busy_ms_per_step"],
        "device_launches_per_step": prof["device_launches_per_step"],
        "all_gather_phase_ms": phase("fine/all_gather"),
        "reduce_scatter_phase_ms": phase("fsdp/reduce_scatter"),
        "allreduce_phase_ms": phase("fine/grad_allreduce"),
        "sdf_tv_grad_phase_ms": phase("fine/sdf_tv_grad"),
        "launches_per_step": {k: v / timed for k, v in launches.items()
                              if v},
        "peak_gib": peak,
        "mse_first": float(aux[0, 0]), "mse_last": float(aux[-1, 0]),
        "overflow_max": float(aux[:, 2].max()),
        "k1_frac_max": float(aux[:, 3].max()),
        "k2_frac_max": float(aux[:, 4].max()),
    })
    return out


def _dp_rank(rank, n, init, backend, outq):
    """One rank of the dp phase, spawned: joins the group, runs the small
    steps (rank 0 also the one-device steps, held to the ranks'), then the
    full-width fine step; puts its result (or its traceback) on
    ``outq``."""
    import datetime
    import traceback

    import torch
    import torch.distributed as dist

    try:
        sys.path.insert(0, REPO)
        from esrnerf_tpu_torch.parallel.mesh import ShardHelpers

        device = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        dist.init_process_group(
            backend, init_method=init, rank=rank, world_size=n,
            timeout=datetime.timedelta(seconds=DP_TIMEOUT_S))
        sh = ShardHelpers(n, rank, backend=backend)
        gsh = ShardHelpers(n, rank, backend=backend, gspmd=True)
        res = {"rank": rank, "device": str(device), "small": {},
               "gspmd_small": {}}
        for key, helpers, gspmd in (("small", sh, False),
                                    ("gspmd_small", gsh, True)):
            for kind in DP_KINDS:
                g, aux = dp_small_step(kind, device, helpers, gspmd=gspmd)
                if rank == 0:
                    g1, aux1 = dp_small_step(kind, device, ShardHelpers(),
                                             gspmd=gspmd)
                    t = DP_TERMS[kind]
                    np.testing.assert_allclose([aux[i] for i in t],
                                               [aux1[i] for i in t],
                                               rtol=1e-5)
                    i = DP_OVERFLOW[kind]
                    if i is not None and (aux[i] != 0.0 or aux1[i] != 0.0):
                        raise AssertionError(
                            f"{key} {kind}: overflow {aux[i]} (one device "
                            f"{aux1[i]})")
                    res[key][kind] = {
                        "loss": aux[0], "loss_one_device": aux1[0],
                        "max_grad_err_rel": assert_grads_close(g1, g)}
                helpers.barrier()
        res.update(dp_full_width(device, sh))
        torch.cuda.empty_cache()
        res["fsdp"] = dp_fsdp_full_width(device, gsh)
        res["fsdp"]["replicated_persistent_bytes"] = res["persistent_bytes"]
        dist.destroy_process_group()
        outq.put((rank, True, res))
    except BaseException:  # the parent raises it
        outq.put((rank, False, traceback.format_exc()))


def dp_train(work, n=DP_RANKS):
    """The dp phase: ``n`` spawned ranks (gloo on one card, NCCL with a
    card each), a ``file://`` rendezvous in ``work``; returns each rank's
    result. A rank's failure raises here; every rank is joined (or
    killed)."""
    import multiprocessing as mp
    import queue

    import torch

    count = torch.cuda.device_count()
    backend = "nccl" if count >= n else "gloo"
    ctx = mp.get_context("spawn")
    outq = ctx.Queue()
    init = "file://" + os.path.join(work, "dp_rendezvous")
    procs = [ctx.Process(target=_dp_rank, args=(r, n, init, backend, outq))
             for r in range(n)]
    t0 = time.perf_counter()
    for p in procs:
        p.start()
    got = {}
    try:
        while len(got) < n:
            try:
                rank, ok, val = outq.get(timeout=5.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if not p.is_alive() and r not in got]
                if dead:
                    raise AssertionError(f"dp ranks {dead} died")
                if time.perf_counter() - t0 > 4 * DP_TIMEOUT_S:
                    raise AssertionError("dp phase outlasted its limit")
                continue
            if not ok:
                raise AssertionError(f"dp rank {rank} failed:\n{val}")
            got[rank] = val
    finally:
        for p in procs:
            p.join(timeout=60)
            if p.is_alive():
                p.kill()
                p.join()
    return {"backend": backend, "ranks_n": n, "cards": count,
            "seconds": time.perf_counter() - t0,
            "ranks": [got[r] for r in range(n)]}


# ------------------------------------------------------------------ main


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60)
    return out.stdout.strip().splitlines()[0]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from esrnerf_tpu_torch.ops import kernels

    device = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    emit({"phase": "device", "nvidia_smi": smi,
          "name": torch.cuda.get_device_name(0),
          "count": torch.cuda.device_count(), "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})

    t0 = time.perf_counter()
    reports = kernels.build()
    build_s = time.perf_counter() - t0
    ptxas = [ln.strip() for rep in reports.values() for ln in rep.splitlines()
             if "registers" in ln or "spill" in ln or "Compiling" in ln]
    emit({"phase": "build", "seconds": build_s, "built": sorted(reports),
          "ptxas": ptxas})

    rows = check_kernels(device, N=N_RAYS, S=896, M1=3538944,
                         n_cells=NUM_VOXELS, K2=N_RAYS * 16, grid_res=256)
    heads_row = check_eval_heads(device)
    sync(device)

    emit({"phase": "check", **check_small_step(device)})
    emit({"phase": "check_upstream", **check_small_upstream_steps(device)})
    emit({"phase": "check_lts", **check_small_lts_step(device)})
    emit({"phase": "check_pdra", **check_small_pdra_step(device)})
    emit({"phase": "check_finetune", **check_small_finetune(device)})
    emit({"phase": "grad_small", **check_small_grad_steps(device)})

    res, launches, captured = train_full_width(device, NUM_VOXELS, N_RAYS)
    res["device"] = smi
    emit({"phase": "train", **res})
    missing = [r["name"] for r in rows if launches[r["name"]] == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")
    for r in rows:
        r["launches"] = launches[r["name"]]
    in_step = res["profile"]["port_kernels_ms_per_step"]
    emit({"phase": "in_step", "device": smi, "kernels": {
        r["name"]: {"ms_per_step": in_step[r["name"]],
                    "launches_per_step": res["launches_per_step"][r["name"]]}
        for r in rows}})
    seen = {r["kernel"] for r in captured}
    if seen != set(_CAPTURED):
        raise AssertionError(f"captured step launched only {sorted(seen)}")
    replay_launches(captured, device)
    del res, captured
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(prefix="esr_trace_") as tdir:
        res, grad_launches, captured = train_full_width(
            device, NUM_VOXELS, N_RAYS, warmup=2, timed=10, overrides=GRAD,
            trace_dir=tdir)
    res["device"] = smi
    emit({"phase": "grad_train", **res})
    missing = [k for k in _CAPTURED if grad_launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched by the grad-alpha fine "
                             f"step: {missing}")
    emit({"phase": "grad_in_step", "device": smi, "kernels": {
        k: {"ms_per_step": res["profile"]["port_kernels_ms_per_step"][k],
            "launches_per_step": res["launches_per_step"][k]}
        for k in _CAPTURED}})
    seen = {r["kernel"] for r in captured}
    if seen != set(_CAPTURED):
        raise AssertionError(f"captured grad step launched only {sorted(seen)}")
    replay_launches([dict(r, site="grad: " + r["site"]) for r in captured],
                    device)
    del res, captured
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(prefix="esr_dp_") as work:
        dp = dp_train(work)
    emit({"phase": "dp_train", **dp, "device": smi})
    dp_launches = dp["ranks"][0]["launches_per_step"]

    res, lts_launches, captured, (model, params) = train_lts_full_width(
        device, NUM_VOXELS, N_RAYS)
    res["device"] = smi
    res["eval_chunk"] = lts_eval_chunk_timed(device, model, params)
    del model, params
    emit({"phase": "lts_train", **res})
    missing = [k for k in _CAPTURED if lts_launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels not launched by the LTS step: "
                             f"{missing}")
    sec = res["secondary_launches"]
    if not {"scan_fwd", "scan_bwd", "splat", "gather_weighted",
            "gather_raw"} <= set(sec):
        raise AssertionError(f"the secondary march launched only {sec}")
    in_step = res["profile"]["port_kernels_ms_per_step"]
    emit({"phase": "lts_in_step", "device": smi, "kernels": {
        k: {"ms_per_step": in_step[k],
            "launches_per_step": res["launches_per_step"][k]}
        for k in _CAPTURED}})
    seen = {r["kernel"] for r in captured}
    if seen != set(_CAPTURED):
        raise AssertionError(f"captured LTS step launched only {sorted(seen)}")
    replay_launches([dict(r, site="lts: " + r["site"])
                     for r in records_to(captured, device)], device)
    del res, captured
    torch.cuda.empty_cache()

    res, pdra_launches, ft_launches, (captured, ft_captured,
                                      relight_captured) = \
        train_pdra_full_width(device, NUM_VOXELS, PDRA_BATCH)
    res["device"] = smi
    emit({"phase": "pdra_train", **res})
    missing = ([k for k in _CAPTURED if pdra_launches[k] == 0]
               + [f"finetune {k}" for k in FT_KERNELS if ft_launches[k] == 0])
    if missing:
        raise AssertionError(f"kernels not launched by the PDRA step or the "
                             f"fine-tune: {missing}")
    sec = res["secondary_launches"]
    if not {"scan_fwd", "scan_bwd", "splat", "gather_weighted",
            "gather_raw"} <= set(sec):
        raise AssertionError(f"the PDRA secondary march launched only {sec}")
    in_step = res["profile"]["port_kernels_ms_per_step"]
    ft_in_step = res["finetune"]["profile"]["port_kernels_ms_per_step"]
    emit({"phase": "pdra_in_step", "device": smi, "kernels": {
        k: {"ms_per_step": in_step[k],
            "launches_per_step": res["launches_per_step"][k],
            "finetune_ms_per_step": ft_in_step[k],
            "finetune_launches_per_step":
                res["finetune"]["launches_per_step"][k]}
        for k in _CAPTURED}})
    for name, recs in (("PDRA step", captured), ("fine-tune", ft_captured)):
        seen = {r["kernel"] for r in recs}
        want = set(_CAPTURED) if name == "PDRA step" else set(FT_KERNELS)
        if not want <= seen:
            raise AssertionError(f"captured {name} launched only "
                                 f"{sorted(seen)}")
    widths = {r["table"].shape[1] for r in ft_captured + relight_captured
              if r["kernel"] == "gather_weighted"}
    if not {6, 24} <= widths:
        raise AssertionError(f"the 6- and 24-channel gathers did not run: "
                             f"{sorted(widths)}")
    replay_launches([dict(r, site=f"{tag}: " + r["site"])
                     for tag, recs in (("pdra", captured),
                                       ("finetune", ft_captured),
                                       ("relight", relight_captured))
                     for r in records_to(recs, device)], device)
    del res, captured, ft_captured, relight_captured
    torch.cuda.empty_cache()

    gb_rows = check_gather_bench(device)
    zero = [r["name"] for r in gb_rows if r["launches"] == 0]
    if zero:
        raise AssertionError(f"benchmark kernels not launched: {zero}")
    rows += gb_rows
    for r in rows:
        r["launches_lts_step"] = lts_launches.get(r["name"], 0)
        r["launches_pdra_step"] = pdra_launches.get(r["name"], 0)
        r["launches_finetune_step"] = ft_launches.get(r["name"], 0)
        r["launches_grad_step"] = grad_launches.get(r["name"], 0)
        r["launches_dp_step"] = dp_launches.get(r["name"], 0)
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(prefix="esr_smoke_") as work:
        tr = train_stage(device, work)
        tr["device"] = smi
        heads_row["launches"] = tr["launches_test_nv"]["eval_heads"]
        emit({"phase": "trainer", **tr})
        torch.cuda.empty_cache()
        lt = lts_stage(device, work)
        lt["device"] = smi
        lts_ckpt = lt.pop("ckpt")
        emit({"phase": "lts_trainer", **lt})
        torch.cuda.empty_cache()
        emit({"phase": "import", **import_reference(device, work, lts_ckpt),
              "device": smi})
        torch.cuda.empty_cache()
        pd = pdra_stage(device, work)
    pd["device"] = smi
    emit({"phase": "pdra_trainer", **pd})
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(prefix="esr_chain_") as work:
        _, captured = chain_stages(device, work, smi)
    for stage, want in (("alphamask", {"splat"}),
                        ("coarse", {"scan_fwd", "scan_bwd", "splat",
                                    "gather_weighted"})):
        seen = {r["kernel"] for r in captured
                if r["site"].startswith(stage + ":")}
        if not want <= seen:
            raise AssertionError(f"captured {stage} step launched only "
                                 f"{sorted(seen)}")
    replay_launches(captured, device)
    del captured
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(prefix="esr_dtu_") as work:
        emit({"phase": "decoders", **check_decoders(work), "device": smi})
        _, dtu_rows = dtu_stages(device, work, smi)
        emit({"phase": "advisor", **advise(work)})
    for r in rows:
        r["launches_dtu_step"] = {
            d["stage"]: d["kernel_launches_per_step"].get(r["name"], 0)
            for d in dtu_rows}
    torch.cuda.empty_cache()

    emit({"kernels": rows + [heads_row]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
