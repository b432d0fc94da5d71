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
   the same function;
4. check: one small fine step on the card against the same step on the CPU
   (plain versions): loss terms and every group's gradient;
5. train: the fine-stage train step at full width (cfg/app/fine.yaml: 256^3
   = 16,777,216 voxels, 8,192 rays, 192-wide heads; the benchmark's ball
   scene and budgets) through build_fine_train_step, 3 warm-up and 12
   timed steps; asserts overflow 0, finite losses and that every kernel
   launched during the timed steps; then a torch.profiler breakdown of
   three more steps (one with the TV terms, as in training) by phase and
   by kernel.

Prints one JSON line per phase, then the kernel table as one JSON object,
the nvidia-smi line, and as the last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

H100_BYTES_PER_S = 3.35e12  # HBM3, NVIDIA data sheet (SXM)
H100_F32_OPS_PER_S = 67e12  # f32 outside the tensor cores

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
    "scan_fwd": ("esrnerf_tpu_torch/csrc/scan.cu", "esrnerf_tpu/ops/scan.py:41"),
    "scan_bwd": ("esrnerf_tpu_torch/csrc/scan.cu", "esrnerf_tpu/ops/scan.py:59"),
    "splat": ("esrnerf_tpu_torch/csrc/splat.cu", "esrnerf_tpu/ops/splat.py:50"),
    "gather_weighted": ("esrnerf_tpu_torch/csrc/gather.cu",
                        "esrnerf_tpu/ops/splat.py:403"),
    "gather_raw": ("esrnerf_tpu_torch/csrc/gather.cu",
                   "esrnerf_tpu/ops/splat.py:403"),
}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def sync(device) -> None:
    if device.type == "cuda":
        import torch

        torch.cuda.synchronize(device)


def time_ms(fn, device, runs: int = 5, warmup: int = 2) -> float:
    """Median time of ``fn()`` in ms: CUDA events on the card, the host
    clock around a synchronised call elsewhere."""
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(runs):
        if device.type == "cuda":
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(times))


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


# ------------------------------------------------------------- phase 3


def _scan_inputs(rng, N, S):
    """Per ray a band of ~24 nonzero alphas at a random depth (what the
    fine march's pre-filtered alphas look like), zeros elsewhere."""
    alpha = np.zeros((S, N), np.float32)
    start = rng.integers(0, max(1, S - 24), N)
    for j in range(24):
        rows = np.minimum(start + j, S - 1)
        alpha[rows, np.arange(N)] = rng.uniform(0, 0.5, N)
    ctw = rng.normal(size=(S, N)).astype(np.float32)
    ctl = rng.normal(size=(N,)).astype(np.float32)
    return alpha, ctw, ctl


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

    # K-1 / K-2: [S, N] transmittance scan
    alpha, ctw, ctl = _scan_inputs(rng, N, S)
    a_sn, ctw_sn, ctl_t = on(alpha), on(ctw), on(ctl)
    ee = 1e-3
    w_k, tin_k, last_k = scan_f(a_sn, ee)
    w_p, tin_p, last_p = scanops._fwd_plain(a_sn, ee)
    err = max(assert_close("scan_fwd w", w_k, w_p, 1e-5, 1e-6),
              assert_close("scan_fwd t_in", tin_k, tin_p, 1e-5, 1e-6),
              assert_close("scan_fwd last", last_k, last_p, 1e-5, 1e-6))
    sn = S * N
    row("scan_fwd", err, time_ms(lambda: scan_f(a_sn, ee), device),
        time_ms(lambda: scanops._fwd_plain(a_sn, ee), device),
        4 * (3 * sn + N), 5 * sn, None)
    da_k = scan_b(a_sn, tin_p, ctw_sn, ctl_t, ee)
    da_p = scanops._bwd_plain(a_sn, tin_p, ctw_sn, ctl_t, ee)
    err = assert_close("scan_bwd", da_k, da_p, 1e-4, 1e-5)
    row("scan_bwd", err,
        time_ms(lambda: scan_b(a_sn, tin_p, ctw_sn, ctl_t, ee), device),
        time_ms(lambda: scanops._bwd_plain(a_sn, tin_p, ctw_sn, ctl_t, ee),
                device),
        4 * (4 * sn + N), 9 * sn, None)

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
    err = assert_close("gather_weighted", gw(), gw_p(), 1e-6, 1e-7)
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

    def step(self, params, grads, state, lr_scales=None):
        return grads, state


def check_small_step(device, seed=0):
    """One small fine step on ``device`` against the plain versions on the
    CPU: same parameters and batch; loss terms at rtol 1e-4 and each
    group's gradient within 1e-4 of its max |g|."""
    import torch

    from esrnerf_tpu_torch.apps.fine import build_fine_train_step

    ov = ["app.model.rgbnet_width=32", "app.model.rgbnet_depth=2",
          "app.model.tonemap_width=32", "system.compute_dtype=float32"]
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
    return {"mse": aux_d[0], "mse_cpu": aux_c[0], "k1_frac": aux_d[3],
            "k2_frac": aux_d[4], "max_grad_err_rel": worst}


def train_full_width(device, num_voxels, n_rays, warmup=3, timed=12):
    """The fine train step at full width; returns its metrics and the
    launches per kernel over the timed steps."""
    import torch

    from esrnerf_tpu_torch.apps.fine import build_fine_train_step
    from esrnerf_tpu_torch.ops import kernels
    from esrnerf_tpu_torch.optim import Adam

    t0 = time.perf_counter()
    cfg, model = build_fine(device, num_voxels)
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
    return res, launches


def profile_steps(device, run, n=3):
    """Device time by kernel over ``n`` steps (torch.profiler)."""
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
                 and not e.key.startswith("fine/")),
                key=lambda e: -dev_us(e))
    busy = sum(dev_us(e) for e in ev) / 1e3 / n
    top = [{"name": e.key[:90], "ms_per_step": dev_us(e) / 1e3 / n,
            "calls_per_step": e.count / n} for e in ev[:30]]
    # device time of the kernels launched inside each named step phase
    # (CPU-side ranges; their GPU-side annotation spans are left out)
    phases = {}
    for e in prof.events():
        if e.name.startswith("fine/") and str(e.device_type).endswith("CPU"):
            t = (getattr(e, "device_time_total", None)
                 or getattr(e, "cuda_time_total", 0) or 0)
            ph = phases.setdefault(e.name, {"device_ms": 0.0, "host_ms": 0.0})
            ph["device_ms"] += t / 1e3 / n
            ph["host_ms"] += e.cpu_time_total / 1e3 / n
    ours = {k: sum(dev_us(e) for e in ev if f"{k}_kernel" in e.key) / 1e3 / n
            for k in ("scan_fwd", "scan_bwd", "splat", "gather_weighted",
                      "gather_raw")}
    return {"wall_ms_per_step_profiled": wall / n * 1e3,
            "device_busy_ms_per_step": busy,
            "device_launches_per_step": sum(e.count for e in ev) / n,
            "phases_ms_per_step": phases,
            "port_kernels_ms_per_step": ours, "top": top}


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
    sync(device)

    emit({"phase": "check", **check_small_step(device)})

    res, launches = train_full_width(device, NUM_VOXELS, N_RAYS)
    res["device"] = smi
    emit({"phase": "train", **res})
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")
    for r in rows:
        r["launches"] = launches[r["name"]]

    emit({"kernels": rows})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
