"""Design variants of the transmittance scan (K-1, K-2) timed beside the kept
design on one GPU.

    python -m esrnerf_tpu_torch.scripts.bench_scan_ring [--rays N]
        [--samples S] [--runs R]

Builds ``csrc/scan.cu`` again into ``build/scan_variants/``, once per
variant, all ``nvcc`` processes started together:

- ``stages2``, ``stages8``: the ring's depth capped at 2 or 8 tiles
  (``-DESR_SCAN_MAX_STAGES``; the kept design caps it at 4);
- ``interleaved``: K-2 walks each tile in one loop, each sample's division
  before the next sample's add, instead of the tile's carried sums first
  and its 32 divisions after (the source's ``bwd_tile`` replaced).

Every variant must give the kept library's outputs bitwise. Two inputs at
the fine step's shape (8,192 rays x 896 samples by default), from
``numpy.random.default_rng(0)``:

- ``bands``: ``chip_smoke.py``'s kernels phase: per ray 24 alphas in
  [0, 0.5) at a random depth, unit normal cotangents;
- ``opaque``: the step's kind: after the band a run of alphas exactly 1
  (about a quarter of the samples), about two nonzero ``ct_w`` per ray of
  order 1e-5, ``ct_last`` of order 1e-5.

The kept design and the variants are timed in the order kept, variants,
variants reversed, kept, each reading the median over ``--runs`` of 10
back-to-back calls (CUDA events behind a spin kernel that holds the card
while the host enqueues them). Prints the card's name and power limit, the
``ptxas`` registers and spills of each build, and one JSON line per variant
and input with the ring depth and both readings in ms.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import time
from typing import Dict

import numpy as np
import torch

from esrnerf_tpu_torch.ops import kernels
from esrnerf_tpu_torch.utils.device import resolve_device

VARIANT_DIR = os.path.join(kernels.BUILD_DIR, "scan_variants")

# K-2's tile walked in one loop: the division of sample j uses the A carried
# before sample j is added, as the kept order does, so results are bitwise
INTERLEAVED_BWD_TILE = r"""template <bool kTail>
__device__ __forceinline__ void bwd_tile(const float* at, const float* tt,
                                         const float* ct, float* dt, int lane,
                                         float ee, int valid, float& A) {
#pragma unroll
  for (int c = kTileS / 4 - 1; c >= 0; --c) {
    const int o = swz(lane, c);
    const float4 a4 = ld4(at + o), t4 = ld4(tt + o), c4 = ld4(ct + o);
    const float av[4] = {a4.x, a4.y, a4.z, a4.w};
    const float tv[4] = {t4.x, t4.y, t4.z, t4.w};
    const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
    float dv[4];
#pragma unroll
    for (int q = 3; q >= 0; --q) {
      const bool in = !kTail || 4 * c + q < valid;
      const bool live = tv[q] >= ee;
      const float a_eff = live ? av[q] : 0.f;
      const float den = fmaxf(__fsub_rn(1.f, a_eff), 1e-10f);
      const bool one = den == 1.f;
      const float quot = __fdiv_rn(one ? 1.f : A, one ? 1.f : den);
      const float grad =
          __fsub_rn(__fmul_rn(tv[q], cv[q]), one ? A : quot);
      dv[q] = (live && in) ? grad : 0.f;
      if (in) A = __fadd_rn(A, __fmul_rn(__fmul_rn(a_eff, tv[q]), cv[q]));
    }
    st4(dt + o, dv[0], dv[1], dv[2], dv[3]);
  }
}
"""

_BWD_TILE = re.compile(
    r"template <bool kTail>\n__device__ __forceinline__ void bwd_tile\(.*?\n}\n",
    re.S)


def variant_sources() -> Dict[str, str]:
    """Variant name -> the text of ``scan.cu`` it is built from."""
    with open(os.path.join(kernels.CSRC, "scan.cu")) as f:
        src = f.read()
    if len(_BWD_TILE.findall(src)) != 1:
        raise RuntimeError("scan.cu: bwd_tile not found once; update "
                           "bench_scan_ring.py's interleaved variant")
    return {
        "stages2": "#define ESR_SCAN_MAX_STAGES 2\n" + src,
        "stages8": "#define ESR_SCAN_MAX_STAGES 8\n" + src,
        "interleaved": _BWD_TILE.sub(lambda _: INTERLEAVED_BWD_TILE, src),
    }


def build_variants() -> Dict[str, ctypes.CDLL]:
    """Compile every variant in parallel; returns the loaded libraries."""
    os.makedirs(VARIANT_DIR, exist_ok=True)
    procs = {}
    for name, text in variant_sources().items():
        src = os.path.join(VARIANT_DIR, f"scan_{name}.cu")
        with open(src, "w") as f:
            f.write(text)
        out = os.path.join(VARIANT_DIR, f"libscan_{name}.so")
        cmd = [kernels._nvcc(), *kernels.NVCC_FLAGS, "-I", kernels.CSRC,
               "-o", out, src]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       out)
    libs, failed = {}, []
    for name, (p, out) in procs.items():
        log, _ = p.communicate()
        if p.returncode != 0:
            failed.append(f"--- {name} (exit {p.returncode})\n{log}")
            continue
        regs = [ln.strip() for ln in log.splitlines()
                if "registers" in ln or "spill" in ln]
        print(json.dumps({"build": name, "ptxas": regs}), flush=True)
        so = ctypes.CDLL(out)
        for fn, args in kernels._SIGNATURES["scan"].items():
            getattr(so, fn).argtypes = args
            getattr(so, fn).restype = ctypes.c_int
        so.esr_error_string.argtypes = [ctypes.c_int]
        so.esr_error_string.restype = ctypes.c_char_p
        libs[name] = so
    if failed:
        raise RuntimeError("variant build failed:\n" + "\n".join(failed))
    return libs


def make_inputs(kind: str, N: int, S: int, device):
    """``(alpha, ct_w [N, S], ct_last [N])`` on ``device``."""
    rng = np.random.default_rng(0)
    alpha = np.zeros((N, S), np.float32)
    start = rng.integers(0, max(1, S // 2), N)
    rows = np.arange(N)
    for j in range(24):
        alpha[rows, np.minimum(start + j, S - 1)] = rng.uniform(0, 0.5, N)
    if kind == "bands":
        ctw = rng.normal(size=(N, S)).astype(np.float32)
        ctl = rng.normal(size=(N,)).astype(np.float32)
    else:
        run = rng.integers(S // 8, S // 3, N)
        cols = np.arange(S)[None, :]
        lo = (start + 24)[:, None]
        alpha[(cols >= lo) & (cols < lo + run[:, None])] = 1.0
        keep = rng.uniform(size=(N, S)) < 2.0 / S
        ctw = np.where(keep, 1e-5 * rng.normal(size=(N, S)), 0.0)
        ctl = 1e-5 * rng.normal(size=(N,))
    return tuple(torch.as_tensor(np.asarray(x, np.float32), device=device)
                 for x in (alpha, ctw, ctl))


def launchers(so: ctypes.CDLL, alpha, ctw, ctl, ee: float):
    """``(fwd(), bwd(t_in))`` calling ``so``'s entry points as
    ``ops/kernels.py`` does, outputs allocated once."""
    N, S = alpha.shape
    w, t_in, da = (torch.empty_like(alpha) for _ in range(3))
    last = torch.empty((N,), dtype=torch.float32, device=alpha.device)
    stream = kernels._stream(alpha)
    p = kernels._ptr

    def fwd():
        kernels._check("scan_fwd", so, so.esr_scan_fwd(
            p(alpha), p(w), p(t_in), p(last), S, N, ee,
            int(kernels.scan_tma_ok(S, alpha, w, t_in)), stream))
        return w, t_in, last

    def bwd(tin):
        kernels._check("scan_bwd", so, so.esr_scan_bwd(
            p(alpha), p(tin), p(ctw), p(ctl), p(da), S, N, ee,
            int(kernels.scan_tma_ok(S, alpha, tin, ctw, da)), stream))
        return da

    return fwd, bwd


def time_ms(fn, runs: int, calls: int = 10) -> float:
    """Median over ``runs`` of the mean device time of ``calls``
    back-to-back calls, behind a spin kernel (``torch.cuda._sleep``) that
    holds the card while the host enqueues them."""
    fn()
    times = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
        torch.cuda._sleep(int(min(2e9, (2 * calls * host_s + 1e-3) * 2e9)))
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(calls):
            fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / calls)
    return float(np.median(times))


def ring(so: ctypes.CDLL, S: int, N: int, backward: bool) -> int:
    stages, smem = ctypes.c_int(), ctypes.c_int()
    kernels._check("scan_config", so, so.esr_scan_config(
        S, N, int(backward), ctypes.byref(stages), ctypes.byref(smem)))
    return stages.value


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--rays", type=int, default=8192)
    p.add_argument("--samples", type=int, default=896)
    p.add_argument("--runs", type=int, default=5)
    args = p.parse_args(argv)
    dev = resolve_device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip().splitlines()[0] if smi.returncode == 0
          else "nvidia-smi: not available", flush=True)
    libs = {"kept": kernels.lib("scan"), **build_variants()}
    N, S, ee = args.rays, args.samples, 1e-3
    names = [n for n in libs if n != "kept"]
    order = ["kept", *names, *names[::-1], "kept"]
    for kind in ("bands", "opaque"):
        alpha, ctw, ctl = make_inputs(kind, N, S, dev)
        calls = {n: launchers(so, alpha, ctw, ctl, ee) for n, so in
                 libs.items()}
        w0, tin0, last0 = (x.clone() for x in calls["kept"][0]())
        da0 = calls["kept"][1](tin0).clone()
        for n, (fwd, bwd) in calls.items():
            for got, want in zip((*fwd(), bwd(tin0)), (w0, tin0, last0, da0)):
                if not torch.equal(got, want):
                    raise AssertionError(f"{n} ({kind}): not bitwise equal "
                                         "to the kept design")
        ms = {n: {"fwd": [], "bwd": []} for n in libs}
        for n in order:
            fwd, bwd = calls[n]
            ms[n]["fwd"].append(time_ms(fwd, args.runs))
            ms[n]["bwd"].append(time_ms(lambda: bwd(tin0), args.runs))
        for n, so in libs.items():
            print(json.dumps({
                "variant": n, "input": kind, "N": N, "S": S,
                "stages_fwd": ring(so, S, N, False),
                "stages_bwd": ring(so, S, N, True),
                "fwd_ms": ms[n]["fwd"], "bwd_ms": ms[n]["bwd"]}), flush=True)
        del calls, w0, tin0, last0, da0
    return 0


if __name__ == "__main__":
    sys.exit(main())
