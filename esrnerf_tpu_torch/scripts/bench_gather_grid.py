"""Microbenchmark of the per-chunk windowed gather (K-5).

    python -m esrnerf_tpu_torch.scripts.bench_gather_grid [--device cpu]
        [--span tight|random|both] [--size NCH] [--reps N]

Port of ``scripts/bench_gather_grid.py``: 64 chunks, each 16 groups x 128
lanes x 4 offset families x 6 taps read from its own 98,304-word window of
the table (``esrnerf_tpu_torch.ops.gather_bench.gather_grid``). The inputs
are the script's, from ``numpy.random.default_rng(0)``: chunk windows
``w0 = c * GCAP``; group spans either tight (100 words from ``w0 + 64``) or
random (a start in the window's first half, a length up to a third of it);
lane indices up to 100 words past the span's start. The script's table is
all ones; here it is drawn from the same generator after those inputs, so
a wrong index shows. Prints, per span, the mean time of ``--reps``
back-to-back calls in ms and in us per chunk: on the card the device's
time (CUDA events, behind a spin kernel that holds the card while the host
enqueues the calls). ``--device cpu`` runs the plain version.
"""

from __future__ import annotations

import argparse
import sys
from typing import Dict

import numpy as np
import torch

from esrnerf_tpu_torch.ops import gather_bench as gb
from esrnerf_tpu_torch.utils.device import resolve_device, time_calls

NCH = 64


def make_inputs(tight_span: bool, nch: int = NCH) -> Dict[str, np.ndarray]:
    """The script's inputs (``run()``) for ``nch`` chunks, plus a random
    table of ``nch * NT + 10`` tiles."""
    rng = np.random.default_rng(0)
    w0 = np.arange(nch, dtype=np.int32) * gb.GCAP
    if tight_span:
        gf = np.repeat(w0[:, None], 16, 1) + 64
        gl = gf + 100
    else:
        gf = np.repeat(w0[:, None], 16, 1) + rng.integers(0, gb.GCAP // 2,
                                                          (nch, 16))
        gl = gf + rng.integers(0, gb.GCAP // 3, (nch, 16))
    idx = np.clip(gf[:, :, None] + rng.integers(0, 100, (nch, 16, gb.GROUP)),
                  0, None).astype(np.int32).reshape(nch * 16, gb.GROUP)
    tiles = nch * gb.NCAP_T + gb.EXT_T + 8
    tbl = rng.normal(size=(tiles, 1, gb.GROUP)).astype(np.float32)
    return {"tbl": tbl, "idx": idx, "w0": w0, "gf": gf.astype(np.int32),
            "gl": gl.astype(np.int32)}


def to_device(inputs: Dict[str, np.ndarray], device) -> Dict[str, torch.Tensor]:
    return {k: torch.as_tensor(v, device=device) for k, v in inputs.items()}


def run(tight_span: bool, device, nch: int = NCH, reps: int = 10) -> float:
    """Seconds per call at the script's inputs; prints the script's line."""
    a = to_device(make_inputs(tight_span, nch), device)
    out = gb.gather_grid(a["tbl"], a["idx"], a["w0"], a["gf"], a["gl"])
    if not bool(torch.isfinite(out).all()):
        raise AssertionError("gather_grid: non-finite output")
    dt = time_calls(lambda: gb.gather_grid(a["tbl"], a["idx"], a["w0"],
                                           a["gf"], a["gl"]), device, reps)
    print(f"grid=({nch}) tight={tight_span}: {dt * 1e3:9.4f} ms total, "
          f"{dt * 1e6 / max(nch, 1):8.3f} us/chunk", flush=True)
    return dt


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--span", choices=("tight", "random", "both"),
                   default="both")
    p.add_argument("--size", type=int, default=NCH, help="chunks")
    p.add_argument("--reps", type=int, default=10)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    spans = {"tight": [True], "random": [False], "both": [True, False, True]}
    for tight in spans[args.span]:
        run(tight, dev, args.size, args.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
