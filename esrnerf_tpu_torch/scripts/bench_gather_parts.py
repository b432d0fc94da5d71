"""Microbenchmark of the piece-sweep gather (K-6) in its three modes.

    python -m esrnerf_tpu_torch.scripts.bench_gather_parts [--device cpu]
        [--mode dma|build|full|all] [--size NPIECE] [--reps N]

Port of ``scripts/bench_gather_parts.py``: one sweep over 64 pieces of
770 tiles of 128 words, each piece read whole (``dma``), read and combined
by adds per tap (``build``), or gathered tap by tap where a lane's index
falls in its window (``full``; the script's ``when`` mode computes the
same). See ``esrnerf_tpu_torch.ops.gather_bench.gather_parts``. The
script's table is all ones; here it is drawn from
``numpy.random.default_rng(0)``. Prints, per mode, the mean time of
``--reps`` back-to-back calls in ms and in us per piece: on the card the
device's time (CUDA events, behind a spin kernel that holds the card while
the host enqueues the calls). ``--device cpu`` runs the plain version.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from esrnerf_tpu_torch.ops import gather_bench as gb
from esrnerf_tpu_torch.utils.device import resolve_device, time_calls

NPIECE = 64


def make_table(npiece: int = NPIECE) -> np.ndarray:
    """A random ``[npiece * NT + 10, 1, 128]`` f32 table (the script's
    shape)."""
    rng = np.random.default_rng(0)
    tiles = npiece * gb.NCAP_T + gb.EXT_T + 8
    return rng.normal(size=(tiles, 1, gb.GROUP)).astype(np.float32)


def run(mode: str, device, npiece: int = NPIECE, reps: int = 10,
        tbl: torch.Tensor | None = None) -> float:
    """Seconds per call; prints the script's line."""
    if tbl is None:
        tbl = torch.as_tensor(make_table(npiece), device=device)
    out = gb.gather_parts(tbl, mode, npiece)
    if not bool(torch.isfinite(out).all()):
        raise AssertionError(f"gather_parts {mode}: non-finite output")
    dt = time_calls(lambda: gb.gather_parts(tbl, mode, npiece), device, reps)
    print(f"{mode:6s}: {dt * 1e3:9.4f} ms total, "
          f"{dt * 1e6 / max(npiece, 1):8.3f} us/piece", flush=True)
    return dt


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", default="cuda")
    p.add_argument("--mode", choices=(*gb.MODES, "all"), default="all")
    p.add_argument("--size", type=int, default=NPIECE, help="pieces")
    p.add_argument("--reps", type=int, default=10)
    args = p.parse_args(argv)
    dev = resolve_device(args.device)
    tbl = torch.as_tensor(make_table(args.size), device=dev)
    for mode in (gb.MODES if args.mode == "all" else (args.mode,)):
        run(mode, dev, args.size, args.reps, tbl)
    return 0


if __name__ == "__main__":
    sys.exit(main())
