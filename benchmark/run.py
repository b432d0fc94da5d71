"""The benchmark of the PyTorch and CUDA port (``esrnerf_tpu_torch``).

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout. ``<cell>`` is a workload of ``BENCHMARK.json``;
its configuration (``benchmark/configs/<name>.json``), traffic mix
(``benchmark/traffic/<name>.json``) and metrics (``benchmark/metrics/<name>
.py``) are found by name, the stage's driver by the mix's ``kind``
(``benchmark/drivers/<kind>.py``), and the program's stage and its plain
reference by the configuration's ``stage`` (``benchmark/stages/<stage>.py``,
``benchmark/reference/<stage>.py``).

A run makes its weights and inputs from the seed, warms up, measures for
``--seconds`` (``--trace 0``: the cell's end-to-end metrics) or traces a fixed
number of steps or chunks twice, recording host and device activity and
then device activity alone (``--trace 1``: its per-layer metrics and a
breakdown from the first trace, the device's busy and window seconds from
the second),
checks what the timed path produced against the reference, and prints one
JSON line last. It needs a CUDA device: without one, or with fewer than the
cell asks for, it exits 3 and prints no result. The kernels build into
``esrnerf_tpu_torch/build/`` and any Triton or extension cache into
``.bench_cache/``, both inside the checkout.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    sys.path.insert(0, ROOT)
    from benchmark.harness import core

    cell = core.Cell.load(args.workload, ROOT)
    cache = os.path.join(ROOT, ".bench_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache,
                                                      "torch_extensions")

    import torch

    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); found "
              f"{found}", file=sys.stderr)
        return 3
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    torch.zeros((), device=dev)  # the CUDA context
    ctx = core.Ctx(cell, args.seed, dev, args.seconds, bool(args.trace), T0)
    ctx.mark("context")
    out = core.part("drivers", cell.traffic["kind"]).run(ctx)

    bad = core.forbidden_modules()
    if bad:
        print(f"forbidden modules loaded: {bad}", file=sys.stderr)
        return 4
    rec, checks = out["run"], out["checks"]
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
              "count": cell.chips,
              "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": all(c.ok for c in checks),
              "attempted": out["attempted"], "failed": out["failed"]}
    if args.trace:
        result["metrics"] = core.read_metrics(rec, cell.per_layer)
        device["busy_s"] = rec.busy_s
        device["window_s"] = rec.busy_window_s
        result["device"] = device
        result["breakdown"] = rec.summary.breakdown()
    else:
        result["metrics"] = core.read_metrics(rec, cell.end_to_end)
        result["device"] = device
        print(f"{rec.units} {rec.kind} units in {rec.window_s!r} s; "
              f"{len(rec.unit_ms)} step intervals", file=sys.stderr)
    core.emit(result, checks)
    return 0


if __name__ == "__main__":
    sys.exit(main())
