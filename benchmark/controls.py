"""Readings that the limits of ``correct`` are set from, on the chip at a
cell's own size (the benchmark's runs do not run this).

    python3 benchmark/controls.py --workload <cell> --seeds <n> [<n> ...]

For each seed it prints one JSON line of the numbers that decide
``correct``:

- ``control``: the reference in the program's place, its heads in float8
  (the precision below the configuration's bfloat16), against the float32
  reference;
- training cells also ``half``: the program with half of each batch left
  out of its steps (the mean over the rest), against the reference on the
  whole batch. A step that returns its state unchanged reads
  ``change_gap`` 1 by construction and needs no run.

The program's own readings (the lower ends) come from the benchmark's
runs.
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def train_readings(cell, seed, dev):
    from benchmark.drivers import train
    from benchmark.harness import compare, core

    out = {}
    ctx = core.Ctx(cell, seed, dev, 0.0, False, time.perf_counter(), "half")
    st = train.setup(ctx)
    st.stage.release()
    st.stage = None
    core.free(dev)
    ref = train.reference_readings(ctx, st)
    control = train.reference_readings(ctx, st, "fp8")
    for name, prog in (("half", st.program), ("control", control)):
        out[name] = compare.train_numbers(prog, ref)
        out[name + "_leaves"] = compare.leaf_gaps(prog, ref)
    return out


def render_readings(cell, seed, dev):
    from benchmark.drivers.render import chunks
    from benchmark.harness import compare, core
    from benchmark.harness import traffic as gen

    config, traffic = cell.config, cell.traffic
    reference = core.part("reference", config["stage"])
    weights = reference.make_weights(config, seed, dev)
    size = int(config["cfg"]["app"]["eval"]["batch_size"])
    outs = {p: [] for p in ("f32", "fp8")}
    src = chunks(gen.render_views(traffic, seed), size)
    while len(outs["f32"]) < int(traffic["sample_chunks"]):
        c = [next(src)]
        r = {p: reference.eval_chunks(config, weights, c, dev, p)[0]
             for p in outs}
        if float(r["f32"]["etc/white_bg"].min()) >= 0.99:
            continue
        for p in outs:
            outs[p].append(r[p])
    return {"control": {"output_gap": compare.output_gap(outs["fp8"],
                                                         outs["f32"])}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    from benchmark.harness import core

    cell = core.Cell.load(args.workload, ROOT)
    dev = torch.device("cuda" if torch.cuda.is_available() else "cpu")
    kind = cell.traffic["kind"]
    for seed in args.seeds:
        t = time.perf_counter()
        res = (train_readings if kind == "train" else render_readings)(
            cell, seed, dev)
        print(json.dumps({"workload": args.workload, "seed": seed, **res,
                          "s": time.perf_counter() - t}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
