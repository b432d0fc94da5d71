"""Matrix-multiply operations of the measured window of a traced run (the
stage reference's ``train_flops`` of each step, from the counters the march
reported for it), over the window at the H100 bf16 peak, in %."""

from benchmark.harness import readers


def read(run):
    return readers.mfu(run, "train")
