"""Matrix-multiply operations of the measured window of a traced run (the
stage reference's ``eval_flops`` of each march, from the counts it
reported), over the window at the H100 bf16 peak, in %."""

from benchmark.harness import readers


def read(run):
    return readers.mfu(run, "render")
