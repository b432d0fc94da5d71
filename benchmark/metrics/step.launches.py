"""Device kernels per traced training step."""

from benchmark.harness import readers


def read(run):
    if not readers.traced(run, "train"):
        return None
    return run.summary.kernels() / run.trace_units
