"""The port's hand-written kernels (scan_fwd, scan_bwd, splat,
gather_weighted, gather_raw) in the traced training steps: the sum of
each launch's bound over the sum of their device time, in %."""

from benchmark.harness import readers


def read(run):
    return readers.kernels_roofline(run, "train")
