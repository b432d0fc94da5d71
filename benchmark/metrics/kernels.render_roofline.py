"""The port's hand-written kernels in the traced eval chunks: the sum of
each launch's bound over the sum of their device time, in %."""

from benchmark.harness import readers


def read(run):
    return readers.kernels_roofline(run, "render")
