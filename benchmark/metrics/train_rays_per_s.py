"""Primary rays of all training steps completed in the window, over the
window's seconds (host clock; the window ends with a synchronise)."""

from benchmark.harness import readers


def read(run):
    return readers.rate(run, "train")
