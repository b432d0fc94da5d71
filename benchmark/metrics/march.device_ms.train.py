"""Device ms per traced training step of the operations launched inside the
march ranges (<stage>/march, lts/march_2nd)."""

from benchmark.harness import readers


def read(run):
    return readers.range_ms(run, "train", readers.is_march)
