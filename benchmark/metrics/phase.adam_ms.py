"""Device ms per traced step of the operations launched inside the step's
optimizer range (<stage>/adam)."""

from benchmark.harness import readers


def read(run):
    return readers.range_ms(run, "train", lambda n: n.endswith("/adam"))
