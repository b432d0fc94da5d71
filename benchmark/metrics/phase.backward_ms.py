"""Device ms per traced step of the operations launched inside the step's
backward range (<stage>/backward)."""

from benchmark.harness import readers


def read(run):
    return readers.range_ms(run, "train", lambda n: n.endswith("/backward"))
