"""Device ms per traced training step of the operations launched inside the
LTS secondary march's range (lts/march_2nd: the march of the surface
points' secondary rays)."""

from benchmark.harness import readers


def read(run):
    return readers.range_ms(run, "train", lambda n: n == "lts/march_2nd")
