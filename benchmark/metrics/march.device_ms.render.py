"""Device ms per traced eval chunk of the operations launched inside the
march ranges."""

from benchmark.harness import readers


def read(run):
    return readers.range_ms(run, "render", readers.is_march)
