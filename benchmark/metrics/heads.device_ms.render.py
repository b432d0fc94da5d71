"""Device ms per traced eval chunk of the operations launched inside the
eval forward's heads, tone-mapper and per-ray sums range (<stage>/heads)."""

from benchmark.harness import readers


def read(run):
    return readers.range_ms(run, "render", lambda n: n.endswith("/heads"))
