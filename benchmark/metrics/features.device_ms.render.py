"""Device ms per traced eval chunk of the operations launched inside the
eval forward's head features and normals range (<stage>/features)."""

from benchmark.harness import readers


def read(run):
    return readers.range_ms(run, "render", lambda n: n.endswith("/features"))
