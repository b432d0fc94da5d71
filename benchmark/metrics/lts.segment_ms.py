"""Device ms per traced training step of the operations launched inside the
light transport segment's range (lts/lts: the surface points' selection,
their radiance and BRDF responses, the secondary march and its heads, the
envmap)."""

from benchmark.harness import readers


def read(run):
    return readers.range_ms(run, "train", lambda n: n == "lts/lts")
