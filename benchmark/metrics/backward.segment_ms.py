"""Device ms per traced training step of the operations launched inside the
backward's range of the light transport segment: the secondary march, its
heads, the BRDF responses and the envmap (lts/bwd_segment, on the autograd
engine's thread)."""

from benchmark.harness import readers


def read(run):
    return readers.range_ms(run, "train",
                            lambda n: n.endswith("/bwd_segment"))
