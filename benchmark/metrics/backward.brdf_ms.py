"""Device ms per traced training step of the operations launched inside the
backward's range of the BRDF heads (BRDFNet and EmissionNet at the march
points) and of the normal perturbation (lts/bwd_brdf, on the autograd
engine's thread)."""

from benchmark.harness import readers


def read(run):
    return readers.range_ms(run, "train", lambda n: n.endswith("/bwd_brdf"))
