"""Device ms per traced training step of the operations launched inside the
LTS forward's BRDF ranges (lts/brdf: BRDFNet and EmissionNet at the march
points and at the eps-perturbed points, the normal perturbation)."""

from benchmark.harness import readers


def read(run):
    return readers.range_ms(run, "train", lambda n: n == "lts/brdf")
