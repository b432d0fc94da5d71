"""Device ms per traced training step of the operations launched inside the
LTS forward's draw ranges (lts/draws: the keyed hashes of the head rows and
of the chosen points' scattering normals)."""

from benchmark.harness import readers


def read(run):
    return readers.range_ms(run, "train", lambda n: n == "lts/draws")
