"""Device ms per traced training step of the operations launched inside the
backward's range of the head features: SDF taps, normals, encodings
(<stage>/bwd_features, on the autograd engine's thread)."""

from benchmark.harness import readers


def read(run):
    return readers.range_ms(run, "train",
                            lambda n: n.endswith("/bwd_features"))
