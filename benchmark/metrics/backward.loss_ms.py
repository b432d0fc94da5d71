"""Device ms per traced training step of the operations launched inside the
backward's range of the loss terms, the smooth-gradient TV included
(<stage>/bwd_loss, on the autograd engine's thread)."""

from benchmark.harness import readers


def read(run):
    return readers.range_ms(run, "train", lambda n: n.endswith("/bwd_loss"))
