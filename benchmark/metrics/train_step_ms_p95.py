"""95th percentile of the training steps of the window: each the interval
between CUDA events recorded after consecutive steps (no extra
synchronisation; host stalls included)."""

from benchmark.harness import readers


def read(run):
    return readers.percentile_ms(run, "train", 95.0)
