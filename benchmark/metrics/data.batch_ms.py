"""Host ms per step (the measured window of a traced run) of the stage's
sampler and the batch's placement on the device (the benchmark's spans
around the two calls)."""

from benchmark.harness import readers


def read(run):
    if not readers.traced(run, "train") or not run.data_ms:
        return None
    return sum(run.data_ms) / len(run.data_ms)
