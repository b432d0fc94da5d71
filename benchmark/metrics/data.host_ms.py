"""Host ms per training step of the program's sampler and the batch's
placement: the medians of the program's spans data/sample and data/place
(its span record, every step of the run)."""

from benchmark.harness import readers, spans


def read(run):
    if not readers.traced(run, "train"):
        return None
    parts = [spans.median_ms(n) for n in ("data/sample", "data/place")]
    return None if None in parts else sum(parts)
