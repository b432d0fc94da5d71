"""Host ms a chunk waits on its march's overflow (the blocking read that
ends each eval chunk): the median of the program's span
eval/overflow_wait (its span record, every chunk of the run)."""

from benchmark.harness import readers, spans


def read(run):
    if not readers.traced(run, "render"):
        return None
    return spans.median_ms("eval/overflow_wait")
