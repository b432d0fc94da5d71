"""Re-marches per eval chunk after a march-budget overflow: the program's
counters eval.retries over eval.chunks (every chunk of the run)."""

from benchmark.harness import readers, spans


def read(run):
    if not readers.traced(run, "render"):
        return None
    chunks = spans.counter("eval.chunks")
    if not chunks:
        return None
    return (spans.counter("eval.retries") or 0) / chunks
