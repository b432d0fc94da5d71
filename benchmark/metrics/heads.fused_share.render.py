"""Share of the eval forward's head calls that ran the fused heads kernel:
the program's counters eval.heads_fused over eval.heads_fused +
eval.heads_eager (every chunk of the run), in %. A program without them
reads nothing."""

from benchmark.harness import readers, spans


def read(run):
    if not readers.traced(run, "render"):
        return None
    fused = spans.counter("eval.heads_fused") or 0
    calls = fused + (spans.counter("eval.heads_eager") or 0)
    if not calls:
        return None
    return 100.0 * fused / calls
