"""Share of the LTS training forwards that drew their own keyed draws: the
program's counters lts.draws_keyed over lts.draws_keyed + lts.draws_given
(every forward of the run), in %. A program without them reads nothing."""

from benchmark.harness import readers, spans


def read(run):
    if not readers.traced(run, "train"):
        return None
    keyed = spans.counter("lts.draws_keyed") or 0
    calls = keyed + (spans.counter("lts.draws_given") or 0)
    if not calls:
        return None
    return 100.0 * keyed / calls
