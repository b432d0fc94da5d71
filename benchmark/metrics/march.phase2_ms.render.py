"""Device ms per traced eval chunk of the operations launched inside the
march's range march/phase2: compaction to the head budget, cell sort,
counts."""

from benchmark.harness import readers


def read(run):
    return readers.range_ms(run, "render",
                            lambda n: n.endswith("march/phase2"))
