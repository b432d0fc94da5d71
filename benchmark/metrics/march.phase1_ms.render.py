"""Device ms per traced eval chunk of the operations launched inside the
march's range march/phase1: ray-box clip, occupancy test, phase-1
compaction, points, exact re-test."""

from benchmark.harness import readers


def read(run):
    return readers.range_ms(run, "render",
                            lambda n: n.endswith("march/phase1"))
