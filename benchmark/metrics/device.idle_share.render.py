"""Share of a traced render window in which no operation ran on the device,
in %: the window recorded by a profiler of device activity alone, which
leaves the host's pace as it is untraced."""

from benchmark.harness import readers


def read(run):
    return readers.idle_share(run, "render")
