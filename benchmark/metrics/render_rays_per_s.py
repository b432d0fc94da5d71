"""Rays rendered and copied back to the host in the window, over its
seconds (host clock)."""

from benchmark.harness import readers


def read(run):
    return readers.rate(run, "render")
