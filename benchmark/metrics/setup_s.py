"""Seconds from the process's start to the first timed step or chunk:
imports, the CUDA context, the kernels' build or load, weights, inputs
and warm-up."""


def read(run):
    return run.setup_s if not run.traced else None
