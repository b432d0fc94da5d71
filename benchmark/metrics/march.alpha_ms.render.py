"""Device ms per traced eval chunk of the operations launched inside the
march's range march/alpha: SDF samples, dense bridge, NeuS alpha."""

from benchmark.harness import readers


def read(run):
    return readers.range_ms(run, "render",
                            lambda n: n.endswith("march/alpha"))
