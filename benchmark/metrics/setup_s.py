"""From the process's start to the first timed call: imports, the
kernels" build where the checkout has none, the inputs and a warm solve."""

from benchmark.metrics import _common

LAYER = None  # end to end
SOURCE = "host_clock"
MOVES = "setup_s"
PATTERNS = []


def read(run):
    return run.setup_s
