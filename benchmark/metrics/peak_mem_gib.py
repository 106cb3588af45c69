"""``torch.cuda.max_memory_allocated()`` over the window, reset as it
opens, in GiB."""

from benchmark.metrics import _common

LAYER = None  # end to end
SOURCE = "host_clock"
MOVES = "peak_mem_gib"
PATTERNS = []


def read(run):
    return run.peak_bytes / 2 ** 30 if run.peak_bytes else None
