"""The 95th percentile of the window's reconstruction times, each from
the call to the host read of its last loss."""

from benchmark.metrics import _common

LAYER = None  # end to end
SOURCE = "host_clock"
MOVES = "recon_solve_ms_p95"
PATTERNS = []


def read(run):
    return _common.p95_ms(run)
