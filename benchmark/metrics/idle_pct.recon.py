"""The traced window's share with no device operation running, in %."""

from benchmark.metrics import _common

LAYER = "device"
SOURCE = "device_trace"
MOVES = "recon_gvox_per_s"
PATTERNS = []


def read(run):
    return _common.idle_pct(run)
