"""Voxel-iterations of the window's CT reconstructions over the whole
window, in billions a second."""

from benchmark.metrics import _common

LAYER = None  # end to end
SOURCE = "host_clock"
MOVES = "recon_gvox_per_s"
PATTERNS = []


def read(run):
    return _common.gvox_per_s(run)
