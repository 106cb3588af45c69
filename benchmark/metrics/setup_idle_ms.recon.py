"""Per traced reconstruction, the device's idle time between the host's
start of the program's ``pytv.solve`` span and the host's start of its
first ``pytv.iter`` span, on the trace's clock: how long the card waits
on the host while ``cp_reconstruct`` sets up.  The mean, in ms."""

from benchmark.metrics import _spans

LAYER = "CT solve set-up: models/ct.py cp_reconstruct, solvers/inverse.py (projector choice, the zero start and its copy up, the first A(x), the dual's zeros)"
SOURCE = "program_span"
MOVES = "recon_gvox_per_s"
PATTERNS = []


def read(run):
    return _spans.setup_idle_ms(run)
