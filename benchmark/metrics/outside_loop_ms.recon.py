"""Per traced reconstruction, the device-stream time of the program's
``pytv.solve`` span less that of its ``pytv.iter`` spans: what
``cp_reconstruct`` spends on the device outside its iterations (the zero
start and its copy up, the first ``A(x)``, the dual's zeros, the state's
layout out), idle time included.  The mean, in ms."""

from benchmark.metrics import _spans

LAYER = "CT solve set-up: models/ct.py cp_reconstruct, solvers/inverse.py (projector choice, the zero start and its copy up, the first A(x), the dual's zeros)"
SOURCE = "program_span"
MOVES = "recon_gvox_per_s"
PATTERNS = []


def read(run):
    return _spans.outside_loop_ms(run)
