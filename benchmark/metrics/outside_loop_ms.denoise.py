"""Per traced solve, the device-stream time of the program's ``pytv.solve``
span less that of its ``pytv.iter`` spans: what a denoising solve spends on
the device outside its iterations (set-up and teardown: the zero duals,
the copy of x0, the dual's layout out), idle time included.  The mean, in
ms."""

from benchmark.metrics import _spans

LAYER = "solver set-up: models/denoise.py, solvers/cp.py, solvers/gd.py (state allocation, the copy of x0, the dual's layout in and out)"
SOURCE = "program_span"
MOVES = "denoise_gvox_per_s"
PATTERNS = []


def read(run):
    return _spans.outside_loop_ms(run)
