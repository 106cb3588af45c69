"""Device operations (kernels, copies, memsets) per iteration of the
traced denoising solves, set-up and all."""

from benchmark.metrics import _common

LAYER = "solver loop and dispatch: solvers/cp.py, solvers/gd.py, solvers/inverse.py, kernels/dispatch.py, kernels/fused.py"
SOURCE = "device_trace"
MOVES = "denoise_gvox_per_s"
PATTERNS = []


def read(run):
    return _common.launches_per_it(run)
