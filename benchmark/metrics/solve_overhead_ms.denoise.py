"""Per traced solve, the benchmark's span around the call less the
device's time from the start of its first step kernel (B1 or B2 for CP,
B3 or B4 for GD) to the end of its last: what each solve spends outside
its iterations.  The mean, in ms."""

from benchmark.metrics import _common

LAYER = "solver set-up: models/denoise.py, solvers/cp.py, solvers/gd.py (state allocation, the copy of x0, the dual's layout in and out)"
SOURCE = "program_span"
MOVES = "denoise_gvox_per_s"
PATTERNS = ["cp_dual_spec_kernel", "cp_primal_spec_kernel", "tv_norms_spec_kernel", "tv_subgrad_spec_kernel"]


def read(run):
    return _common.solve_overhead_ms(run, "|".join(PATTERNS))
