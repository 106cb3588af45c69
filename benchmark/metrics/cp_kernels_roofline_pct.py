"""B1 and B2 of the CP step: the bytes each launch must move
(``yardstick.cp_step_bytes``, each array once) over their device time,
against the data sheet's HBM rate, in %."""

from benchmark import yardstick
from benchmark.metrics import _common

LAYER = "kernels: csrc/specialised.cu, csrc/specialised_tv.cu"
SOURCE = "device_trace"
MOVES = "denoise_gvox_per_s"
PATTERNS = ["cp_dual_spec_kernel", "cp_primal_spec_kernel"]


def read(run):
    f = run.facts
    b1, b2 = yardstick.cp_step_parts(f["shape"], f["Nd"], f["bpe"],
                                     f["dual_bpe"])
    return _common.roofline_pct(run, dict(zip(PATTERNS, (b1, b2))))
