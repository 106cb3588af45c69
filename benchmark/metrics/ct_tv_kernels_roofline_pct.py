"""B5, B2 and B3 of the CT iteration's TV half: the bytes each launch
must move (``yardstick.ct_tv_bytes``) over their device time, against
the data sheet's HBM rate, in %."""

from benchmark import yardstick
from benchmark.metrics import _common

LAYER = "kernels: csrc/specialised.cu, csrc/specialised_tv.cu"
SOURCE = "device_trace"
MOVES = "recon_gvox_per_s"
PATTERNS = ["tv_dual_spec_kernel", "cp_primal_spec_kernel", "tv_norms_spec_kernel"]


def read(run):
    f = run.facts
    return _common.roofline_pct(run, dict(zip(PATTERNS, yardstick.ct_tv_bytes(
        f["shape"], f["Nd"], f["bpe"], f["dual_bpe"]))))
