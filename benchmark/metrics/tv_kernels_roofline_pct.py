"""B3 and B4 of the TV subgradient: the bytes each launch must move
(``yardstick.tv_bytes``) over their device time, against the data
sheet's HBM rate, in %."""

from benchmark import yardstick
from benchmark.metrics import _common

LAYER = "kernels: csrc/specialised.cu, csrc/specialised_tv.cu"
SOURCE = "device_trace"
MOVES = "denoise_gvox_per_s"
PATTERNS = ["tv_norms_spec_kernel", "tv_subgrad_spec_kernel"]


def read(run):
    f = run.facts
    return _common.roofline_pct(
        run, dict(zip(PATTERNS, yardstick.tv_bytes(f["shape"], f["bpe"]))))
