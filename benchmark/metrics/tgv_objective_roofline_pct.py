"""The TGV objective kernel alone: the bytes each launch must move
(``yardstick_tgv.tgv_objective_bytes``: x, x0 and w, 6 planes in 4d) over
its device time, against the data sheet's HBM rate, in %."""

from benchmark import yardstick_tgv
from benchmark.metrics import _common

LAYER = "TGV kernels: csrc/tgv_stream.cu (B6 passes PQ and XW, the objective kernel)"
SOURCE = "device_trace"
MOVES = "denoise_gvox_per_s"
PATTERNS = ["tgv_obj_kernel"]


def read(run):
    f = run.facts
    return _common.roofline_pct(run, {PATTERNS[0]: yardstick_tgv.tgv_objective_bytes(
        f["shape"], f["mode"], f["bpe"])})
