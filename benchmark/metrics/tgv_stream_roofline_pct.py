"""B6's two passes, PQ and XW, of the TGV stream: the bytes each launch
must move (``yardstick_tgv.tgv_stream_bytes``, 33 and 30 planes in 4d)
over their device time, against the data sheet's HBM rate, in %."""

from benchmark import yardstick_tgv
from benchmark.metrics import _common

LAYER = "TGV kernels: csrc/tgv_stream.cu (B6 passes PQ and XW, the objective kernel)"
SOURCE = "device_trace"
MOVES = "denoise_gvox_per_s"
PATTERNS = ["tgv_pq_kernel", "tgv_xw_kernel"]


def read(run):
    f = run.facts
    return _common.roofline_pct(run, dict(zip(PATTERNS, yardstick_tgv.tgv_stream_bytes(
        f["shape"], f["mode"], f["bpe"]))))
