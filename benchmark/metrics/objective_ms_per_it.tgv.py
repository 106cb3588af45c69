"""Device-stream ms an iteration of the traced TGV solves inside the
program's ``pytv.tgv.objective`` spans: each evaluation of the objective
with all it launches (the objective kernel, the sum of its partials, the
write into the loss history).  Nothing to read from a program without the
span."""

from benchmark.metrics import _spans

LAYER = "TGV objective: solvers/tgv.py _iterate, kernels/tgv_stream.py tgv_stream_objective (the kernel, its sum, the history write)"
SOURCE = "program_span"
MOVES = "denoise_gvox_per_s"
PATTERNS = []
SPAN = "pytv.tgv.objective"


def read(run):
    spans = _spans.table(run)
    if spans is None:
        return None
    ms = _spans.device_ms(spans, SPAN)
    if ms is None:
        return None
    return ms / (len(run.trace.spans) * run.facts["n_iter"])
