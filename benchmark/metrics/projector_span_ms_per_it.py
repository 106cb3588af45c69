"""Device-stream ms per CT iteration inside the program's
``pytv.project.A`` and ``pytv.project.A_T`` spans: the projector with all
it launches (FFTs, matrix products and its permutes, ``cat``s and copies),
where ``projector_ms_per_it`` counts its FFT and GEMM kernels by name."""

from benchmark.metrics import _spans

LAYER = "projector: models/ct_spectral.py, the spectral parallel-beam pair"
SOURCE = "program_span"
MOVES = "recon_gvox_per_s"
PATTERNS = []


def read(run):
    return _spans.projector_ms_per_it(run)
