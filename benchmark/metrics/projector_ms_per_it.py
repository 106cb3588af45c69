"""Device ms per CT iteration in the projector's FFT and matrix-product
kernels (cuFFT and cuBLAS names: ``PATTERNS``)."""

from benchmark.metrics import _common

LAYER = "projector: models/ct_spectral.py, the spectral parallel-beam pair"
SOURCE = "device_trace"
MOVES = "recon_gvox_per_s"
PATTERNS = ["fft", "gemm", "gemv", "xmma", "cutlass"]


def read(run):
    return _common.device_ms_per_it(run, "|".join(PATTERNS))
