"""The program's spans on the card: a small fused CP solve under a
profiler gives device-stream times above 0 in ``span_table()``, its
``pytv.solve`` span holds at least the sum of its ``pytv.iter`` spans, and
lasts no longer than the host's wall time of the call.  Needs a CUDA device
and ``nvcc``, and skips without them."""

import time

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pytv4d_tpu_torch.core.config import TVConfig
from pytv4d_tpu_torch.solvers.cp import chambolle_pock
from pytv4d_tpu_torch.utils import profiling

N_ITER = 20


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the spans time the device stream")


def test_span_table_times_the_device_stream(card):
    x = torch.rand((4, 4, 128, 128), device="cuda")
    cfg = TVConfig(scheme="hybrid", reg_time=0.5)
    chambolle_pock(x, n_iter=2, cfg=cfg)  # builds and warms the kernels
    torch.cuda.synchronize()
    profiling.clear_spans()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        t0 = time.perf_counter()
        chambolle_pock(x, n_iter=N_ITER, cfg=cfg)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    table = profiling.span_table()
    profiling.clear_spans()
    (n_solve, solve_ms), (n_iter, iter_ms) = (
        table[profiling.SOLVE_SPAN], table[profiling.ITER_SPAN])
    assert (n_solve, n_iter) == (1, N_ITER)
    assert 0 < iter_ms <= solve_ms <= wall_ms
