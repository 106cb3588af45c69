"""The readers of the program's spans (``metrics/_spans.py``) on a
synthetic run: a hand-made trace and a span table filled through
``pytv4d_tpu_torch.utils.profiling``'s own spans, their CUDA events
stand-ins whose record reads a clock the test sets."""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from benchmark import trace as tracing
from benchmark import yardstick
from benchmark.harness import RunView
from benchmark.spec import Spec
from pytv4d_tpu_torch.utils import profiling

READERS = ("outside_loop_ms.denoise", "outside_loop_ms.recon",
           "setup_idle_ms.recon", "projector_span_ms_per_it")


class _Event:
    CLOCK = [0.0]

    def __init__(self, enable_timing=False):
        self.ms = None

    def record(self, stream=None):
        self.ms = self.CLOCK[0]

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.ms - self.ms


@pytest.fixture
def spans(monkeypatch):
    """Two solves of two iterations on the stand-in CUDA stream: solve
    spans of 10 and 12 ms, iterations of 3, 4 and 4, 4 ms, in each
    iteration A_T for 0.5 ms, then A for 1 ms."""
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: "stream")
    clock = _Event.CLOCK
    profiling.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        for solve_ms, its in ((10.0, (3.0, 4.0)), (12.0, (4.0, 4.0))):
            clock[0] = 0.0
            with profiling.span(profiling.SOLVE_SPAN, "cuda"):
                clock[0] = 1.0
                for it_ms in its:
                    t0 = clock[0]
                    with profiling.span(profiling.ITER_SPAN, "cuda"):
                        with profiling.span(profiling.A_T_SPAN, "cuda"):
                            clock[0] += 0.5
                        with profiling.span(profiling.A_SPAN, "cuda"):
                            clock[0] += 1.0
                        clock[0] = t0 + it_ms
                clock[0] = solve_ms
    yield
    profiling.clear_spans()


def _op(name, start, end):
    return tracing.Op(name, float(start), float(end))


def _view(n_solves=2):
    """Solves at 0 and 100 us; the program's solve span from 2 us in, its
    iterations at 20 .. 40 and 45 .. 65; a memset at 10 .. 15 and a kernel
    in each iteration."""
    dev, host, spans = [], [], []
    for s0 in range(0, 100 * n_solves, 100):
        spans.append(_op(tracing.SOLVE_SPAN, s0, s0 + 100))
        host.append(_op(profiling.SOLVE_SPAN, s0 + 2, s0 + 98))
        dev.append(_op("Memset (Device)", s0 + 10, s0 + 15))
        for lo in (20, 45):
            host.append(_op(profiling.ITER_SPAN, s0 + lo, s0 + lo + 20))
            dev.append(_op("void tv_dual_spec_kernel", s0 + lo + 5,
                           s0 + lo + 15))
    return tracing.TraceView(sorted(dev, key=lambda o: o.start), spans,
                             sorted(host, key=lambda o: o.start))


def _run(view, n_iter=2):
    facts = {"shape": (2, 2, 4, 4), "n_iter": n_iter, "Nd": 8, "bpe": 4,
             "dual_bpe": 4}
    return RunView(facts, n_iter * 64, [0.5, 1.5], 2.5, 7.0, 0, view,
                   yardstick.peaks("NVIDIA H100 80GB HBM3"))


def _read(name, run):
    return Spec().reader(name).read(run)


def test_the_readers_of_the_span_table(spans):
    run = _run(_view())
    # (10 + 12) ms of solves less (3 + 4 + 4 + 4) of iterations, a solve
    assert _read("outside_loop_ms.denoise", run) == pytest.approx(3.5)
    assert _read("outside_loop_ms.recon", run) == pytest.approx(3.5)
    # A 4 x 1 ms and A_T 4 x 0.5 ms over 2 solves x 2 iterations
    assert _read("projector_span_ms_per_it", run) == pytest.approx(1.5)


def test_setup_idle_reads_the_gaps_before_the_first_iteration(spans):
    # 2 .. 20 us of each solve, less the memset at 10 .. 15: 13 us idle
    assert _read("setup_idle_ms.recon", _run(_view())) == pytest.approx(
        0.013)


@pytest.mark.parametrize("name", READERS)
def test_nothing_to_read_without_a_trace(spans, name):
    assert _read(name, _run(None)) is None


@pytest.mark.parametrize("name", READERS)
def test_nothing_to_read_where_the_solves_do_not_match(spans, name):
    assert _read(name, _run(_view(3))) is None


@pytest.mark.parametrize("name", READERS)
def test_nothing_to_read_from_a_program_without_spans(monkeypatch, name):
    profiling.clear_spans()  # a table with no solve
    assert _read(name, _run(_view())) is None
    monkeypatch.delattr(profiling, "span_table")
    assert _read(name, _run(_view())) is None


@pytest.mark.parametrize("name", ("outside_loop_ms.recon",
                                  "projector_span_ms_per_it"))
def test_nothing_to_read_from_spans_on_the_cpu(name):
    profiling.clear_spans()
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(2):
            with profiling.span(profiling.SOLVE_SPAN, "cpu"):
                for span in (profiling.ITER_SPAN, profiling.A_SPAN,
                             profiling.A_T_SPAN):
                    with profiling.span(span, "cpu"):
                        pass
    try:
        assert profiling.span_table()[profiling.SOLVE_SPAN] == (2, None)
        assert _read(name, _run(_view())) is None
    finally:
        profiling.clear_spans()
