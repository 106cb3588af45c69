"""The solvers' spans and the kernels' launch counters
(``pytv4d_tpu_torch.utils.profiling``), on the CPU.

With no profiler recording, a solve enters no ``record_function`` and
leaves the span table empty.  Under ``torch.profiler`` each call gives one
``pytv.solve`` holding one ``pytv.iter`` an iteration, in order, and the
inverse solver one ``pytv.project.A`` and one ``pytv.project.A_T`` inside
each iteration.  The CUDA half of a span (its event pair) runs here on
stand-in events."""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pytv4d_tpu_torch.core.config import TVConfig
from pytv4d_tpu_torch.models.ct import cp_reconstruct
from pytv4d_tpu_torch.solvers.cp import chambolle_pock
from pytv4d_tpu_torch.solvers.gd import subgradient_descent
from pytv4d_tpu_torch.solvers.inverse import cp_inverse
from pytv4d_tpu_torch.solvers.tgv import tgv_denoise
from pytv4d_tpu_torch.utils import profiling

N_ITER = 4
SHAPE = (2, 2, 8, 8)
CFG = TVConfig(scheme="hybrid", reg_time=0.5)


def _volume():
    return torch.from_numpy(
        np.random.default_rng(0).random(SHAPE).astype(np.float32))


def _ct():
    angles = np.linspace(0.0, np.pi, 6, endpoint=False).astype(np.float32)
    sino = torch.from_numpy(np.random.default_rng(1).random(
        (SHAPE[0], SHAPE[1], 6, SHAPE[3])).astype(np.float32))
    return cp_reconstruct(sino, angles, SHAPE, n_iter=N_ITER, cfg=CFG,
                          n_det=SHAPE[3], nonneg=True)


def _inverse(fused):
    def blur(x):
        return 0.5 * x + 0.25 * (torch.roll(x, 1, -1) + torch.roll(x, -1, -1))

    return cp_inverse(blur, blur(_volume()), SHAPE, n_iter=N_ITER, cfg=CFG,
                      op_norm=1.0, fused=fused)


SOLVES = {
    "cp fused": lambda: chambolle_pock(_volume(), n_iter=N_ITER, reg=1.0,
                                       cfg=CFG, fused=True),
    "cp plain": lambda: chambolle_pock(_volume(), n_iter=N_ITER, reg=1.0,
                                       cfg=CFG, fused=False),
    "gd fused": lambda: subgradient_descent(_volume(), n_iter=N_ITER,
                                            cfg=CFG, fused=True),
    "gd plain": lambda: subgradient_descent(_volume(), n_iter=N_ITER,
                                            cfg=CFG, fused=False),
    "inverse fused": lambda: _inverse(True),
    "inverse plain": lambda: _inverse(False),
    "cp_reconstruct": _ct,
    "tgv stream": lambda: tgv_denoise(_volume(), n_iter=N_ITER, axes="4d",
                                      fused=True),
    "tgv plain": lambda: tgv_denoise(_volume(), n_iter=N_ITER, axes="4d",
                                     fused=False),
}
PROJECTING = ("inverse fused", "inverse plain", "cp_reconstruct")


@pytest.fixture(autouse=True)
def empty_table():
    profiling.clear_spans()
    yield
    profiling.clear_spans()


def _spans(prof):
    """``{name: [(start, end), ...]}`` of the solvers' spans, by start."""
    out = {}
    for e in sorted(prof.events(), key=lambda e: e.time_range.start):
        if e.name.startswith("pytv."):
            out.setdefault(e.name, []).append(
                (e.time_range.start, e.time_range.end))
    return out


def _inside(inner, outer):
    return outer[0] <= inner[0] and inner[1] <= outer[1]


@pytest.mark.parametrize("solve", list(SOLVES))
def test_no_span_without_a_profiler(monkeypatch, solve):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    SOLVES[solve]()
    assert profiling.span_table() == {}


@pytest.mark.parametrize("solve", list(SOLVES))
def test_one_solve_span_holds_its_iterations(solve):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        SOLVES[solve]()
    spans = _spans(prof)
    (whole,) = spans[profiling.SOLVE_SPAN]
    its = spans[profiling.ITER_SPAN]
    assert len(its) == N_ITER
    assert all(_inside(it, whole) for it in its)
    assert all(a[1] <= b[0] for a, b in zip(its, its[1:]))  # in order
    table = profiling.span_table()
    assert table[profiling.SOLVE_SPAN] == (1, None)
    assert table[profiling.ITER_SPAN] == (N_ITER, None)
    for name in (profiling.A_SPAN, profiling.A_T_SPAN):
        calls = spans.get(name, [])
        if solve not in PROJECTING:
            assert not calls and name not in table
            continue
        # one a name inside each iteration, none outside them
        assert len(calls) == N_ITER and table[name] == (N_ITER, None)
        for it in its:
            assert sum(_inside(c, it) for c in calls) == 1
    if solve in PROJECTING:
        for it in its:
            a_t, a = (next(c for c in spans[n] if _inside(c, it))
                      for n in (profiling.A_T_SPAN, profiling.A_SPAN))
            assert a_t[1] <= a[0]


@pytest.mark.parametrize("loss", ["every", "sampled", "off"])
@pytest.mark.parametrize("fused", [True, False], ids=["stream", "plain"])
def test_tgv_objective_spans_sit_inside_their_iterations(fused, loss):
    """TGV's objective is one ``pytv.tgv.objective`` span inside each
    iteration whose loss is asked for, and no span elsewhere."""
    kw = {"every": {}, "sampled": {"loss_every": 2},
          "off": {"compute_loss": False}}[loss]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        tgv_denoise(_volume(), n_iter=N_ITER, axes="4d", fused=fused, **kw)
    spans = _spans(prof)
    its = spans[profiling.ITER_SPAN]
    objs = spans.get(profiling.TGV_OBJECTIVE_SPAN, [])
    want = [i for i in range(N_ITER)
            if loss == "every" or (loss == "sampled" and i % 2 == 1)]
    assert len(objs) == len(want)
    for i, it in enumerate(its):
        inside = sum(_inside(o, it) for o in objs)
        assert inside == (1 if i in want else 0)
    table = profiling.span_table()
    assert table.get(profiling.TGV_OBJECTIVE_SPAN, (0, None))[0] == len(want)


def test_a_failed_solve_leaves_the_next_its_span():
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with pytest.raises(ValueError):
            chambolle_pock(_volume(), n_iter=N_ITER, reg=1.0, cfg=CFG,
                           fused=False, dual_dtype="bfloat16")
        SOLVES["cp fused"]()
    assert len(_spans(prof)[profiling.SOLVE_SPAN]) == 2
    assert profiling.span_table()[profiling.ITER_SPAN] == (N_ITER, None)


def test_span_table_counts_by_name_and_clears():
    with profile(activities=[ProfilerActivity.CPU]):
        for name in ("a", "b", "a"):
            with profiling.span(name, torch.device("cpu")):
                pass
    want = {"a": (2, None), "b": (1, None)}
    assert profiling.span_table() == want
    assert profiling.span_table() == want  # reading leaves it
    profiling.clear_spans()
    assert profiling.span_table() == {}


class _Event:
    """A stand-in ``torch.cuda.Event`` whose record reads ``CLOCK``."""
    CLOCK = [0.0]

    def __init__(self, enable_timing=False):
        assert enable_timing
        self.ms = None

    def record(self, stream=None):
        self.ms = self.CLOCK[0]

    def synchronize(self):
        pass

    def elapsed_time(self, end):
        return end.ms - self.ms


def test_a_cuda_span_sums_its_event_pairs(monkeypatch):
    monkeypatch.setattr(torch.cuda, "Event", _Event)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: "stream")
    clock = _Event.CLOCK
    with profile(activities=[ProfilerActivity.CPU]):
        for outer_ms, inner_ms in ((10.0, 4.0), (7.0, 1.5)):
            clock[0] = 0.0
            with profiling.span("outer", "cuda"):
                with profiling.span("inner", torch.device("cuda", 0)):
                    clock[0] += inner_ms
                clock[0] = outer_ms
        with profiling.span("host", "cpu"):
            pass
    table = profiling.span_table()
    assert table == {"outer": (2, 17.0), "inner": (2, 5.5),
                     "host": (1, None)}
    assert profiling.span_table() == table


def test_counters_count_copy_and_clear():
    profiling.clear_counters()
    profiling.count("launch.B1")
    profiling.count("launch.B1", 2)
    got = profiling.counters()
    assert got == {"launch.B1": 3} and got["launch.B2"] == 0
    got["launch.B1"] = 0  # a copy
    assert profiling.counters()["launch.B1"] == 3
    profiling.clear_counters()
    assert profiling.counters() == {}
