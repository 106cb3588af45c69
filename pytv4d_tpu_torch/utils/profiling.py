"""Byte models, roofline share and a CUDA-event iteration timer for the
fused kernels (the port of ``pytv4d_tpu/utils/profiling.py``'s measuring
helpers).

- :func:`cp_traffic_model` — bytes moved per fused CP iteration, the same
  model as the JAX package's.
- :func:`tv_traffic_model` — bytes each TV pass (B3, B4) must move.
- :func:`tgv_traffic_model` — bytes each streaming TGV pass (B6) must move.
- :func:`roofline_fraction` — achieved bytes/s over the H100's data-sheet
  HBM bandwidth.
- :func:`time_iterations` — iterations/s of a device loop, timed with CUDA
  events after a warm-up.
- :func:`device_time` — device ms per iteration of a loop, by kernel name,
  from ``torch.profiler``.
- :func:`trace` — a ``torch.profiler`` context that writes a Chrome trace.
- :func:`force_read` — one scalar host read that waits for the work.
- :class:`IterationTimer` — iterations/s of a loop: CUDA events when its
  output is on a CUDA device, the host clock on the CPU.
- :func:`device_kind` — the card's name, or ``'cpu'``.
- :func:`span`, :func:`solve_span`, :func:`span_table`,
  :func:`clear_spans` — the solvers' spans, while a ``torch.profiler``
  records.
- :func:`count`, :func:`counters`, :func:`clear_counters` — the launch
  counters of the kernels, by key.

``time_iterations`` and ``device_time`` need a CUDA device: a CPU time is
not a device metric, so there is no CPU fallback.  ``IterationTimer`` times
where the work ran, and its CPU numbers are host timings.

**Spans.**  The solver layer marks its boundaries with :func:`span`:
``pytv.solve`` around each call of ``chambolle_pock``,
``subgradient_descent``, ``cp_inverse``, ``cp_reconstruct`` and
``tgv_denoise`` (one a call, however they nest: :func:`solve_span`),
``pytv.iter`` around each iteration of their loops (TGV's: the stream and
the plain loop of ``solvers.tgv._iterate``), ``pytv.project.A`` and
``pytv.project.A_T`` around the projector's calls in the inverse solver's
loops, ``pytv.tgv.objective`` around each evaluation of TGV's objective
inside its iteration.  A span is
open only while a ``torch.profiler`` records (any profiler, or
:func:`trace`): it is then a ``record_function`` in the trace, on the
profiler's clock, and, where the solve runs on a CUDA device, a pair of
CUDA events on the current stream, which give its extent on the device
stream (from when the stream reaches its start to when the last work
launched inside it ends, idle time included).  With no profiler a span is
one flag read and a shared null context.  A solve's self time on the
device stream, its set-up and teardown, is its ``pytv.solve`` span less
the ``pytv.iter`` spans it holds.

**Counters.**  Each kernel wrapper counts its launches with :func:`count`
under ``launch.<kernel>``, the kernel's B-number in ``PERF.md``'s kernel
table: ``launch.B1`` ... ``launch.B5`` with ``launch.B4_gd`` (the B4
launches that take the subgradient-descent step in their epilogue, also
counted under ``launch.B4``), ``launch.B6.pq`` / ``.xw`` / ``.obj`` (the
streaming TGV passes and its objective kernel), ``launch.B7`` (whole TGV solves) with ``launch.B7.onchip`` / ``.l2`` (the
kernel that ran), ``launch.B8.dual`` / ``.primal``, ``launch.B9.cp`` /
``.gd`` (whole solves) with ``launch.B9.onchip`` / ``.l2``, ``launch.B10``;
B1 and B2 also under ``launch.B1/<launch function>`` and
``launch.B2/<launch function>``, which tell the unsharded launch and the
two sharded modes apart.  The counters are always on.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import os
import time
from typing import Callable

import numpy as np
import torch

# Peak HBM bandwidth, GB/s (NVIDIA data sheet, H100 SXM5 80 GB, at the
# card's full 700 W power limit).
H100_HBM_PEAK_GBPS = 3350.0


def cp_traffic_model(shape, Nd: int, dtype=torch.float32,
                     dual_dtype=None) -> int:
    """Bytes moved per fused CP iteration (two-pass form), counting each
    array once per pass (unique bytes — the roofline denominator): pass A
    reads x, x0, y_A, y_D and writes y_A, y_D; pass B reads x, x0, y_A, y_D
    and writes x.  ``dual_dtype`` (a torch dtype) scales the y_D terms.
    Loss partials are not counted.
    """
    vox = int(np.prod(shape))
    bpe = dtype.itemsize
    dual_bpe = dual_dtype.itemsize if dual_dtype else bpe
    pass_a = 4 * bpe + 2 * Nd * dual_bpe
    pass_b = 4 * bpe + Nd * dual_bpe
    return int((pass_a + pass_b) * vox)


def tv_traffic_model(shape, dtype=torch.float32, norm: str = "iso"):
    """Bytes ``(pass_1, pass_2)`` of the fused TV value and subgradient,
    each array once: pass 1 reads x and writes the float32 norms, pass 2
    reads x and the norms (aniso: x only) and writes G in x's dtype."""
    vox = int(np.prod(shape))
    bpe = dtype.itemsize
    pass_1 = (bpe + 4) * vox
    pass_2 = (2 * bpe + (0 if norm == "aniso" else 4)) * vox
    return pass_1, pass_2


def tgv_traffic_model(shape, mode: str, dtype=torch.float32):
    """Bytes ``(pass_PQ, pass_XW)`` of one streaming TGV-2 iteration
    (``kernels.tgv_stream``), each array once per pass: pass PQ reads xb,
    wb, p, q and writes p, q; pass XW reads x, x0, p, w, q and writes x, xb,
    w, wb — 28 / 44 / 63 planes in all for '2d' / '3d' / '4d'.  Their sum is
    the JAX package's minimal model.  The whole-solve 2d kernel has no
    per-iteration HBM traffic; this model is for the streaming path."""
    n = {"2d": 2, "3d": 3, "4d": 4}[mode]
    n_q = n * (n + 1) // 2
    per_plane = int(np.prod(shape)) * dtype.itemsize
    pass_pq = (1 + 2 * n + n_q) + (n + n_q)
    pass_xw = (2 + 2 * n + n_q) + (2 + 2 * n)
    return pass_pq * per_plane, pass_xw * per_plane


def roofline_fraction(bytes_per_iter: int, iters_per_s: float,
                      peak_gbps: float = H100_HBM_PEAK_GBPS) -> float:
    """Achieved bytes/s as a fraction of the peak HBM bandwidth."""
    return bytes_per_iter * iters_per_s / (peak_gbps * 1e9)


def time_iterations(run_n: Callable[[int], object], n_iter: int,
                    device, warmup_iters: int = 5, repeats: int = 3) -> float:
    """Iterations/s of ``run_n(n)``, which must enqueue n iterations of
    device work on the current stream of CUDA ``device``.

    Runs ``warmup_iters`` iterations first, then times ``repeats`` runs of
    ``n_iter`` between CUDA events and keeps the fastest."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"time_iterations times CUDA work, got {device}")
    run_n(warmup_iters)
    torch.cuda.synchronize(device)
    best_ms = float("inf")
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        run_n(n_iter)
        end.record()
        torch.cuda.synchronize(device)
        best_ms = min(best_ms, start.elapsed_time(end))
    return n_iter / (best_ms / 1e3)


def device_time(run: Callable[[], object], n_iter: int, device):
    """Device time of ``run()``, which must enqueue ``n_iter`` iterations of
    work on CUDA ``device``: ``(ms per iteration, {kernel name: ms per
    iteration})``, summing every CUDA kernel, copy and memset that
    ``torch.profiler`` records.  Raises if three traces in a row record no
    device activity."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"device_time profiles CUDA work, got {device}")
    # a trace of short launches can come back without its device records
    # while the next one has them: run the work again, up to three traces
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize(device)
        by_kernel = {}
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                by_kernel[e.name] = (by_kernel.get(e.name, 0.0)
                                     + e.time_range.elapsed_us() / 1e3
                                     / n_iter)
        if by_kernel:
            return sum(by_kernel.values()), by_kernel
    raise RuntimeError("torch.profiler recorded no device activity")


@contextlib.contextmanager
def trace(log_dir: str):
    """``with profiling.trace('/tmp/trace'): run()`` records the CPU and,
    where there is one, the CUDA activity with ``torch.profiler`` and
    writes ``log_dir/trace.json`` (Chrome trace format: chrome://tracing or
    Perfetto).  Yields the profiler, whose ``key_averages()`` sums time by
    operation and kernel."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def _tensor_leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensor_leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensor_leaves(v)


def force_read(*trees) -> float:
    """ONE scalar host read spanning every tensor leaf of ``trees`` (their
    first elements, summed): the read waits for the work that wrote them,
    on whatever device."""
    total = None
    for leaf in _tensor_leaves(trees):
        part = torch.sum(leaf.reshape(-1)[:8].float())
        total = part if total is None else total + part.to(total.device)
    return 0.0 if total is None else float(total)


class IterationTimer:
    """Steady-state iterations/s of ``run_n(n) -> tensors``, which runs n
    iterations and returns something that depends on them.

    A CUDA output is timed with CUDA events around ``run_n`` (the device's
    time from the first launch to the last); anything else with the host
    clock around ``run_n`` and a :func:`force_read` of its output."""

    def __init__(self, run_n: Callable[[int], object], warmup_iters: int = 5):
        self.run_n = run_n
        self.warmup_iters = warmup_iters

    def measure(self, n_iter: int, repeats: int = 3) -> float:
        out = self.run_n(self.warmup_iters)
        force_read(out)
        cuda = [t.device for t in _tensor_leaves(out) if t.is_cuda]
        best = float("inf")
        for _ in range(repeats):
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                start.record()
                out = self.run_n(n_iter)
                end.record()
                torch.cuda.synchronize(cuda[0])
                force_read(out)
                best = min(best, start.elapsed_time(end) / 1e3)
            else:
                t0 = time.perf_counter()
                out = self.run_n(n_iter)
                force_read(out)
                best = min(best, time.perf_counter() - t0)
        return n_iter / best


def device_kind() -> str:
    """The CUDA card's name (``torch.cuda.get_device_name(0)``), or
    ``'cpu'`` where there is none."""
    if torch.cuda.is_available():
        return torch.cuda.get_device_name(0)
    return "cpu"


# ---------------------------------------------------------------- spans

SOLVE_SPAN = "pytv.solve"
ITER_SPAN = "pytv.iter"
A_SPAN = "pytv.project.A"
A_T_SPAN = "pytv.project.A_T"
TGV_OBJECTIVE_SPAN = "pytv.tgv.objective"

_NULL = contextlib.nullcontext()
# name -> [spans finished, CUDA event pairs not yet read, device ms read]
_SPANS: dict = {}
_solve_depth = 0


def _recording() -> bool:
    """Whether a profiler records: the Python flag ``torch.profiler`` sets,
    cheaper to read than ``torch._C._autograd._profiler_enabled()``."""
    return torch.autograd.profiler._is_profiler_enabled


class _Span:
    __slots__ = ("name", "stream", "start", "rf")

    def __init__(self, name: str, device):
        self.name = name
        self.stream = (torch.cuda.current_stream(device)
                       if device is not None
                       and torch.device(device).type == "cuda" else None)

    def __enter__(self):
        self.rf = torch.profiler.record_function(self.name)
        self.rf.__enter__()
        if self.stream is not None:
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record(self.stream)
        return self

    def __exit__(self, *exc):
        entry = _SPANS.setdefault(self.name, [0, [], None])
        entry[0] += 1
        if self.stream is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(self.stream)
            entry[1].append((self.start, end))
        self.rf.__exit__(*exc)
        return False


def span(name: str, device=None):
    """``with span(name, device):`` marks a stretch of a solve while a
    ``torch.profiler`` records (module docstring): a ``record_function``
    and, for a CUDA ``device``, a pair of CUDA events on its current
    stream; the span is counted in :func:`span_table`.  With no profiler
    recording it returns a shared null context and does nothing else."""
    if not _recording():
        return _NULL
    return _Span(name, device)


def _solve_device(args, kwargs):
    """The device a solve's call computes on, by ``utils.device``'s rule:
    its first tensor argument's, else ``device=``, else the CUDA device
    where there is one."""
    for leaf in _tensor_leaves((args, kwargs)):
        return leaf.device
    if kwargs.get("device") is not None:
        return torch.device(kwargs["device"])
    return torch.device("cuda") if torch.cuda.is_available() else None


def solve_span(fn):
    """Decorate a solver's entry point: while a profiler records, each
    call runs inside one ``pytv.solve`` :func:`span`, and a solve it calls
    opens none of its own."""
    @functools.wraps(fn)
    def call(*args, **kwargs):
        global _solve_depth
        if _solve_depth or not _recording():
            return fn(*args, **kwargs)
        _solve_depth += 1
        try:
            with span(SOLVE_SPAN, _solve_device(args, kwargs)):
                return fn(*args, **kwargs)
        finally:
            _solve_depth -= 1

    return call


def span_table() -> dict:
    """``{name: (count, device_ms_total)}`` of the spans finished since
    :func:`clear_spans`: how many, and the sum of their extents on the
    device stream in ms, or ``None`` for a name no span of which ran on a
    CUDA device.  Waits for the spans' CUDA events; reading leaves the
    table as it is."""
    out = {}
    for name, entry in _SPANS.items():
        if entry[1]:
            ms = entry[2] or 0.0
            for start, end in entry[1]:
                end.synchronize()
                ms += start.elapsed_time(end)
            entry[1], entry[2] = [], ms
        out[name] = (entry[0], entry[2])
    return out


def clear_spans():
    """Empty :func:`span_table`."""
    _SPANS.clear()


# ------------------------------------------------------------- counters

_COUNTS = collections.Counter()


def count(key: str, n: int = 1):
    """Add ``n`` to counter ``key`` (module docstring)."""
    _COUNTS[key] += n


def counters() -> collections.Counter:
    """A copy of every counter; a key never counted reads 0."""
    return collections.Counter(_COUNTS)


def clear_counters():
    """Set every counter back to 0."""
    _COUNTS.clear()
