"""What the readers of the program's own spans share.  The port marks its
solver layer with spans while a profiler records
(``pytv4d_tpu_torch.utils.profiling``): ``pytv.solve`` around each call,
``pytv.iter`` around each iteration, ``pytv.project.A`` / ``A_T`` around
the projector's calls, each in the trace (``run.trace.host_ops``, on the
profiler's clock) and in the program's span table with its extent on the
device stream.  A version of the program without that table gives these
readers nothing to read, and so does a table whose count of solves is not
the traced solves' count."""

from __future__ import annotations

import bisect
import statistics

SOLVE = "pytv.solve"
ITER = "pytv.iter"
PROJECT = ("pytv.project.A", "pytv.project.A_T")


def table(run):
    """The program's span table (``{name: (count, device ms)}``) of the
    traced solves, or ``None``: no trace, no such table, or not one
    ``pytv.solve`` a traced solve."""
    if run.trace is None or not run.trace.spans:
        return None
    from pytv4d_tpu_torch.utils import profiling

    read = getattr(profiling, "span_table", None)
    if read is None:
        return None
    spans = read()
    if spans.get(SOLVE, (0, None))[0] != len(run.trace.spans):
        return None
    return spans


def device_ms(spans, name):
    """The summed device-stream ms of ``name``'s spans, or ``None``."""
    return spans.get(name, (0, None))[1]


def outside_loop_ms(run):
    """Per traced solve, its ``pytv.solve`` span's device-stream time less
    that of the ``pytv.iter`` spans it holds: the mean, in ms."""
    spans = table(run)
    if spans is None:
        return None
    solve, its = device_ms(spans, SOLVE), device_ms(spans, ITER)
    if solve is None or its is None:
        return None
    return (solve - its) / len(run.trace.spans)


def projector_ms_per_it(run):
    """The device-stream ms of the projector's spans an iteration of the
    traced solves."""
    spans = table(run)
    if spans is None:
        return None
    parts = [device_ms(spans, name) for name in PROJECT]
    if None in parts:
        return None
    return sum(parts) / (len(run.trace.spans) * run.facts["n_iter"])


def setup_idle_ms(run):
    """Per traced solve, the device's idle time (``trace.idle_gaps``) from
    the host's start of its ``pytv.solve`` span to the host's start of its
    first ``pytv.iter``, on the trace's clock: the mean, in ms."""
    from benchmark.trace import idle_gaps

    if table(run) is None or not run.trace.device_ops:
        return None
    host = run.trace.host_ops
    solves = sorted((o for o in host if o.name == SOLVE),
                    key=lambda o: o.start)
    iters = sorted(o.start for o in host if o.name == ITER)
    if len(solves) != len(run.trace.spans):
        return None
    gaps = idle_gaps(run.trace)
    parts = []
    for s in solves:
        i = bisect.bisect_left(iters, s.start)
        if i == len(iters) or iters[i] >= s.end:
            return None
        lo, hi = s.start, iters[i]
        parts.append(sum(max(0.0, min(e, hi) - max(g, lo))
                         for g, e in gaps) / 1e3)
    return statistics.fmean(parts)
