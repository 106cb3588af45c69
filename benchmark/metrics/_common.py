"""What the metric readers share: each reader is a file of its own that
names its layer, source, kernel-name patterns and the end-to-end metric it
moves, and reads one number from a ``harness.RunView``, or ``None`` where
the run gave it nothing to read (no trace, no matching kernel)."""

from __future__ import annotations

import statistics


def gvox_per_s(run):
    """All voxel-iterations of the window's solves over all its time."""
    return len(run.latencies_s) * run.work_per_solve / run.window_s / 1e9


def p95_ms(run):
    """The 95th percentile of the solves' times (nearest rank above)."""
    lat = sorted(run.latencies_s)
    return 1e3 * lat[-(-95 * len(lat) // 100) - 1]


def _ops(run, pattern=None):
    lo, hi = run.trace.window
    return run.trace.ops_in(lo, hi, pattern)


def traced(run):
    return run.trace is not None and bool(run.trace.device_ops)


def launches_per_it(run):
    """Device operations (kernels, copies, memsets) per iteration of the
    traced solves."""
    if not traced(run):
        return None
    return len(_ops(run)) / (len(run.trace.spans) * run.facts["n_iter"])


def idle_pct(run):
    """The traced window's share with no device operation running."""
    from benchmark.trace import busy_us

    if not traced(run):
        return None
    lo, hi = run.trace.window
    return 100.0 * (1.0 - busy_us(run.trace) / (hi - lo))


def roofline_pct(run, bytes_by_pattern: dict):
    """The bytes each matching launch must move (``{pattern: bytes a
    launch}``), summed, over their summed device time, against the data
    sheet's HBM rate.  ``None`` where no launch matched."""
    if not traced(run):
        return None
    total_bytes, total_s = 0.0, 0.0
    for pattern, nbytes in bytes_by_pattern.items():
        ops = _ops(run, pattern)
        total_bytes += nbytes * len(ops)
        total_s += sum(o.end - o.start for o in ops) / 1e6
    if total_s <= 0:
        return None
    return 100.0 * total_bytes / total_s / run.peaks["hbm_bytes_per_s"]


def device_ms_per_it(run, pattern: str):
    if not traced(run):
        return None
    ops = _ops(run, pattern)
    if not ops:
        return None
    its = len(run.trace.spans) * run.facts["n_iter"]
    return sum(o.end - o.start for o in ops) / 1e3 / its


def solve_overhead_ms(run, step_pattern: str):
    """Per traced solve: its span's time less the device's time from the
    start of its first step kernel to the end of its last; the mean."""
    if not traced(run):
        return None
    parts = []
    for sp in run.trace.spans:
        ops = run.trace.ops_in(sp.start, sp.end, step_pattern)
        if not ops:
            return None
        loop = max(o.end for o in ops) - ops[0].start
        parts.append((sp.end - sp.start - loop) / 1e3)
    return statistics.fmean(parts)
