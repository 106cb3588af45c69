"""Reduce a ``torch.profiler`` trace of the traced solves to what the
per-layer readers and the result line read: the device operations
(kernels, copies, memsets) with their times, the benchmark's own span
around each solve, and the host operations that label the device's idle
gaps.  Times are microseconds on the profiler's clock."""

from __future__ import annotations

import bisect
import re
from typing import List, NamedTuple, Optional

SOLVE_SPAN = "bench.solve"


class Op(NamedTuple):
    name: str
    start: float
    end: float


class TraceView(NamedTuple):
    device_ops: List[Op]      # every device operation, by start
    spans: List[Op]           # one per traced solve, in order
    host_ops: List[Op]        # host operations (for labelling idle gaps)

    @property
    def window(self):
        """``(start, end)``: from the first solve's span to the last's."""
        return self.spans[0].start, self.spans[-1].end

    def ops_in(self, lo: float, hi: float, pattern: Optional[str] = None):
        """Device operations that start in ``[lo, hi)``, those whose name
        ``pattern`` (a regular expression) finds only, where it is given."""
        rx = re.compile(pattern) if pattern else None
        return [o for o in self.device_ops if lo <= o.start < hi
                and (rx is None or rx.search(o.name))]


def from_profiler(prof) -> TraceView:
    """The view of a finished ``torch.profiler.profile``."""
    from torch.autograd import DeviceType

    dev, spans, host = [], [], []
    for e in prof.events():
        op = Op(e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type == DeviceType.CUDA:
            # a span's mirror on the device's timeline is no operation
            if e.name != SOLVE_SPAN and not getattr(
                    e, "is_user_annotation", False):
                dev.append(op)
        elif e.name == SOLVE_SPAN:
            spans.append(op)
        else:
            host.append(op)
    dev.sort(key=lambda o: o.start)
    spans.sort(key=lambda o: o.start)
    return TraceView(dev, spans, host)


def union(ops, lo: float, hi: float):
    """The merged intervals of ``ops`` clipped to ``[lo, hi]``."""
    merged = []
    for o in sorted(ops, key=lambda o: o.start):
        s, e = max(o.start, lo), min(o.end, hi)
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def busy_us(view: TraceView) -> float:
    lo, hi = view.window
    return sum(e - s for s, e in union(view.device_ops, lo, hi))


def idle_gaps(view: TraceView):
    """``[(start, end), ...]``: the traced window's stretches with no
    device operation running."""
    lo, hi = view.window
    gaps, t = [], lo
    for s, e in union(view.device_ops, lo, hi):
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if hi > t:
        gaps.append((t, hi))
    return gaps


BETWEEN_OPS = "(host code between operations)"


def _host_label(host_ops, starts, t: float, reach: int = 256) -> str:
    """The innermost host operation running at ``t``: of nested operations
    the one that started last, found among the ``reach`` that started
    last before ``t``."""
    i = bisect.bisect_right(starts, t)
    for o in reversed(host_ops[max(0, i - reach):i]):
        if o.end > t:
            return o.name
    return BETWEEN_OPS


def breakdown(view: TraceView, top: int = 10) -> dict:
    """The device operations that took most time, and the idle time by
    what the host was doing in the middle of each gap, each as
    ``[[name, seconds], ...]``, at most ``top`` entries."""
    lo, hi = view.window
    by_op = {}
    for o in view.device_ops:
        if lo <= o.start < hi:
            by_op[o.name] = by_op.get(o.name, 0.0) + (o.end - o.start) / 1e6
    host = sorted(view.host_ops, key=lambda o: o.start)
    starts = [o.start for o in host]
    by_host = {}
    for s, e in idle_gaps(view):
        key = _host_label(host, starts, 0.5 * (s + e))
        by_host[key] = by_host.get(key, 0.0) + (e - s) / 1e6
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    gaps = sorted(by_host.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in gaps]}
