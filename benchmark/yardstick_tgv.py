"""The benchmark's frozen byte model of the TGV kernels, as
``yardstick.py`` keeps the others': a copy taken when the TGV cell was
defined (from the program's ``utils/profiling.py::tgv_traffic_model`` and
the objective kernel's reads).  Each array a launch reads is counted once
and each it writes once, whatever the kernel reads again; the objective's
per-block partials are not counted."""

from __future__ import annotations

from .yardstick import voxels

FIELDS = {"2d": 2, "3d": 3, "4d": 4}


def tgv_stream_bytes(shape, mode: str, bpe: int = 4):
    """``(PQ, XW)`` of one streaming iteration with n fields and n(n+1)/2
    channels of E: PQ reads xb, wb, p, q and writes p, q; XW reads x, x0,
    p, w, q and writes x, xb, w, wb (4d: 33 and 30 planes)."""
    n = FIELDS[mode]
    nq = n * (n + 1) // 2
    plane = voxels(shape) * bpe
    return ((1 + 2 * n + nq) + (n + nq)) * plane, \
        ((2 + 2 * n + nq) + (2 + 2 * n)) * plane


def tgv_objective_bytes(shape, mode: str, bpe: int = 4):
    """One evaluation of the objective: x, x0 and the n fields of w read
    (4d: 6 planes)."""
    return (2 + FIELDS[mode]) * voxels(shape) * bpe
