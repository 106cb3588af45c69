"""The benchmark's frozen arithmetic: the data sheet's peaks and the bytes
each kernel of the port must move, counted from shapes alone.  These are
copies taken when the benchmark was defined (from the program's
``utils/profiling.py``): the program may change its own models, the
yardstick keeps these.

Every byte model counts each array a launch reads once and each array it
writes once, whatever the kernel reads again."""

from __future__ import annotations

import json
import os

PEAKS_FILE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "peaks.json")


def peaks(kind: str) -> dict:
    """The data sheet's peaks of the card named ``kind``; the H100 SXM's
    where the name is not listed (a card at a lower power limit still
    reads against the published peak)."""
    with open(PEAKS_FILE) as f:
        table = json.load(f)
    return table.get(kind, table["NVIDIA H100 80GB HBM3"])


def voxels(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def cp_step_parts(shape, Nd: int, bpe: int = 4, dual_bpe: int = 4):
    """``(B1, B2)`` of one fused CP iteration: B1 reads x, x0, y_A, y_D and
    writes y_A, y_D; B2 reads x, x0, y_A, y_D and writes x.  Loss partials
    are not counted."""
    n = voxels(shape)
    return (4 * bpe + 2 * Nd * dual_bpe) * n, (4 * bpe + Nd * dual_bpe) * n


def tv_bytes(shape, bpe: int = 4):
    """``(B3, B4)`` of one TV value and subgradient: B3 reads x and writes
    the float32 norms; B4 reads x and the norms and writes G."""
    n = voxels(shape)
    return (bpe + 4) * n, (2 * bpe + 4) * n


def ct_tv_bytes(shape, Nd: int, bpe: int = 4, dual_bpe: int = 4):
    """``(B5, B2, B3)`` of one CT iteration's TV half: B5 reads x_bar and
    y_D and writes y_D; B2 reads x (which is also its x0), A^T y_A and y_D
    and writes x'; B3 reads x' and writes the float32 norms."""
    n = voxels(shape)
    return ((bpe + 2 * Nd * dual_bpe) * n,
            (3 * bpe + Nd * dual_bpe) * n,
            (bpe + 4) * n)
