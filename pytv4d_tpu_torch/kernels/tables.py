"""Which specialised kernel an unsharded CP pass A (B1), TV pass 1 (B3), TV
pass 2 (B4) or pass A for inverse problems (B5), or B1, B2, B3 and B4 in
their sharded modes on a shard (with the whole volume's ``(Nz, M)``),
launches: the id of its channel table.

``csrc/tables.cuh`` lists the 21 channel tables that
``core.schemes.scheme_channels`` can produce (upwind, downwind and hybrid
with z on/off x t on/off; central with z in {off, CTR, FWD when Nz == 2} x
t in {off, CTR, FWD when M == 2}), each in scheme_channels' channel order,
and the specialised kernels (``csrc/specialised.cu``,
``csrc/specialised_tv.cu``, ``csrc/specialised_cp.cu``) take one as a
template argument.  :data:`TABLES` mirrors that list
(``tests/test_torch_channel_tables.py`` holds the two equal).  A channel
sequence outside it raises: nothing falls back to the generic kernels.

The boundary passes of the overlapped z-sharded CP step (B8,
``csrc/cp_boundary.cu``) instantiate only :data:`BOUNDARY_TABLES`, the
tables that step can meet (:func:`boundary_table_id`), and so do the
interior launches of passes A and B of that step (B1, B2,
``csrc/specialised_cp.cu``; their halo mode all 21); the z-marching pass A
(B10, ``csrc/cp_zstream.cu``) the same nine as :data:`ZSTREAM_TABLES`
(:func:`zstream_table_id`).  ``csrc/tables.cuh``'s ``TABLES_WITH_Z`` is
the one list of the nine in C.  The whole-solve
kernels on chip (B9, ``csrc/resident_onchip.cu``) instantiate all 21.
"""

from __future__ import annotations

import functools

from ..core.schemes import AXIS_COL, AXIS_ROW, AXIS_T, AXIS_Z, BWD, CTR, FWD
from ..core.schemes import scheme_channels

_RF, _CF, _RB, _CB = ((AXIS_ROW, FWD), (AXIS_COL, FWD), (AXIS_ROW, BWD),
                      (AXIS_COL, BWD))
_RC, _CC = (AXIS_ROW, CTR), (AXIS_COL, CTR)
_ZF, _ZB, _ZC = (AXIS_Z, FWD), (AXIS_Z, BWD), (AXIS_Z, CTR)
_TF, _TB, _TC = (AXIS_T, FWD), (AXIS_T, BWD), (AXIS_T, CTR)

# table id -> its (axis, kind) channels, as csrc/tables.cuh lists them
TABLES = (
    (_RF, _CF), (_RF, _CF, _ZF), (_RF, _CF, _TF), (_RF, _CF, _ZF, _TF),
    (_RB, _CB), (_RB, _CB, _ZB), (_RB, _CB, _TB), (_RB, _CB, _ZB, _TB),
    (_RF, _CF, _RB, _CB), (_RF, _CF, _RB, _CB, _ZF, _ZB),
    (_RF, _CF, _RB, _CB, _TF, _TB), (_RF, _CF, _RB, _CB, _ZF, _ZB, _TF, _TB),
    (_RC, _CC), (_RC, _CC, _ZC), (_RC, _CC, _TC), (_RC, _CC, _ZC, _TC),
    (_RC, _CC, _ZF), (_RC, _CC, _ZF, _TC), (_RC, _CC, _ZF, _TF),
    (_RC, _CC, _TF), (_RC, _CC, _ZC, _TF),
)
_ID = {chans: i for i, chans in enumerate(TABLES)}


def table_of(chans) -> int:
    """The id of the table whose channels are ``chans``, a sequence of
    (axis, kind) pairs; ValueError where no kernel is compiled for it."""
    key = tuple(tuple(c) for c in chans)
    if key not in _ID:
        raise ValueError(f"no specialised kernel is compiled for the channel "
                         f"table {key} (csrc/tables.cuh)")
    return _ID[key]


@functools.lru_cache(maxsize=64)
def table_id(cfg, Nz: int, M: int) -> int:
    """The table id of ``cfg``'s scheme on a volume with ``Nz`` slices and
    ``M`` time steps (remembered: a launch asks for it, and working it out
    cost 12-15 us of a wrapper's host time)."""
    chans, _ = scheme_channels(cfg.scheme, Nz, M, cfg.reg_z_over_reg,
                               cfg.reg_time)
    return table_of((ch.axis, ch.kind) for ch in chans)


# The tables the overlapped step's kernels instantiate (csrc/tables.cuh's
# TABLES_WITH_Z: csrc/cp_boundary.cu and the interior launches of
# csrc/specialised_cp.cu): those with a z channel, which the overlapped step
# requires, on a volume of >= 6 slices (>= 2 z-shards of >= 3 planes),
# where central's z channel is CTR; t is off, CTR or (central, M == 2) FWD.
BOUNDARY_TABLES = (1, 3, 5, 7, 9, 11, 13, 15, 20)


def _listed_table_id(cfg, Nz: int, M: int, listed, kernel: str,
                     source: str) -> int:
    """The table id of ``cfg``'s scheme at ``(Nz, M)``; ValueError where it
    is not among the ``listed`` ids ``source`` instantiates."""
    tid = table_id(cfg, Nz, M)
    if tid not in listed:
        raise ValueError(f"no {kernel} kernel is compiled for the channel "
                         f"table {TABLES[tid]} (id {tid}; {source} "
                         f"instantiates {listed})")
    return tid


@functools.lru_cache(maxsize=64)
def boundary_table_id(cfg, Nz: int, M: int) -> int:
    """The table id of ``cfg``'s scheme on a volume of ``Nz`` slices and
    ``M`` time steps for a kernel of the overlapped step (a boundary pass,
    or an interior launch of CP pass A or B); ValueError where
    ``csrc/cp_boundary.cu`` has no kernel for it, and so
    ``csrc/specialised_cp.cu`` no interior one."""
    return _listed_table_id(cfg, Nz, M, BOUNDARY_TABLES, "boundary",
                            "csrc/cp_boundary.cu")


# The tables csrc/cp_zstream.cu instantiates (tables.cuh's TABLES_WITH_Z):
# those with a z channel on a volume of >= 3 slices, which the z-marching pass A
# requires -- central's z channel is CTR there -- with t off, CTR or
# (central, M == 2) FWD: BOUNDARY_TABLES' rule.
ZSTREAM_TABLES = BOUNDARY_TABLES


@functools.lru_cache(maxsize=64)
def zstream_table_id(cfg, Nz: int, M: int) -> int:
    """The table id of ``cfg``'s scheme on a volume of ``Nz`` slices and
    ``M`` time steps for the z-marching pass A; ValueError where
    ``csrc/cp_zstream.cu`` has no kernel for it."""
    return _listed_table_id(cfg, Nz, M, ZSTREAM_TABLES, "z-marching",
                            "csrc/cp_zstream.cu")
