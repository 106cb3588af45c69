"""The specialised B1/B3/B4/B5 kernels' channel tables (no nvcc or GPU
needed): ``kernels/tables.py`` maps every configuration to the one compiled
table whose channels are ``scheme_channels``' in order, mirrors the list in
``csrc/tables.cuh`` that ``csrc/specialised.cu`` and
``csrc/specialised_tv.cu`` instantiate, and raises on a table outside the
list."""

import itertools
import math
import os
import re

import pytest

from pytv4d_tpu_torch.core.config import TVConfig
from pytv4d_tpu_torch.core.schemes import (
    AXIS_COL,
    AXIS_ROW,
    AXIS_T,
    AXIS_Z,
    BWD,
    CTR,
    FWD,
    SCHEMES,
    scheme_channels,
)
from pytv4d_tpu_torch.kernels import build, tables
from pytv4d_tpu_torch.utils import profiling

_AXES = {"Z": AXIS_Z, "T": AXIS_T, "ROW": AXIS_ROW, "COL": AXIS_COL}
_KINDS = {"FWD": FWD, "BWD": BWD, "CTR": CTR}


def _header_tables():
    """``{macro: {id: channels}}`` of the X-lists in csrc/tables.cuh."""
    with open(os.path.join(build.CSRC, "tables.cuh")) as f:
        text = f.read().replace("\\\n", " ")
    lists = {}
    for macro, body in re.findall(r"#define (\w+)_TABLES\(X\)(.*)", text):
        entries = {}
        for tid, chans in re.findall(
                r"X\((\d+), table\(((?:CHAN\(\w+, \w+\),?\s*)+)\)\)", body):
            entries[int(tid)] = tuple(
                (_AXES[a], _KINDS[k])
                for a, k in re.findall(r"CHAN\((\w+), (\w+)\)", chans))
        lists[macro] = entries
    return lists


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("reg_z", [0.0, 1.0, math.nan])
@pytest.mark.parametrize("reg_time", [0.0, 0.5])
def test_table_id_follows_scheme_channels(scheme, reg_z, reg_time):
    cfg = TVConfig(scheme=scheme, reg_z_over_reg=reg_z, reg_time=reg_time)
    for Nz, M in itertools.product((1, 2, 3, 5), (1, 2, 3)):
        chans, _ = scheme_channels(scheme, Nz, M, reg_z, reg_time)
        tid = tables.table_id(cfg, Nz, M)
        assert tables.TABLES[tid] == tuple((c.axis, c.kind) for c in chans)


def test_every_table_is_reachable():
    reached = {
        tables.table_id(TVConfig(scheme=s, reg_z_over_reg=z, reg_time=t),
                        Nz, M)
        for s, z, t, Nz, M in itertools.product(
            SCHEMES, (0.0, 1.0), (0.0, 0.5), (1, 2, 3), (1, 2, 3))}
    assert reached == set(range(len(tables.TABLES))) and len(reached) == 21


@pytest.mark.parametrize("chans", [
    ((AXIS_ROW, FWD),),                                   # too few
    ((AXIS_COL, FWD), (AXIS_ROW, FWD)),                   # out of order
    ((AXIS_ROW, FWD), (AXIS_COL, BWD)),                   # mixed kinds
    ((AXIS_ROW, CTR), (AXIS_COL, CTR), (AXIS_Z, BWD)),    # no scheme has it
])
def test_a_table_outside_the_list_raises(chans):
    with pytest.raises(ValueError, match="no specialised kernel"):
        tables.table_of(chans)


def test_mirror_equals_the_header():
    lists = _header_tables()
    assert set(lists) == {"UPWIND", "DOWNWIND", "HYBRID", "CENTRAL",
                          "CENTRAL_FWD", "CHANNEL"}
    merged = {}
    for macro in ("UPWIND", "DOWNWIND", "HYBRID", "CENTRAL", "CENTRAL_FWD"):
        assert not set(lists[macro]) & set(merged)
        merged.update(lists[macro])
    assert merged == dict(enumerate(tables.TABLES))
    # CHANNEL_TABLES is the union of the families, ids 0..20 once each
    with open(os.path.join(build.CSRC, "tables.cuh")) as f:
        text = f.read().replace("\\\n", " ")
    union = re.search(r"#define CHANNEL_TABLES\(X\)(.*)", text).group(1)
    assert re.findall(r"(\w+)_TABLES\(X\)", union) == [
        "UPWIND", "DOWNWIND", "HYBRID", "CENTRAL", "CENTRAL_FWD"]


@pytest.mark.parametrize("source, launch", [
    ("specialised", "spec_cp_dual_launch"),
    ("specialised", "spec_tv_subgrad_launch"),
    ("specialised", "spec_tv_subgrad_halo_launch"),
    ("specialised", "spec_tv_gd_launch"),
    ("specialised_tv", "spectv_norms_launch"),
    ("specialised_tv", "spectv_norms_halo_launch"),
    ("specialised_tv", "spectv_dual_launch"),
    ("specialised_tv", "spectv_dual_halo_launch"),
    ("specialised_cp", "spcp_dual_halo_launch"),
    ("specialised_cp", "spcp_primal_halo_launch"),
])
def test_each_launch_instantiates_every_table(source, launch):
    """The C entry points of csrc/specialised.cu, csrc/specialised_tv.cu
    and the halo mode's of csrc/specialised_cp.cu switch over the whole
    X-list, one case per table id, and fail any other id."""
    from pytv4d_tpu_torch.kernels import fused

    assert launch in fused._ENTRY_POINTS[source][2]
    with open(os.path.join(build.CSRC, f"{source}.cu")) as f:
        text = f.read()
    body = re.search(rf"int {launch}\((.*?)\n}}", text, re.S).group(1)
    assert re.search(r"switch \(id\)", body)
    assert "CHANNEL_TABLES(SPEC_CASE)" in body
    assert body.rstrip().endswith("return (int)cudaErrorInvalidValue;")


@pytest.mark.parametrize("tid", range(21))
def test_each_table_round_trips_and_fits_the_kernels(tid):
    """A listed table maps back to its own id, holds what a thread keeps in
    registers (MAX_CH channels), and has at most one channel of each
    (axis, kind)."""
    from pytv4d_tpu_torch.kernels import fused

    chans = tables.TABLES[tid]
    assert tables.table_of(chans) == tid
    assert tables.table_of(list(map(list, chans))) == tid
    assert 2 <= len(chans) <= fused.MAX_CHANNELS
    assert len(set(chans)) == len(chans)


def test_spec_launch_passes_table_and_storage(monkeypatch):
    """What an unsharded pass A / pass 2 hands its library: the table id
    first, then the storage flags."""
    import torch

    from pytv4d_tpu_torch.kernels import fused

    seen = []
    monkeypatch.setattr(fused, "_launch",
                        lambda *a, **k: seen.append((a, k)) or "parts")
    cfg = TVConfig(scheme="central", reg_time=0.5)
    x = torch.zeros((2, 3, 4, 6))
    p = fused._params(cfg, tuple(x.shape), False)
    assert fused._spec_launch("spec_cp_dual_launch", cfg, x, p, (0, 1),
                              (x,), with_parts=True) == "parts"
    fused._spec_launch("spec_tv_subgrad_launch", cfg, x, p, (1,), (x,))
    tid = tables.table_id(cfg, 2, 3)
    assert tables.TABLES[tid] == ((AXIS_ROW, CTR), (AXIS_COL, CTR),
                                  (AXIS_Z, FWD), (AXIS_T, CTR))
    (a1, k1), (a2, k2) = seen
    assert a1[:2] == ("specialised", "spec_cp_dual_launch")
    assert a1[4] == (tid, 0, 1) and k1 == {} and a1[6] is True
    assert a2[:2] == ("specialised", "spec_tv_subgrad_launch")
    assert a2[4] == (tid, 1) and a2[6] is False


def test_unsharded_tv_passes_launch_their_table(monkeypatch):
    """What the unsharded TV norms (B3) and pass A for inverse problems (B5)
    hand their library: the table id first, then the storage flags, with
    the partials they write counted; the halo mode of the norms reaches its
    per-table ``spectv_norms_halo_launch`` with the whole volume's table.
    (The launches' own functions, called with CPU tensors and ``_launch``
    recording.)"""
    import torch

    from pytv4d_tpu_torch.kernels import fused

    seen = []
    monkeypatch.setattr(fused, "_launch",
                        lambda *a, **k: seen.append((a, k)) or "parts")
    profiling.clear_counters()
    cfg = TVConfig(scheme="hybrid", reg_time=0.5)
    x = torch.zeros((3, 2, 4, 6), dtype=torch.bfloat16)
    y_D = torch.zeros((3, 2, 8, 4, 6))
    tid = tables.table_id(cfg, 3, 2)
    assert tables.TABLES[tid] == ((AXIS_ROW, FWD), (AXIS_COL, FWD),
                                  (AXIS_ROW, BWD), (AXIS_COL, BWD),
                                  (AXIS_Z, FWD), (AXIS_Z, BWD),
                                  (AXIS_T, FWD), (AXIS_T, BWD))
    norms, parts = fused._tv_norms_kernel(x, cfg=cfg)
    assert parts == "parts" and norms.shape == x.shape
    out, parts = fused._tv_dual_kernel(x, y_D, cfg=cfg, sigma_D=0.5, reg=1.0)
    assert out is y_D and parts == "parts"
    ext = torch.zeros((5, 4, 4, 6))
    fused._tv_norms_kernel(ext, cfg=cfg, halo_mode=True, table_dims=(3, 2))
    (a1, k1), (a2, k2), (a3, k3) = seen
    assert a1[:2] == ("specialised_tv", "spectv_norms_launch")
    assert a1[4] == (tid, 1) and a1[5][0] is x and a1[6] is True
    assert a2[:2] == ("specialised_tv", "spectv_dual_launch")
    assert a2[4] == (tid, 1, 0) and a2[5] == (x, y_D) and a2[6] is True
    assert a3[:2] == ("specialised_tv", "spectv_norms_halo_launch")
    assert a3[4] == (tid, 0) and a3[5][0] is ext and a3[6] is True
    assert tuple(a3[2].shape) == (3, 2, 4, 6)  # the partials of the shard
    assert profiling.counters() == {"launch.B3": 2, "launch.B5": 1}
