"""The TV passes B3 (norms) and B4 (subgradient) and pass A for inverse
problems (B5) in their halo mode, per channel table (no nvcc or GPU
needed).

On a shard the wrappers launch the per-table halo kernels of
``csrc/specialised_tv.cu`` (``spectv_norms_halo_launch``,
``spectv_dual_halo_launch``) and ``csrc/specialised.cu``
(``spec_tv_subgrad_halo_launch``) with the channel table of the WHOLE
volume (``table_dims``), which differs from the shard's own wherever a
shard is one plane thick along z or t; on a volume they launch the
unsharded kernels as before; a table outside the compiled list raises
before any launch.  Each case calls the wrappers' launch functions
(``_tv_norms_kernel``, ``_tv_subgrad_kernel``, ``_tv_dual_kernel``) on CPU
tensors with ``_launch`` recording, so no kernel runs."""

import itertools
import os
import re

import pytest
import torch

from pytv4d_tpu_torch.core.config import TVConfig
from pytv4d_tpu_torch.core.schemes import (
    AXIS_COL,
    AXIS_ROW,
    AXIS_T,
    AXIS_Z,
    BWD,
    FWD,
    SCHEMES,
    scheme_channels,
)
from pytv4d_tpu_torch.kernels import build, fused, tables
from pytv4d_tpu_torch.parallel import fused_halo as fh
from pytv4d_tpu_torch.parallel.mesh import grid_map, indexed, make_mesh
from pytv4d_tpu_torch.parallel.mesh import shard_volume
from pytv4d_tpu_torch.utils import profiling


STORAGE = [(torch.float32, torch.float32), (torch.float32, torch.bfloat16),
           (torch.bfloat16, torch.float32), (torch.bfloat16, torch.bfloat16)]


@pytest.fixture
def launches(monkeypatch):
    """The ``_launch`` calls the wrappers make, recorded instead of run, and
    the three launch counters from 0."""
    seen = []

    def record(name, fn_name, x, p, flags, args, with_parts=False,
               shape=None):
        seen.append(dict(lib=name, fn=fn_name, x=x, p=p, flags=flags,
                         args=args, with_parts=with_parts, shape=shape))
        return "parts" if with_parts else None

    monkeypatch.setattr(fused, "_launch", record)
    profiling.clear_counters()
    return seen


def _halo_operands(vol, mesh_zt, cfg):
    """The shards of ``vol`` on a (z, t) mesh on the CPU, extended as the
    sharded TV extends them: x by 1 and by 2 planes per side in z and t, and
    norms (ones) by 1 with safe divisors."""
    shape = tuple(vol.shape)
    grid = shard_volume(vol, make_mesh(*mesh_zt, device="cpu"),
                        mesh_zt[1] > 1)
    chans, _ = scheme_channels(cfg.scheme, shape[0], shape[1],
                               cfg.reg_z_over_reg, cfg.reg_time)
    gz = fh._axis_ghost_kind(chans, AXIS_Z)
    gt = fh._axis_ghost_kind(chans, AXIS_T)
    x1 = fh._extend_axis(fh._extend_axis(grid, 0, gz), 1, gt)
    x2 = fh._extend_axis2(fh._extend_axis2(grid, 0, gz), 1, gt)
    n1 = fh._extend_norms(grid_map(
        lambda s: torch.ones(s.shape, dtype=torch.float32), grid))
    return grid, x1, x2, n1


# (scheme, reg_time, global (Nz, M), mesh (z, t)): grids whose shards are one
# plane thick along z, t or both, so that the shard's own (Nz, M) would
# pick another table than the whole volume's
GRIDS = [
    ("hybrid", 0.5, (2, 2), (2, 2)),     # shards (1, 1): no z, no t channel
    ("hybrid", 0.5, (4, 2), (2, 2)),     # shards (2, 1): M = 1
    ("central", 0.5, (2, 4), (2, 2)),    # shards (1, 2): Nz = 1, t FWD
    ("upwind", 0.5, (4, 4), (4, 2)),     # shards (1, 2)
    ("downwind", 0.5, (6, 2), (3, 2)),   # shards (2, 1)
    ("central", 0.5, (6, 6), (3, 2)),    # shards (2, 3): central FWD
]


@pytest.mark.parametrize("scheme, reg_time, dims, mesh_zt", GRIDS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_a_shard_takes_the_whole_volumes_table(launches, scheme, reg_time,
                                               dims, mesh_zt, dtype):
    """B3, B4 and B5 on each shard, x extended as the sharded TV and the
    sharded CT solve extend it, go to the per-table halo launches with the
    whole volume's table id and Params of the shard; B5's partials are
    counted for the shard's shape."""
    cfg = TVConfig(scheme=scheme, reg_time=reg_time)
    vol = torch.rand(dims + (4, 8), generator=torch.Generator().manual_seed(
        0)).to(dtype)
    grid, x1, x2, n1 = _halo_operands(vol, mesh_zt, cfg)
    local = tuple(grid[0][0].shape)
    want = tables.table_id(cfg, *dims)
    assert want != tables.table_id(cfg, *local[:2])  # the case bites
    Nd = len(scheme_channels(scheme, *dims, cfg.reg_z_over_reg,
                             reg_time)[0])
    mode = dict(cfg=cfg, halo_mode=True, table_dims=dims)
    for iz, it, _ in indexed(grid):
        norms, parts = fused._tv_norms_kernel(x1[iz][it], **mode)
        g = fused._tv_subgrad_kernel(x2[iz][it], n1[iz][it], **mode)
        assert parts == "parts" and tuple(norms.shape) == local
        assert norms.dtype == torch.float32
        assert tuple(g.shape) == local and g.dtype == dtype
        y_D = torch.zeros(local[:2] + (Nd,) + local[2:], dtype=dtype)
        got, parts = fused._tv_dual_kernel(x1[iz][it], y_D, sigma_D=0.5,
                                           reg=1.0, **mode)
        assert got is y_D and parts == "parts"
    n = mesh_zt[0] * mesh_zt[1]
    assert profiling.counters() == {
        "launch.B3": n, "launch.B4": n, "launch.B5": n}
    assert len(launches) == 3 * n
    bf16 = int(dtype == torch.bfloat16)
    x1s = [xe for _, _, xe in indexed(x1)]
    for i, call in enumerate(launches):
        p, kind = call["p"], i % 3
        assert (call["lib"], call["fn"]) == (
            ("specialised_tv", "spectv_norms_halo_launch"),
            ("specialised", "spec_tv_subgrad_halo_launch"),
            ("specialised_tv", "spectv_dual_halo_launch"))[kind]
        assert call["flags"] == (want, bf16) + ((bf16,) if kind == 2 else ())
        assert call["with_parts"] is (kind != 1)
        # what the C entry points require of a shard's Params
        assert (p.Nz, p.M) == local[:2] and p.Nd == Nd
        assert (p.sharded, p.t_free) == (1, 1)
        assert (p.xe, p.ne) == ((2, 1) if kind == 1 else (1, 0))
        if kind == 2:
            assert call["args"][0] is x1s[i // 3]
            assert call["shape"] == local and p.has_tmul == 0


def test_an_unsharded_pass_a_for_inverse_problems_launches_as_before(
        launches):
    cfg = TVConfig(scheme="hybrid", reg_time=0.5)
    x = torch.zeros(3, 2, 4, 8)
    y_D = torch.zeros(3, 2, 4, 4, 8, dtype=torch.bfloat16)
    fused._tv_dual_kernel(x, y_D, cfg=cfg, sigma_D=0.5, reg=1.0)
    (call,) = launches
    assert (call["lib"], call["fn"], call["flags"]) == (
        "specialised_tv", "spectv_dual_launch",
        (tables.table_id(cfg, 3, 2), 0, 1))
    assert call["args"] == (x, y_D) and call["shape"] == (3, 2, 4, 8)
    assert call["p"].sharded == 0 and profiling.counters()["launch.B5"] == 1


@pytest.mark.parametrize("tid", range(len(tables.TABLES)))
def test_each_table_reaches_the_halo_launches(launches, tid):
    """Every one of the 21 tables the halo kernels are compiled for is handed
    to them as its id, from a whole volume that has it, on a one-plane
    shard whose own (Nz, M) has no z or t channel."""
    cfg, dims = next(
        (TVConfig(scheme=s, reg_z_over_reg=z, reg_time=t), (Nz, M))
        for s, z, t, Nz, M in itertools.product(
            SCHEMES, (0.0, 1.0), (0.0, 0.5), (1, 2, 3), (1, 2, 3))
        if tables.table_id(TVConfig(scheme=s, reg_z_over_reg=z,
                                    reg_time=t), Nz, M) == tid)
    mode = dict(cfg=cfg, halo_mode=True, table_dims=dims)
    fused._tv_norms_kernel(torch.zeros(3, 3, 4, 8), **mode)
    fused._tv_subgrad_kernel(torch.zeros(5, 5, 4, 8),
                             torch.ones(3, 3, 4, 8), **mode)
    Nd = len(tables.TABLES[tid])
    for x_dt, d_dt in STORAGE:  # B5's four storage pairs
        fused._tv_dual_kernel(torch.zeros(3, 3, 4, 8, dtype=x_dt),
                              torch.zeros(1, 1, Nd, 4, 8, dtype=d_dt),
                              sigma_D=0.5, reg=1.0, **mode)
    assert [(c["fn"], c["flags"]) for c in launches] == [
        ("spectv_norms_halo_launch", (tid, 0)),
        ("spec_tv_subgrad_halo_launch", (tid, 0))] + [
        ("spectv_dual_halo_launch", (tid, int(x_dt == torch.bfloat16),
                                     int(d_dt == torch.bfloat16)))
        for x_dt, d_dt in STORAGE]


def test_an_unsharded_call_launches_as_before(launches):
    cfg = TVConfig(scheme="hybrid", reg_time=0.5)
    x = torch.zeros(3, 2, 4, 8, dtype=torch.bfloat16)
    norms, parts = fused._tv_norms_kernel(x, cfg=cfg)
    g = fused._tv_subgrad_kernel(x, norms, cfg=cfg)
    tid = tables.table_id(cfg, 3, 2)
    (a, b) = launches
    assert (a["lib"], a["fn"], a["flags"]) == (
        "specialised_tv", "spectv_norms_launch", (tid, 1))
    assert (b["lib"], b["fn"], b["flags"]) == (
        "specialised", "spec_tv_subgrad_launch", (tid, 1))
    assert a["args"] == (x, None, norms) and b["args"] == (x, norms, None, g)
    assert a["p"].sharded == 0 and b["p"].sharded == 0
    assert profiling.counters() == {"launch.B3": 1, "launch.B4": 1}


def test_aniso_halo_subgradient_reads_no_norms(launches):
    """The aniso G never divides by the norms: the halo launch gets none."""
    cfg = TVConfig(scheme="hybrid", reg_time=0.5, norm="aniso")
    fused._tv_subgrad_kernel(torch.zeros(5, 5, 4, 8), None, cfg=cfg,
                             halo_mode=True, table_dims=(4, 2))
    (call,) = launches
    assert call["fn"] == "spec_tv_subgrad_halo_launch"
    assert call["args"][1] is None


@pytest.mark.parametrize("halo_mode", [True, False])
def test_a_table_outside_the_built_list_raises(launches, monkeypatch,
                                               request, halo_mode):
    """A channel table the kernels are not compiled for raises ValueError
    before any launch; nothing falls back to a generic kernel."""
    real = scheme_channels
    # table_id remembers its answers: forget them around the odd table
    tables.table_id.cache_clear()
    request.addfinalizer(tables.table_id.cache_clear)

    def odd_table(*args, **kw):  # row forward, column backward: no scheme's
        chans, norm = real(*args, **kw)
        return [c for c in chans if (c.axis, c.kind) in (
            (AXIS_ROW, FWD), (AXIS_COL, BWD))], norm

    monkeypatch.setattr(tables, "scheme_channels", odd_table)
    cfg = TVConfig(scheme="hybrid", reg_time=0.5)
    e = 1 if halo_mode else 0
    mode = dict(cfg=cfg, halo_mode=halo_mode, table_dims=(4, 2))
    with pytest.raises(ValueError, match="no specialised kernel"):
        fused._tv_norms_kernel(torch.zeros(2 + 2 * e, 2 + 2 * e, 4, 8),
                               **mode)
    with pytest.raises(ValueError, match="no specialised kernel"):
        fused._tv_subgrad_kernel(torch.zeros(2 + 4 * e, 2 + 4 * e, 4, 8),
                                 torch.ones(2 + 2 * e, 2 + 2 * e, 4, 8),
                                 **mode)
    with pytest.raises(ValueError, match="no specialised kernel"):
        fused._tv_dual_kernel(torch.zeros(2 + 2 * e, 2 + 2 * e, 4, 8),
                              torch.zeros(2, 2, 2, 4, 8), sigma_D=0.5,
                              reg=1.0, **mode)
    assert launches == []
    assert profiling.counters() == {}


def _source(name):
    with open(os.path.join(build.CSRC, name)) as f:
        return f.read()


def test_the_generic_tv_kernels_are_gone():
    """csrc/tv_fused.cu, the last generic body on a shard, is gone with its
    library; B3, B4 and B5 are the per-table kernels in both modes, a HALO
    template flag each (B4 also a GD flag, its subgradient-descent
    epilogue)."""
    assert not os.path.exists(os.path.join(build.CSRC, "tv_fused.cu"))
    assert "tv_fused" not in fused._ENTRY_POINTS
    assert re.search(r"template <Table T, typename TX, bool HALO, bool GD>"
                     r"\s*__global__ void __launch_bounds__\(BLOCK\)\s*"
                     r"tv_subgrad_spec_kernel", _source("specialised.cu"))
    assert re.search(r"template <Table T, typename TX, bool HALO>\s*"
                     r"__global__ void __launch_bounds__\(BLOCK, "
                     r"NORMS_MIN_BLOCKS\)\s*tv_norms_spec_kernel",
                     _source("specialised_tv.cu"))
    assert re.search(r"template <Table T, typename TX, typename TD, "
                     r"bool HALO>\s*__global__ void "
                     r"__launch_bounds__\(BLOCK\)\s*tv_dual_spec_kernel",
                     _source("specialised_tv.cu"))
    # the generic bodies' halo addressing went with their last caller
    for header in ("stencil.cuh", "voxel.cuh"):
        assert "HALO" not in re.sub(r"//[^\n]*", "", _source(header))
    vox = re.search(r"struct Vox \{(.*?)\};", _source("voxel.cuh"), re.S)
    assert not re.search(r"\bxn\b", vox.group(1))
    assert "v.xn" not in _source("voxel.cuh")


@pytest.mark.parametrize("source, launch, check", [
    ("specialised.cu", "spec_tv_subgrad_halo_launch",
     "!p->sharded || !p->t_free || p->xe != 2 || p->ne != 1"),
    ("specialised_tv.cu", "spectv_norms_halo_launch",
     "!p->sharded || !p->t_free || p->xe != 1"),
    ("specialised_tv.cu", "spectv_dual_halo_launch",
     "!p->sharded || !p->t_free || p->xe != 1 || p->has_tmul"),
])
def test_a_halo_launch_refuses_unsharded_params(source, launch, check):
    """The halo entry points refuse Params that do not describe a shard's
    extended operands (the unsharded wrappers' Params among them) before
    the switch over the tables."""
    text = _source(source)
    body = re.search(rf"int {launch}\((.*?)\n}}", text, re.S).group(1)
    assert body.index(f"if ({check})") < body.index("switch (id)")
