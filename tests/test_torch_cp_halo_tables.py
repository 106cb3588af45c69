"""CP passes A (B1) and B (B2) in their sharded modes, per channel table (no
nvcc or GPU needed).

On a shard the wrappers launch the per-table kernels of
``csrc/specialised_cp.cu``: ``halo_mode`` (the ghost-plane step; all 21
tables) and ``interior`` (the overlapped step; the tables of
``kernels.tables.BOUNDARY_TABLES``, B8's), each with the channel table of the
WHOLE volume (``table_dims``); on a volume they launch the unsharded
per-table kernels (B1 and B2, ``csrc/specialised.cu``); a table outside a
list raises before any launch.  Each case calls the wrappers'
launch functions (``_cp_dual_kernel``, ``_cp_primal_kernel``) on CPU tensors
with ``_launch`` recording, so no kernel runs.  The C sources are read as
text: the list of interior tables, the switches, the checks of Params, the
partial counts, and that the generic passes A and B are gone.  Each launch
counts under its launch function (``launches_by_fn``), which tells the
modes apart."""

import collections
import itertools
import os
import re

import numpy as np
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
from pytv4d_tpu_torch.parallel.mesh import indexed, make_mesh, shard_volume
from pytv4d_tpu_torch.utils import profiling

BLOCK, VEC = 256, 2  # csrc/stencil.cuh, csrc/specialised_cp.cu
with open(os.path.join(build.CSRC, "specialised.cu")) as _f:
    # the unsharded pass B's columns a run
    VEC_B = int(re.search(r"constexpr int VEC_B = (\d+);", _f.read())[1])
STORAGE = [(torch.float32, torch.float32), (torch.float32, torch.bfloat16),
           (torch.bfloat16, torch.float32), (torch.bfloat16, torch.bfloat16)]
HALO_LAUNCHES = ("spcp_dual_halo_launch", "spcp_primal_halo_launch")
INTERIOR_LAUNCHES = ("spcp_dual_interior_launch",
                     "spcp_primal_interior_launch")


def _slots(Nr, Nc):
    """Partials per plane of a launch with one block per BLOCK voxels
    (stencil.cuh's num_parts), and of one with BLOCK runs of VEC columns a
    block (specialised.cuh's dual_blocks)."""
    return -(-Nr * Nc // BLOCK), -(-Nr * -(-Nc // VEC) // BLOCK)


def _count(fn_name, shape):
    """A Python mirror of the C count of the partials ``fn_name`` writes for
    an (Nz, M, Nr, Nc) volume or shard."""
    Nz, M, Nr, Nc = shape
    slots, blocks = _slots(Nr, Nc)
    per_plane = blocks if fn_name in ("spec_cp_dual_launch",
                                      *HALO_LAUNCHES) else slots
    if fn_name == "spec_cp_primal_launch":
        per_plane = -(-Nr * -(-Nc // VEC_B) // BLOCK)
    return Nz * M * per_plane


@pytest.fixture
def launches(monkeypatch):
    """The ``_launch`` calls the wrappers make, recorded instead of run
    (partials: zeros of the mirrored count), and the two wrappers' launch
    counters from 0."""
    seen = []

    def record(name, fn_name, x, p, flags, args, with_parts=False,
               shape=None):
        seen.append(dict(lib=name, fn=fn_name, x=x, p=p, flags=flags,
                         args=args, with_parts=with_parts))
        if with_parts:
            return torch.zeros(_count(fn_name, shape or tuple(x.shape)))
        return None

    monkeypatch.setattr(fused, "_launch", record)
    profiling.clear_counters()
    return seen


def _kw(cfg, **more):
    dual = dict(cfg=cfg, sigma_D=0.5, sigma_A=1.0, reg=1.0, **more)
    primal = dict(cfg=cfg, tau=0.1, **more)
    return dual, primal


def _shard_state(vol, mesh_zt, cfg, d_dtype):
    """x's shards on a (z, t) mesh on the CPU, x extended as the ghost-plane
    step extends it, and zero duals (the shard's and its extended copy)."""
    dims = tuple(vol.shape[:2])
    grid = shard_volume(vol, make_mesh(*mesh_zt, device="cpu"),
                        mesh_zt[1] > 1)
    chans, _ = scheme_channels(cfg.scheme, *dims, cfg.reg_z_over_reg,
                               cfg.reg_time)
    x1 = fh._extend_axis(fh._extend_axis(
        grid, 0, fh._axis_ghost_kind(chans, AXIS_Z)), 1,
        fh._axis_ghost_kind(chans, AXIS_T))
    y_D = [[torch.zeros((s.shape[0], s.shape[1], len(chans)) + s.shape[2:],
                        dtype=d_dtype) for s in row] for row in grid]
    return grid, x1, y_D, fh._extend_dual(y_D, chans), len(chans)


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
@pytest.mark.parametrize("x_dtype, d_dtype", STORAGE)
def test_a_halo_shard_takes_the_whole_volumes_table(
        launches, scheme, reg_time, dims, mesh_zt, x_dtype, d_dtype):
    cfg = TVConfig(scheme=scheme, reg_time=reg_time)
    vol = torch.rand(dims + (4, 8), generator=torch.Generator().manual_seed(
        0)).to(x_dtype)
    grid, x1, y_D, y_ext, Nd = _shard_state(vol, mesh_zt, cfg, d_dtype)
    local = tuple(grid[0][0].shape)
    want = tables.table_id(cfg, *dims)
    assert want != tables.table_id(cfg, *local[:2])  # the case bites
    dk, pk = _kw(cfg, halo_mode=True, table_dims=dims)
    for iz, it, xs in indexed(grid):
        x0, y_A, out = xs.clone(), torch.zeros_like(xs), torch.empty_like(xs)
        yd, ye = y_D[iz][it], y_ext[iz][it]
        _, _, tv = fused._cp_dual_kernel(x1[iz][it], x0, y_A, yd, **dk)
        got, fid = fused._cp_primal_kernel(xs, x0, y_A, yd, out=out,
                                           y_ext=ye, **pk)
        assert got is out
        assert tv.shape == fid.shape == (_count(HALO_LAUNCHES[0], local),)
        assert launches[-2]["args"] == (x1[iz][it], x0, y_A, yd, None)
        assert launches[-1]["args"] == (xs, x0, y_A, ye, None, out)
    n = mesh_zt[0] * mesh_zt[1]
    assert profiling.counters() == {
        "launch.B1": n, "launch.B1/spcp_dual_halo_launch": n,
        "launch.B2": n, "launch.B2/spcp_primal_halo_launch": n}
    assert len(launches) == 2 * n
    flags = (want, int(x_dtype == torch.bfloat16),
             int(d_dtype == torch.bfloat16))
    for i, call in enumerate(launches):
        p = call["p"]
        assert (call["lib"], call["fn"]) == ("specialised_cp",
                                             HALO_LAUNCHES[i % 2])
        assert call["flags"] == flags and call["with_parts"]
        # what the C entry points require of a shard's Params
        assert (p.Nz, p.M) == local[:2] and p.Nd == Nd
        assert (p.sharded, p.t_free) == (1, 1)
        assert (p.xe, p.ye) == ((1, 0) if i % 2 == 0 else (0, 1))
        assert (p.z_first, p.z_last) == (0, local[0] - 1)


def _configs_of(tid, Nz_values, M_values):
    """A (cfg, (Nz, M)) whose scheme has table ``tid`` at (Nz, M)."""
    return next(
        (TVConfig(scheme=s, reg_z_over_reg=z, reg_time=t), (Nz, M))
        for s, z, t, Nz, M in itertools.product(
            SCHEMES, (0.0, 1.0), (0.0, 0.5), Nz_values, M_values)
        if tables.table_id(TVConfig(scheme=s, reg_z_over_reg=z,
                                    reg_time=t), Nz, M) == tid)


@pytest.mark.parametrize("tid", range(len(tables.TABLES)))
def test_each_table_reaches_the_halo_launches(launches, tid):
    """Every one of the 21 tables the halo kernels are compiled for is handed
    to them as its id, from a whole volume that has it, on a one-plane
    shard whose own (Nz, M) has no z or t channel."""
    cfg, dims = _configs_of(tid, (1, 2, 3), (1, 2, 3))
    Nd = len(scheme_channels(cfg.scheme, *dims, cfg.reg_z_over_reg,
                             cfg.reg_time)[0])
    dk, pk = _kw(cfg, halo_mode=True, table_dims=dims)
    xs = torch.zeros(1, 1, 4, 8)
    yd = torch.zeros(1, 1, Nd, 4, 8)
    fused._cp_dual_kernel(torch.zeros(3, 3, 4, 8), xs, xs, yd, **dk)
    fused._cp_primal_kernel(xs, xs, xs, yd, out=xs,
                            y_ext=torch.zeros(3, 3, Nd, 4, 8), **pk)
    assert [(c["fn"], c["flags"]) for c in launches] == [
        ("spcp_dual_halo_launch", (tid, 0, 0)),
        ("spcp_primal_halo_launch", (tid, 0, 0))]


@pytest.mark.parametrize("tid", tables.BOUNDARY_TABLES)
@pytest.mark.parametrize("x_dtype, d_dtype", STORAGE[::3])
def test_each_interior_table_reaches_the_interior_launches(
        launches, tid, x_dtype, d_dtype):
    """Every table the interior kernels are compiled for is handed to them
    as its id by the overlapped step of a volume that has it (2 z-shards of
    3 planes), with Params of planes 1 .. Nz-2, z ungated and t gated; the
    partials are the (Nz, k) rows B8 finishes."""
    cfg, dims = _configs_of(tid, (6,), (1, 2, 3))
    Nd = len(scheme_channels(cfg.scheme, *dims, cfg.reg_z_over_reg,
                             cfg.reg_time)[0])
    shard = (3, dims[1], 5, 7)
    dk, pk = _kw(cfg, interior=True, table_dims=dims)
    xs = torch.zeros(shard, dtype=x_dtype)
    yd = torch.zeros(shard[:2] + (Nd,) + shard[2:], dtype=d_dtype)
    _, _, tv = fused._cp_dual_kernel(xs, xs, xs, yd, **dk)
    _, fid = fused._cp_primal_kernel(xs, xs, xs, yd, out=xs, **pk)
    flags = (tid, int(x_dtype == torch.bfloat16),
             int(d_dtype == torch.bfloat16))
    assert [(c["lib"], c["fn"], c["flags"]) for c in launches] == [
        ("specialised_cp", fn, flags) for fn in INTERIOR_LAUNCHES]
    assert launches[0]["args"] == (xs, xs, xs, yd, None)
    assert launches[1]["args"] == (xs, xs, xs, yd, None, xs)
    for call in launches:
        p = call["p"]
        assert (p.sharded, p.t_free, p.xe, p.ye) == (1, 0, 0, 0)
        assert (p.Nz, p.z_first, p.z_last) == (3, 1, 1)
    slots, _ = _slots(*shard[2:])
    assert tv.shape == fid.shape == (3, shard[1] * slots)
    assert profiling.counters() == {
        "launch.B1": 1, f"launch.B1/{INTERIOR_LAUNCHES[0]}": 1,
        "launch.B2": 1, f"launch.B2/{INTERIOR_LAUNCHES[1]}": 1}


def test_an_interior_shard_takes_the_whole_volumes_table(launches):
    """The interior launches take the table of ``table_dims``, not the
    shard's own (here the whole volume has time channels, the shard's
    (Nz, M) would not)."""
    cfg = TVConfig(scheme="hybrid", reg_time=0.5)
    dims, shard = (6, 2), (3, 1, 4, 8)
    want = tables.boundary_table_id(cfg, *dims)
    assert want != tables.table_id(cfg, *shard[:2])
    Nd = len(scheme_channels("hybrid", *dims, 1.0, 0.5)[0])
    xs, yd = torch.zeros(shard), torch.zeros(3, 1, Nd, 4, 8)
    dk, pk = _kw(cfg, interior=True, table_dims=dims)
    fused._cp_dual_kernel(xs, xs, xs, yd, **dk)
    fused._cp_primal_kernel(xs, xs, xs, yd, out=xs, **pk)
    assert [c["flags"][0] for c in launches] == [want, want]
    assert all(c["p"].Nd == Nd for c in launches)


def test_the_solvers_steps_launch_the_new_kernels(launches, monkeypatch):
    """One iteration of the sharded CP solver on each step hands its passes
    to ``csrc/specialised_cp.cu`` (the ghost-plane step: the halo mode; the
    overlapped step: the interior launches, then B8), with the whole
    volume's table."""
    # on the CPU the wrappers run the plain versions: route those to the
    # launch functions, as a CUDA device would
    for plain, kernel in (
            ("cp_dual_plain", fused._cp_dual_kernel),
            ("cp_primal_plain", fused._cp_primal_kernel),
            ("cp_dual_boundary_plain", fused._dual_boundary_kernel),
            ("cp_primal_boundary_plain", fused._primal_boundary_kernel)):
        monkeypatch.setattr(fused, plain, kernel)
    cfg = TVConfig(scheme="hybrid", reg_time=0.5)
    shape, want = (6, 2, 4, 8), tables.table_id(cfg, 6, 2)
    vol = torch.rand(shape, generator=torch.Generator().manual_seed(1))
    mesh = make_mesh(2, 1, device="cpu")
    Nd = len(scheme_channels("hybrid", 6, 2, 1.0, 0.5)[0])
    args = [shard_volume(t, mesh, False) for t in (
        vol, vol, torch.zeros(shape),
        torch.zeros(shape[:2] + (Nd,) + shape[2:]))]
    for overlap, fns in (
            (False, ["spcp_dual_halo_launch"] * 2
             + ["spcp_primal_halo_launch"] * 2),
            (True, ["spcp_dual_interior_launch"] * 2
             + ["cp_dual_boundary_launch"] * 2
             + ["spcp_primal_interior_launch"] * 2
             + ["cp_primal_boundary_launch"] * 2)):
        solve = fh.make_sharded_cp_solver_fused(
            mesh, cfg, shape, reg=1.0, n_iter=1, shard_time=False,
            overlap=overlap)
        launches.clear()
        profiling.clear_counters()
        solve(*args)
        assert [c["fn"] for c in launches] == fns
        assert all(c["flags"][0] == want for c in launches)
        # the counts by launch function tell the step's mode
        by_fn = {key.split("/")[1]: n for key, n
                 in profiling.counters().items() if "/" in key}
        assert by_fn == collections.Counter(
            fn for fn in fns if fn.startswith("spcp_"))


def test_an_unsharded_call_launches_as_before(launches):
    cfg = TVConfig(scheme="hybrid", reg_time=0.5)
    x = torch.zeros(3, 2, 4, 8, dtype=torch.bfloat16)
    Nd = len(scheme_channels("hybrid", 3, 2, 1.0, 0.5)[0])
    yd = torch.zeros(3, 2, Nd, 4, 8)
    out = torch.empty_like(x)
    dk, pk = _kw(cfg)
    fused._cp_dual_kernel(x, x, x, yd, **dk)
    fused._cp_primal_kernel(x, x, x, yd, out=out, **pk)
    tid = tables.table_id(cfg, 3, 2)
    (a, b) = launches
    assert (a["lib"], a["fn"], a["flags"]) == (
        "specialised", "spec_cp_dual_launch", (tid, 1, 0))
    # pass B: the unsharded volume's table too (no generic kernel left)
    assert (b["lib"], b["fn"], b["flags"]) == (
        "specialised", "spec_cp_primal_launch", (tid, 1, 0))
    assert a["args"] == (x, x, x, yd, None)
    assert b["args"] == (x, x, x, yd, None, out)
    assert a["p"].sharded == 0 and b["p"].sharded == 0
    assert profiling.counters() == {
        "launch.B1": 1, "launch.B1/spec_cp_dual_launch": 1,
        "launch.B2": 1, "launch.B2/spec_cp_primal_launch": 1}


def test_a_halo_table_outside_the_built_list_raises(launches, monkeypatch,
                                                    request):
    """A channel table the halo kernels are not compiled for raises
    ValueError before any launch; nothing falls back to a generic kernel."""
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
    dk, pk = _kw(cfg, halo_mode=True, table_dims=(4, 2))
    xs, yd = torch.zeros(2, 2, 4, 8), torch.zeros(2, 2, 2, 4, 8)
    with pytest.raises(ValueError, match="no specialised kernel"):
        fused._cp_dual_kernel(torch.zeros(4, 4, 4, 8), xs, xs, yd, **dk)
    with pytest.raises(ValueError, match="no specialised kernel"):
        fused._cp_primal_kernel(xs, xs, xs, yd, out=xs,
                                y_ext=torch.zeros(4, 4, 2, 4, 8), **pk)
    assert launches == []
    assert profiling.counters() == {}


@pytest.mark.parametrize("cfg, dims", [
    (TVConfig(scheme="hybrid", reg_z_over_reg=0.0, reg_time=0.5), (6, 3)),
    (TVConfig(scheme="upwind", reg_z_over_reg=0.0), (6, 1)),
    (TVConfig(scheme="central", reg_time=0.5), (2, 3)),   # FWD z: table 17
])
def test_an_interior_table_outside_the_list_raises(launches, cfg, dims):
    """A table without a z channel (or central's FWD z) has no interior
    kernel: ValueError before any launch."""
    Nd = len(scheme_channels(cfg.scheme, *dims, cfg.reg_z_over_reg,
                             cfg.reg_time)[0])
    xs = torch.zeros(3, dims[1], 4, 8)
    yd = torch.zeros(3, dims[1], Nd, 4, 8)
    dk, pk = _kw(cfg, interior=True, table_dims=dims)
    with pytest.raises(ValueError, match="no boundary kernel"):
        fused._cp_dual_kernel(xs, xs, xs, yd, **dk)
    with pytest.raises(ValueError, match="no boundary kernel"):
        fused._cp_primal_kernel(xs, xs, xs, yd, out=xs, **pk)
    assert launches == []
    assert profiling.counters() == {}


def _source(name):
    with open(os.path.join(build.CSRC, name)) as f:
        return f.read()


def _body(text, fn):
    return re.search(rf"\b{fn}\((.*?)\n}}", text, re.S).group(1)


def test_the_interior_list_is_the_sources():
    """Python's interior list, B8's, is ``csrc/tables.cuh``'s
    ``TABLES_WITH_Z`` X-list, the one list of the nine in C; each halo entry
    point switches over all 21 tables, each interior one over that list,
    and each fails any other id."""
    text = _source("tables.cuh").replace("\\\n", " ")
    body = re.search(r"#define TABLES_WITH_Z\(X\)(.*)", text).group(1)
    assert tuple(int(i) for i in re.findall(r"X\((\d+)\)", body)) == \
        tables.BOUNDARY_TABLES == tables.ZSTREAM_TABLES
    for name in ("specialised_cp.cu", "cp_boundary.cu", "cp_zstream.cu"):
        assert "#define TABLES_WITH_Z" not in _source(name)
    text = _source("specialised_cp.cu")
    assert set(fused._ENTRY_POINTS["specialised_cp"][2]) == {
        *HALO_LAUNCHES, *INTERIOR_LAUNCHES}
    for launch in (*HALO_LAUNCHES, *INTERIOR_LAUNCHES):
        body = _body(text, f"int {launch}")
        assert re.search(r"switch \(id\)", body)
        assert ("CHANNEL_TABLES(SPEC_CASE)" if launch in HALO_LAUNCHES
                else "TABLES_WITH_Z(INTERIOR_CASE)") in body
        assert body.rstrip().endswith("return (int)cudaErrorInvalidValue;")


@pytest.mark.parametrize("launch, check", [
    ("spcp_dual_halo_launch", "shard_params<true>(p, p->xe)"),
    ("spcp_primal_halo_launch", "shard_params<true>(p, p->ye)"),
    ("spcp_dual_interior_launch", "shard_params<false>(p, 0)"),
    ("spcp_primal_interior_launch", "shard_params<false>(p, 0)"),
])
def test_each_new_launch_refuses_unsharded_params(launch, check):
    """The entry points refuse Params that do not describe a shard in their
    mode (the unsharded wrappers' Params among them) before the switch over
    the tables; the unsharded pass B refuses a shard's."""
    text = _source("specialised_cp.cu")
    body = _body(text, f"int {launch}")
    assert body.index(f"if (!{check})") < body.index("switch (id)")
    rule = _body(text, "static inline bool shard_params")
    assert "if (HALO) return p->sharded && p->t_free && ext == 1;" in rule
    assert ("return p->sharded && !p->t_free && p->Nz >= 3 && "
            "p->z_first == 1 &&") in rule
    body = _body(_source("specialised.cu"), "int spec_cp_primal_launch")
    assert body.index("if (p->sharded) return (int)cudaErrorInvalidValue;"
                      ) < body.index("switch (id)")


def test_the_generic_cp_dual_kernel_is_gone():
    """csrc/cp_fused.cu, which last kept the generic unsharded pass B, is
    gone with its library; B1 and B2 are per-table kernels on a volume
    (csrc/specialised.cu) and on a shard (a HALO template flag each), and
    the generic per-voxel CP bodies have no sharded branch left."""
    assert not os.path.exists(os.path.join(build.CSRC, "cp_fused.cu"))
    assert "cp_fused" not in fused._ENTRY_POINTS
    assert not any("cp_fused" in name for name in os.listdir(build.CSRC))
    spec = _source("specialised.cu")
    assert re.search(r"template <Table T, typename TX, typename TD>\s*"
                     r"__global__ void __launch_bounds__\(BLOCK\)\s*"
                     r"cp_primal_spec_kernel", spec)
    assert "primal_spec_body<T, VEC_B, TX, TD>" in spec
    assert "_voxel" not in re.sub(r"//[^\n]*", "", spec)
    spcp = _source("specialised_cp.cu")
    for kernel in ("cp_dual_shard_kernel", "cp_primal_shard_kernel"):
        assert re.search(r"template <Table T, typename TX, typename TD, "
                         r"bool HALO>\s*__global__ void "
                         rf"__launch_bounds__\(BLOCK\)\s*{kernel}", spcp)
    assert "dual_spec_body<T" in spcp and "primal_spec_body<T" in spcp
    assert "_voxel" not in re.sub(r"//[^\n]*", "", spcp)
    voxel = _source("voxel.cuh")
    assert "template <bool ZREG, typename TX, typename TD>" in voxel
    assert "const TD* yN" not in voxel and "v.yn" not in voxel


def test_the_interior_partials_are_b8s_slots():
    """The interior launches count and fill the array B8 finishes: one slot
    per BLOCK voxels of a plane (stencil.cuh's num_parts), each kernel's
    block sum through specialised.cuh's slot_parts, as B8's edge_parts."""
    spcp = _source("specialised_cp.cu")
    assert _body(spcp, "long long spcp_interior_num_parts").strip(
        ).endswith("return num_parts(Nz, M, Nr, Nc);")
    assert re.findall(r"long long (\w+)\(", spcp) == [
        "spcp_num_parts", "spcp_interior_num_parts"]
    assert _body(spcp, "long long spcp_num_parts").strip().endswith(
        "return dual_num_parts<VEC>(Nz, M, Nr, Nc);")
    bnd = _source("cp_boundary.cu")
    assert _body(bnd, "long long bnd_num_parts").strip().endswith(
        "return num_parts(Nz, M, Nr, Nc);")
    assert "slot_parts(p, e.z * p.M + e.t, s, parts);" in bnd
    assert spcp.count("slot_parts(p, zt, ") == 2
    assert "constexpr int VEC = 2;" in spcp
    assert "constexpr int VEC_BND = 2;" in bnd


def _mirror_slot_parts(row, block_sums):
    """specialised.cuh's slot_parts for one (z, t) plane: block b writes its
    sum to slot b and zeros to slots b + j blocks (j >= 1) inside the row;
    returns how often each slot was written."""
    slots, blocks = len(row), len(block_sums)
    writes = np.zeros(slots, int)
    for b in range(blocks):
        row[b] = block_sums[b]
        writes[b] += 1
        for j in range(b + blocks, slots, blocks):
            row[j] = 0.0
            writes[j] += 1
    return writes


@pytest.mark.parametrize("shape", [
    (3, 2, 4, 6), (5, 1, 16, 128), (8, 8, 256, 256), (4, 3, 17, 31),
    (3, 2, 1, 3), (3, 1, 9, 513)])
def test_interior_and_edge_planes_fill_each_slot_once(shape):
    """The interior launches (planes 1 .. Nz-2) and B8 (planes 0, Nz-1),
    each two columns a thread, write every slot of the (Nz, M slots) array
    once, and each plane's slots sum to its voxels' terms (integers: no
    rounding)."""
    Nz, M, Nr, Nc = shape
    slots, blocks = _slots(Nr, Nc)
    assert blocks <= slots <= 2 * blocks
    assert Nz * M * slots == _count("spcp_dual_interior_launch", shape)
    rng = np.random.default_rng(sum(shape))
    parts = np.full((Nz, M * slots), np.nan)
    cpr = -(-Nc // VEC)
    for z, t in itertools.product(range(Nz), range(M)):
        terms = rng.integers(0, 100, (Nr, Nc))
        padded = np.zeros((Nr, cpr * VEC), int)
        padded[:, :Nc] = terms
        run_sums = padded.reshape(Nr, cpr, VEC).sum(-1).ravel()
        block_sums = np.add.reduceat(run_sums, range(0, Nr * cpr, BLOCK))
        assert len(block_sums) == blocks
        row = parts[z, t * slots:(t + 1) * slots]
        assert (_mirror_slot_parts(row, block_sums) == 1).all()
        assert row.sum() == terms.sum()
    assert not np.isnan(parts).any()
