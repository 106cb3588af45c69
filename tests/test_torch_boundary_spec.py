"""The boundary kernels B8 of the overlapped z-sharded CP step, specialised
per channel table in ``csrc/cp_boundary.cu`` (no nvcc or GPU needed): every
configuration the overlapped path takes maps to a table the source
instantiates, and that list is the source's own; a table outside it raises;
the wrappers hand the library the table id and the storage flags and count
their launches (``_launch`` recorded, with CPU tensors); the checks are
remembered per kind of call and still raise on every bad one; and a Python
mirror of the kernels' partials mapping fills the edge rows of the interior
launch's array, each slot once, with the planes' sums unchanged."""

import itertools
import math
import os
import re

import numpy as np
import pytest
import torch

from pytv4d_tpu_torch.core.config import TVConfig
from pytv4d_tpu_torch.core.schemes import SCHEMES, AXIS_Z, scheme_channels
from pytv4d_tpu_torch.kernels import build, fused, tables
from pytv4d_tpu_torch.parallel import make_mesh, make_sharded_cp_solver_fused
from pytv4d_tpu_torch.utils import profiling

BLOCK, VEC_BND = 256, 2  # csrc/stencil.cuh, csrc/cp_boundary.cu
LAUNCHES = ("cp_dual_boundary_launch", "cp_primal_boundary_launch")


def _source():
    with open(os.path.join(build.CSRC, "cp_boundary.cu")) as f:
        return f.read()


def _source_tables():
    """The ids of ``csrc/tables.cuh``'s ``TABLES_WITH_Z`` X-list, which the
    source instantiates, in its order."""
    with open(os.path.join(build.CSRC, "tables.cuh")) as f:
        text = f.read().replace("\\\n", " ")
    body = re.search(r"#define TABLES_WITH_Z\(X\)(.*)", text).group(1)
    return tuple(int(i) for i in re.findall(r"X\((\d+)\)", body))


def _overlapped_configs():
    """(cfg, (Nz, M)) of every configuration whose solver on a 2-z-shard
    mesh takes the overlapped step: four schemes x reg_z in {0, 1, nan} x
    reg_time in {0, 0.5} x Nz in {6, 8, 12} x M in {1, 2, 3}, those with a
    z channel."""
    mesh = make_mesh(2, device="cpu")
    out = []
    for scheme, reg_z, reg_time, Nz, M in itertools.product(
            SCHEMES, (0.0, 1.0, math.nan), (0.0, 0.5), (6, 8, 12), (1, 2, 3)):
        cfg = TVConfig(scheme=scheme, reg_z_over_reg=reg_z, reg_time=reg_time)
        chans, _ = scheme_channels(scheme, Nz, M, reg_z, reg_time)
        solve = make_sharded_cp_solver_fused(
            mesh, cfg, (Nz, M, 4, 8), reg=1.0, n_iter=1, shard_time=False)
        assert solve.overlap == any(ch.axis == AXIS_Z for ch in chans)
        if solve.overlap:
            out.append((cfg, (Nz, M)))
    return out


def test_every_overlapped_configuration_has_a_boundary_kernel():
    configs = _overlapped_configs()
    assert len(configs) == 4 * 2 * 3 * 3  # reg_z = 1 only
    reached = {tables.boundary_table_id(cfg, *dims) for cfg, dims in configs}
    assert reached == set(tables.BOUNDARY_TABLES)
    for cfg, dims in configs:
        tid = tables.boundary_table_id(cfg, *dims)
        assert tid == tables.table_id(cfg, *dims)
        assert any(axis == AXIS_Z for axis, _ in tables.TABLES[tid])


def test_the_list_is_the_sources():
    """Python's list is the source's X-list, and each C entry point switches
    over that list and fails any other id."""
    assert _source_tables() == tables.BOUNDARY_TABLES
    text = _source()
    for launch in LAUNCHES:
        assert launch in fused._ENTRY_POINTS["cp_boundary"][2]
        body = re.search(rf"int {launch}\((.*?)\n}}", text, re.S).group(1)
        assert re.search(r"switch \(id\)", body)
        assert "TABLES_WITH_Z(BND_CASE)" in body
        assert body.rstrip().endswith("return (int)cudaErrorInvalidValue;")
    # no generic body is left: the kernels take the table as a template
    # argument and run specialised.cuh's bodies
    code = re.sub(r"//[^\n]*", "", text)
    assert "_voxel" not in code and "Table T" in code
    assert "dual_spec_body<T" in code and "primal_spec_body<T" in code
    assert '#include "specialised.cuh"' in text


@pytest.mark.parametrize("cfg, dims", [
    (TVConfig(scheme="hybrid", reg_z_over_reg=0.0, reg_time=0.5), (8, 3)),
    (TVConfig(scheme="upwind", reg_z_over_reg=math.nan), (8, 1)),
    (TVConfig(scheme="central", reg_time=0.5), (2, 3)),   # FWD z: table 17
    (TVConfig(scheme="central"), (2, 1)),                 # table 16
])
def test_a_table_outside_the_list_raises(cfg, dims):
    with pytest.raises(ValueError, match="no boundary kernel"):
        tables.boundary_table_id(cfg, *dims)


def _operands(x_dtype, d_dtype, cfg, shape=(3, 2, 4, 6), table_dims=(6, 2)):
    Nd = len(scheme_channels(cfg.scheme, *table_dims, cfg.reg_z_over_reg,
                             cfg.reg_time)[0])
    Nz, M, Nr, Nc = shape
    x, x0, y_A = (torch.zeros(shape, dtype=x_dtype) for _ in range(3))
    y_D = torch.zeros((Nz, M, Nd, Nr, Nc), dtype=d_dtype)
    x_halo = torch.zeros((2, M, Nr, Nc), dtype=x_dtype)
    y_halo = torch.zeros((2, M, Nd, Nr, Nc), dtype=d_dtype)
    parts = torch.zeros((Nz, 1))
    return x, x_halo, x0, y_A, y_D, y_halo, parts


@pytest.mark.parametrize("x_dtype, d_dtype", [
    (torch.float32, torch.float32), (torch.float32, torch.bfloat16),
    (torch.bfloat16, torch.float32), (torch.bfloat16, torch.bfloat16)])
def test_wrappers_pass_table_and_storage(monkeypatch, x_dtype, d_dtype):
    """What the two launches hand their library: the table of the whole
    volume's (Nz, M) first, then the storage flags, the operands in the C
    entry point's order, no partials of their own (they fill the interior
    launch's); each counts its launch."""
    seen = []
    monkeypatch.setattr(fused, "_launch",
                        lambda *a, **k: seen.append((a, k)))
    profiling.clear_counters()
    cfg = TVConfig(scheme="central", reg_time=0.5)
    tmul = torch.ones((4, 6))
    x, x_halo, x0, y_A, y_D, y_halo, parts = _operands(x_dtype, d_dtype, cfg)
    got = fused._dual_boundary_kernel(
        x, x_halo, x0, y_A, y_D, parts, tmul, cfg=cfg, sigma_D=0.5,
        sigma_A=1.0, reg=1.0, fidelity="l2", fid_weight=1.0,
        table_dims=(6, 2))
    assert got[0] is y_A and got[1] is y_D and got[2] is parts
    got = fused._primal_boundary_kernel(
        x, x0, y_A, y_D, y_halo, parts, None, cfg=cfg, tau=0.1,
        fidelity="kl", fid_weight=0.5, nonneg=True, table_dims=(6, 2))
    assert got[0] is x and got[1] is parts
    tid = tables.table_id(cfg, 6, 2)
    assert tid == 20 and tid in tables.BOUNDARY_TABLES  # (ZC, TF)
    flags = (tid, int(x_dtype == torch.bfloat16),
             int(d_dtype == torch.bfloat16))
    (a1, k1), (a2, k2) = seen
    assert a1[:2] == ("cp_boundary", "cp_dual_boundary_launch")
    assert a1[2] is x and a1[4] == flags and k1 == {}
    assert [t is u for t, u in zip(a1[5], (x, x_halo, x0, y_A, y_D, tmul,
                                           parts))] == [True] * 7
    assert a2[:2] == ("cp_boundary", "cp_primal_boundary_launch")
    assert a2[4] == flags and k2 == {} and len(a2) == 6
    assert a2[5][:5] == (x, x0, y_A, y_D, y_halo)
    assert a2[5][5] is None and a2[5][6] is parts
    # the parameters: the shard's shape, the whole volume's table, z ungated
    for (a, _), has_tmul in ((seen[0], 1), (seen[1], 0)):
        p = a[3]
        assert (p.Nz, p.M, p.Nr, p.Nc, p.Nd) == (3, 2, 4, 6, 4)
        assert (p.sharded, p.t_free, p.has_tmul) == (1, 0, has_tmul)
    assert seen[1][0][3].nonneg == 1 and seen[1][0][3].fidelity == 2
    assert profiling.counters() == {"launch.B8.dual": 1,
                                    "launch.B8.primal": 1}


def test_an_unlisted_table_launches_nothing(monkeypatch):
    seen = []
    monkeypatch.setattr(fused, "_launch", lambda *a, **k: seen.append(a))
    profiling.clear_counters()
    cfg = TVConfig(scheme="hybrid", reg_z_over_reg=0.0, reg_time=0.5)
    x, x_halo, x0, y_A, y_D, _, parts = _operands(torch.float32,
                                                  torch.float32, cfg)
    with pytest.raises(ValueError, match="no boundary kernel"):
        fused._dual_boundary_kernel(
            x, x_halo, x0, y_A, y_D, parts, None, cfg=cfg, sigma_D=0.5,
            sigma_A=1.0, reg=1.0, fidelity="l2", fid_weight=1.0,
            table_dims=(6, 2))
    assert seen == [] and profiling.counters() == {}


def test_checks_are_remembered_per_kind_of_call(monkeypatch):
    """A call whose operands match one that passed skips the checks; any
    operand that differs in type, shape, dtype, device or contiguity, or
    another configuration, runs them again and raises as before."""
    cfg = TVConfig(scheme="hybrid", reg_time=0.5)
    x, x_halo, x0, y_A, y_D, _, parts = _operands(torch.float32,
                                                  torch.float32, cfg)
    monkeypatch.setattr(fused, "_BOUNDARY_PASSED", set())
    args = (x, x_halo, x0, y_A, y_D, parts, None, cfg, (6, 2), "x_halo")
    fused._check_boundary(*args)
    assert len(fused._BOUNDARY_PASSED) == 1
    calls = []
    real = fused._check_operands
    monkeypatch.setattr(fused, "_check_operands",
                        lambda *a, **k: calls.append(a) or real(*a, **k))
    fused._check_boundary(x.clone(), x_halo.clone(), *args[2:])
    assert calls == []  # new tensors of the same kind: remembered
    bad = [
        ("x_halo must be", dict(halo=x_halo.to(torch.bfloat16))),
        ("x_halo must be", dict(halo=torch.zeros((2, 2, 4, 7)))),
        ("parts must be", dict(parts=torch.zeros(3))),
        ("parts must be", dict(parts=torch.zeros((3, 1), dtype=torch.float64))),
        ("must be contiguous", dict(x=torch.zeros((3, 2, 6, 4)).transpose(
            2, 3))),
        ("must match x", dict(y_A=torch.zeros((3, 2, 4, 6),
                                              dtype=torch.float64))),
        ("y_D must be", dict(y_D=torch.zeros((3, 2, 3, 4, 6)))),
        ("must be a torch.Tensor", dict(x0=np.zeros((3, 2, 4, 6),
                                                    np.float32))),
        ("tmul must be", dict(tmul=torch.ones((4, 5)))),
    ]
    names = ("x", "halo", "x0", "y_A", "y_D", "parts", "tmul")
    for match, change in bad:
        call = dict(zip(names, args[:7]), **change)
        with pytest.raises((ValueError, TypeError), match=match):
            fused._check_boundary(*(call[n] for n in names), *args[7:])
    # another configuration: its own Nd, so y_D no longer fits
    with pytest.raises(ValueError, match="y_D must be"):
        fused._check_boundary(*args[:7], TVConfig(scheme="upwind",
                                                  reg_time=0.5), *args[8:])
    assert len(fused._BOUNDARY_PASSED) == 1


def _edge_slots(Nr, Nc):
    """The slots per plane of the interior launch, and the boundary
    kernels' blocks per plane (csrc/stencil.cuh num_parts,
    specialised.cuh dual_blocks)."""
    slots = -(-Nr * Nc // BLOCK)
    blocks = -(-Nr * -(-Nc // VEC_BND) // BLOCK)
    return slots, blocks


def _mirror_edge_parts(row, block_sums):
    """csrc/cp_boundary.cu's edge_parts for one (z, t) plane: block b writes
    its sum to slot b and zeros to slots b + j blocks (j >= 1) inside the
    plane's slots; returns how often each slot was written."""
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
    (3, 2, 4, 6), (3, 1, 16, 128), (8, 8, 256, 256), (4, 3, 17, 31),
    (3, 2, 24, 71), (5, 1, 1, 1), (3, 2, 1, 3), (3, 1, 9, 513),
    (3, 2, 2, 257)])
def test_edge_parts_fill_each_slot_once(shape):
    """Rows 0 and Nz-1 of the interior launch's (Nz, M slots) array: each
    slot written once, the planes' sums those of their voxels (integers:
    no rounding), the other rows untouched."""
    Nz, M, Nr, Nc = shape
    slots, blocks = _edge_slots(Nr, Nc)
    assert blocks <= slots <= 2 * blocks
    rng = np.random.default_rng(sum(shape))
    parts = np.full((Nz, M * slots), np.nan)
    for z, t in itertools.product((0, Nz - 1), range(M)):
        terms = rng.integers(0, 100, (Nr, Nc))
        # thread k of the plane's launch takes the run of VEC_BND columns
        # of row k // cpr from column VEC_BND (k % cpr)
        cpr = -(-Nc // VEC_BND)
        padded = np.zeros((Nr, cpr * VEC_BND), int)
        padded[:, :Nc] = terms
        run_sums = padded.reshape(Nr, cpr, VEC_BND).sum(-1).ravel()
        block_sums = np.add.reduceat(run_sums, range(0, Nr * cpr, BLOCK))
        assert len(block_sums) == blocks
        row = parts[z, t * slots:(t + 1) * slots]
        writes = _mirror_edge_parts(row, block_sums)
        assert (writes == 1).all()
        assert row.sum() == terms.sum()
    assert not np.isnan(parts[[0, -1]]).any()
    assert np.isnan(parts[1:-1]).all()
