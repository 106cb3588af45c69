"""The subgradient-descent step in pass 2's epilogue (no nvcc or GPU needed).

On a tensor that the fused kernels take, ``subgradient_descent`` steps by
``solvers.gd.fused_step``: B3 (``fused.tv_norms``), then ``fused.tv_gd_step``,
which on the card launches ``spec_tv_gd_launch`` of
``csrc/specialised.cu`` (the GD instance of ``tv_subgrad_spec_kernel``:
x' and the fidelity partials written, G never stored) and on the CPU runs
its plain version, ``tv_subgrad_plain``'s G and then the solver's eager
update.  Here: the fused path's x and histories against the eager update
on the standalone pass 2 (to the bit) and against ``fused=False``; the
launch's table, flags, operands and Params for every table with
``_launch`` recording; ``launch.B4_gd`` over whole solves, the launches
emulated by the plain versions in the C entry point's operand order; and
the C source's partial count, read as text."""

import itertools
import os
import re

import numpy as np
import pytest
import torch

from pytv4d_tpu_torch.core.config import TVConfig
from pytv4d_tpu_torch.core.schemes import SCHEMES
from pytv4d_tpu_torch.kernels import build, fused, tables
from pytv4d_tpu_torch.ops.space import TENSOR
from pytv4d_tpu_torch.parallel import make_mesh, shard_volume
from pytv4d_tpu_torch.solvers import gd
from pytv4d_tpu_torch.utils import profiling

SHAPE = (4, 3, 16, 40)
REG, STEP = 0.3, 1e-2
VARIANTS = {
    "iso": dict(scheme="hybrid", reg_time=0.5),
    "aniso": dict(scheme="central", reg_time=0.5, norm="aniso"),
    "huber": dict(scheme="upwind", reg_time=0.5, norm="huber",
                  huber_delta=0.3),
    "tmul": dict(scheme="hybrid", reg_time=0.7, factor_reg_static=0.3),
}
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _source(name):
    with open(os.path.join(build.CSRC, name)) as f:
        return f.read()


def _const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);",
                         _source("specialised.cu"))[1])


def _count(shape):
    """A Python mirror of ``spec_tv_gd_num_parts``: one partial per block,
    a block a TILE_R x TILE_C tile of a (z, t) plane."""
    block = int(re.search(r"#define BLOCK (\d+)", _source("stencil.cuh"))[1])
    tile_c = _const("TILE_C")
    tile_r = block // tile_c * _const("RPT")
    Nz, M, Nr, Nc = shape
    return Nz * M * -(-Nr // tile_r) * -(-Nc // tile_c)


def _volume(dtype, seed=0, shape=SHAPE):
    rng = np.random.default_rng(seed)
    return torch.tensor(rng.random(shape), dtype=torch.float32).to(dtype)


def _planes(shape=SHAPE):
    rng = np.random.default_rng(5)
    mask = rng.random((1, 1) + shape[2:]) < 0.5
    wt = (0.5 + rng.random((1, 1) + shape[2:])).astype(np.float32)
    return dict(mask_static=mask, weight_time=torch.tensor(wt))


def _solve_kw(variant):
    kw = dict(n_iter=6, reg=REG, step_size=STEP,
              cfg=TVConfig(**VARIANTS[variant]))
    if variant == "tmul":
        kw.update(_planes())
    return kw


def _tmul(cfg, kw, x):
    from pytv4d_tpu_torch.kernels.dispatch import t_plane_multiplier

    tm = t_plane_multiplier(tuple(x.shape), cfg, kw.get("mask_static"),
                            kw.get("weight_time"), dtype=x.dtype,
                            device=x.device)
    return None if tm is None else tm.float().contiguous()


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_the_fused_path_is_the_eager_update_on_the_standalone_pass(
        variant, dtype):
    """x, loss and TV histories of the fused CPU path equal, to the bit,
    the loop that steps by the eager update on the standalone pass 2
    (``tv_and_subgrad_fused``): the path as it ran before pass 2 took the
    step."""
    x0 = _volume(DTYPES[dtype])
    kw = _solve_kw(variant)
    cfg = kw["cfg"]
    got = gd.subgradient_descent(x0, **kw)
    tm = _tmul(cfg, kw, x0)
    step = gd.eager_step(
        TENSOR, lambda v: fused.tv_and_subgrad_fused(v, cfg, tmul=tm), x0,
        REG, STEP)
    x, losses, tvs = gd.gd_loop(TENSOR, step, x0, n_iter=kw["n_iter"],
                                hist_dtype=torch.float32)
    assert got.x.dtype == x0.dtype
    assert torch.equal(got.x, x)
    assert torch.equal(got.loss, losses) and torch.equal(got.tv, tvs)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_the_fused_path_equals_the_plain_solver_in_float32(variant):
    """float32: the fused CPU path's x equals ``fused=False``'s to the bit
    (the plain B3 / B4 and ``ops.tv.tv_and_subgrad`` give one G), except
    with a time multiplier plane, which the two apply in another order: x
    there, and the loss and TV histories everywhere, at the JAX package's
    fused-vs-jnp GD bar (``tests/test_torch_gd.py``)."""
    x0 = _volume(torch.float32)
    kw = _solve_kw(variant)
    got = gd.subgradient_descent(x0, **kw)
    want = gd.subgradient_descent(x0, fused=False, **kw)
    if variant == "tmul":
        np.testing.assert_allclose(got.x.numpy(), want.x.numpy(), atol=1e-5,
                                   rtol=1e-4)
    else:
        assert torch.equal(got.x, want.x)
    np.testing.assert_allclose(got.loss.numpy(), want.loss.numpy(),
                               rtol=1e-4)
    np.testing.assert_allclose(got.tv.numpy(), want.tv.numpy(), rtol=1e-4)


@pytest.mark.parametrize("same", [False, True], ids=["x0", "x0 is x"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_tv_gd_step_on_the_cpu_is_the_eager_update(variant, dtype, same):
    """``tv_gd_step`` on CPU tensors: x' is the eager update on
    ``tv_subgrad``'s G to the bit, a new tensor (x untouched, also where x0
    is x, the first step), and the fidelity partials sum to ``0.5
    sum((x' - x0)^2)``."""
    x = _volume(DTYPES[dtype])
    x0 = x if same else _volume(DTYPES[dtype], seed=1)
    kw = _solve_kw(variant)
    cfg = kw["cfg"]
    tm = _tmul(cfg, kw, x)
    before = x.clone()
    norms, _ = fused.tv_norms(x, tm, cfg=cfg)
    G = fused.tv_subgrad(x, norms, tm, cfg=cfg)
    want = x - STEP * ((x - x0) + REG * G)
    got, parts = fused.tv_gd_step(x, x0, norms, tm, cfg=cfg, reg=REG,
                                  step_size=STEP)
    assert got is not x and torch.equal(x, before)
    assert got.dtype == x.dtype and torch.equal(got, want)
    assert parts.dtype == torch.float32
    fid = 0.5 * torch.sum(torch.square(want - x0))
    assert float(parts.sum()) == float(fid)


def test_tv_gd_step_checks_its_operands():
    cfg = TVConfig(**VARIANTS["iso"])
    x = _volume(torch.float32)
    norms, _ = fused.tv_norms(x, cfg=cfg)
    kw = dict(cfg=cfg, reg=REG, step_size=STEP)
    with pytest.raises(ValueError, match="x0 must match x"):
        fused.tv_gd_step(x, x.to(torch.bfloat16), norms, **kw)
    with pytest.raises(ValueError, match="norms must be float32"):
        fused.tv_gd_step(x, x, norms.double(), **kw)
    with pytest.raises(ValueError, match="norms must be float32"):
        fused.tv_gd_step(x, x, norms[:2].contiguous(), **kw)
    with pytest.raises(ValueError, match="tmul"):
        fused.tv_gd_step(x, x, norms, torch.ones(3, 3), **kw)
    with pytest.raises(ValueError, match="contiguous"):
        fused.tv_gd_step(x, x.transpose(2, 3), norms, **kw)


@pytest.fixture
def launches(monkeypatch):
    """The ``_launch`` calls the wrappers make, recorded instead of run
    (partials: zeros of the mirrored count), and the counters from 0."""
    seen = []

    def record(name, fn_name, x, p, flags, args, with_parts=False,
               shape=None):
        seen.append(dict(lib=name, fn=fn_name, p=p, flags=flags, args=args,
                         with_parts=with_parts))
        return torch.zeros(_count(shape or tuple(x.shape)))

    monkeypatch.setattr(fused, "_launch", record)
    profiling.clear_counters()
    return seen


def _config_of(tid):
    """A (cfg, (Nz, M)) whose scheme has table ``tid`` at (Nz, M)."""
    return next(
        (TVConfig(scheme=s, reg_z_over_reg=z, reg_time=t), (Nz, M))
        for s, z, t, Nz, M in itertools.product(
            SCHEMES, (0.0, 1.0), (0.0, 0.5), (1, 2, 3), (1, 2, 3))
        if tables.table_id(TVConfig(scheme=s, reg_z_over_reg=z,
                                    reg_time=t), Nz, M) == tid)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("tid", range(len(tables.TABLES)))
def test_each_table_reaches_the_gd_launch(launches, tid, dtype):
    """Every one of the 21 tables, in both storages, is handed to
    ``spec_tv_gd_launch`` as its id and flag, with the operands in the C
    entry point's order (x, x0, norms, tmul, x'), x' a new tensor, the
    partials asked for, and Params of an unsharded volume that carry the
    step (``tau``), the weight of G (``reg``) and ``fid_scale`` 0.5, while
    the cached Params of the other passes keep theirs.  One launch counts
    under ``launch.B4`` and ``launch.B4_gd``."""
    cfg, dims = _config_of(tid)
    shape = dims + (20, 37)
    x = torch.zeros(shape, dtype=DTYPES[dtype])
    x0, norms = torch.zeros_like(x), torch.ones(shape)
    out, parts = fused._tv_gd_kernel(x, x0, norms, cfg=cfg, reg=REG,
                                     step_size=STEP)
    (call,) = launches
    assert (call["lib"], call["fn"], call["flags"]) == (
        "specialised", "spec_tv_gd_launch", (tid, int(dtype == "bf16")))
    assert call["with_parts"]
    assert call["args"][:4] == (x, x0, norms, None)
    assert call["args"][4] is out and out is not x
    assert out.shape == x.shape and out.dtype == x.dtype
    assert parts.shape == (_count(shape),)
    p = call["p"]
    assert (p.Nz, p.M, p.Nr, p.Nc) == shape
    assert (p.sharded, p.t_free, p.has_tmul) == (0, 0, 0)
    f32 = np.float32
    assert (f32(p.tau), f32(p.reg), p.fid_scale) == (f32(STEP), f32(REG),
                                                     0.5)
    base = fused._params(cfg, shape, False)
    assert (base.tau, base.reg) == (f32(0.1), 1.0)
    assert profiling.counters() == {"launch.B4": 1, "launch.B4_gd": 1}


def test_the_gd_launch_and_its_count_are_in_the_source():
    """``spec_tv_gd_launch`` switches over every table, refuses a shard's
    Params and an x' that is x before it does, and launches the GD
    instance of ``tv_subgrad_spec_kernel``; ``spec_tv_gd_num_parts``
    counts its blocks as the launch shapes its grid."""
    text = _source("specialised.cu")
    body = re.search(r"int spec_tv_gd_launch\((.*?)\n}", text, re.S).group(1)
    assert (body.index("if (p->sharded || out == x)")
            < body.index("switch (id)"))
    assert "tv_subgrad_spec_table<code, false, true>" in body
    count = re.search(r"long long spec_tv_gd_num_parts\((.*?)\n}", text,
                      re.S).group(1)
    assert "subgrad_tiles(Nr, Nc) * Nz * M" in count
    launch = re.search(r"static int tv_subgrad_spec_launch\((.*?)\n}", text,
                       re.S).group(1)
    assert "subgrad_tiles(p->Nr, p->Nc)" in launch
    assert fused._num_parts_name(
        type("L", (), {"spec_tv_gd_num_parts": 0})(), "spec",
        "spec_tv_gd_launch") == "spec_tv_gd_num_parts"


def _emulate(cfg):
    """A ``_launch`` that runs B3 and the GD instance of pass 2 by their
    plain versions on the operands in the C entry points' order, writing
    what the kernel writes, and returns the partials."""
    def launch(name, fn_name, x, p, flags, args, with_parts=False,
               shape=None):
        if fn_name == "spectv_norms_launch":
            xin, tm, norms = args
            n, parts = fused.tv_norms_plain(xin, tm, cfg=cfg)
            norms.copy_(n)
            return parts
        assert fn_name == "spec_tv_gd_launch", fn_name
        xin, x0, norms, tm, out = args
        xn, parts = fused.tv_gd_step_plain(xin, x0, norms, tm, cfg=cfg,
                                           reg=p.reg, step_size=p.tau)
        out.copy_(xn)
        return parts

    return launch


@pytest.mark.parametrize("path", ["fused", "fused=False", "grid"])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_b4_gd_counts_the_fused_steps(monkeypatch, variant, path):
    """``launch.B4_gd`` counts n_iter on the fused tensor path, with B3 and
    B4 as often, and 0 with ``fused=False`` and on a grid (their eager
    update).  The wrappers take their CUDA branch (``_tv_norms_kernel``,
    ``_tv_gd_kernel``) with the launches emulated by the plain versions,
    and the emulated solve's x equals the plain one's to the bit: the
    operands reach the launch in the C entry point's order."""
    kw = _solve_kw(variant)
    cfg = kw["cfg"]
    x0 = _volume(torch.float32)
    want = gd.subgradient_descent(x0, **kw)
    monkeypatch.setattr(fused, "_launch", _emulate(cfg))
    monkeypatch.setattr(fused, "tv_norms",
                        lambda x, tmul=None, *, cfg: fused._tv_norms_kernel(
                            x, tmul, cfg=cfg))

    def gd_step(x, x0, norms, tmul=None, *, cfg, reg, step_size):
        norms = None if cfg.norm == "aniso" else norms
        return fused._tv_gd_kernel(x, x0, norms, tmul, cfg=cfg, reg=reg,
                                   step_size=step_size)

    monkeypatch.setattr(fused, "tv_gd_step", gd_step)
    profiling.clear_counters()
    n = kw["n_iter"]
    if path == "grid":
        got = gd.subgradient_descent(
            shard_volume(x0, make_mesh(z=2, device="cpu")), **kw)
        assert profiling.counters()["launch.B4_gd"] == 0
        return
    got = gd.subgradient_descent(x0, fused=path == "fused", **kw)
    if path == "fused=False":
        assert profiling.counters() == {}
        return
    assert profiling.counters() == {"launch.B3": n, "launch.B4": n,
                                    "launch.B4_gd": n}
    assert torch.equal(got.x, want.x)
    assert torch.equal(got.loss, want.loss) and torch.equal(got.tv, want.tv)
