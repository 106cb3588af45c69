"""CP pass B (B2) on an unsharded volume, per channel table (no nvcc or GPU
needed).

On a volume ``fused.cp_primal`` launches ``spec_cp_primal_launch`` of
``csrc/specialised.cu``: the kernel ``cp_primal_spec_kernel`` of the
volume's channel table and storage pair, in place or into ``out``.  Each
routing case calls the launch function (``_cp_primal_kernel``) on CPU
tensors with ``_launch`` recording, so no kernel runs; the C source is
read as text.  The plain version, which the wrapper takes on the CPU, is
held to the JAX package's pass B: its Pallas kernel in the interpreter
(after its own pass A, float32, at the JAX fused-vs-jnp bar ``atol=2e-6,
rtol=1e-5``), and its operators in float64 (the plain version computes in
float32 as the kernel does, so at the same bar)."""

import ctypes
import itertools
import os
import re
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytv4d_tpu.core.config import TVConfig as JConfig
from pytv4d_tpu.kernels import fused as jfused
from pytv4d_tpu.ops.operators import D_T as jD_T
from pytv4d_tpu.solvers.fidelity import fidelity_loss as jfidelity_loss
from pytv4d_tpu_torch.core.config import TVConfig
from pytv4d_tpu_torch.core.schemes import SCHEMES, scheme_channels
from pytv4d_tpu_torch.kernels import build, fused, tables
from pytv4d_tpu_torch.utils import profiling

TOL = dict(atol=2e-6, rtol=1e-5)  # the JAX package's fused-vs-jnp bar (CP)
BLOCK = 256                       # csrc/stencil.cuh
STORAGE = [(torch.float32, torch.float32), (torch.float32, torch.bfloat16),
           (torch.bfloat16, torch.float32), (torch.bfloat16, torch.bfloat16)]


def _source(name):
    with open(os.path.join(build.CSRC, name)) as f:
        return f.read()


def _body(text, fn):
    return re.search(rf"\b{fn}\((.*?)\n}}", text, re.S).group(1)


# the unsharded pass B's columns a run (csrc/specialised.cu)
VEC_B = int(re.search(r"constexpr int VEC_B = (\d+);",
                      _source("specialised.cu"))[1])


def _count(shape):
    """A Python mirror of ``spec_cp_primal_num_parts``: one partial per
    block of BLOCK runs of VEC_B columns, per (z, t) plane."""
    Nz, M, Nr, Nc = shape
    return Nz * M * -(-Nr * -(-Nc // VEC_B) // BLOCK)


@pytest.fixture
def launches(monkeypatch):
    """The ``_launch`` calls the wrappers make, recorded instead of run
    (partials: zeros of the mirrored count), and pass B's counters from 0."""
    seen = []

    def record(name, fn_name, x, p, flags, args, with_parts=False,
               shape=None):
        seen.append(dict(lib=name, fn=fn_name, x=x, p=p, flags=flags,
                         args=args, with_parts=with_parts))
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


@pytest.mark.parametrize("x_dtype, d_dtype", STORAGE)
@pytest.mark.parametrize("tid", range(len(tables.TABLES)))
def test_each_table_and_pair_reaches_the_new_launch(launches, tid, x_dtype,
                                                    d_dtype):
    """Every one of the 21 tables, in each of the four storage pairs, is
    handed to ``spec_cp_primal_launch`` as its id and flags, with Params of
    an unsharded volume (gates on: the C entry point refuses a shard's)."""
    cfg, dims = _config_of(tid)
    Nd = len(scheme_channels(cfg.scheme, *dims, cfg.reg_z_over_reg,
                             cfg.reg_time)[0])
    shape = dims + (4, 10)
    x = torch.zeros(shape, dtype=x_dtype)
    yd = torch.zeros(dims + (Nd,) + shape[2:], dtype=d_dtype)
    out, parts = fused._cp_primal_kernel(x, x, x, yd, out=x, cfg=cfg,
                                         tau=0.1)
    (call,) = launches
    assert (call["lib"], call["fn"], call["flags"]) == (
        "specialised", "spec_cp_primal_launch",
        (tid, int(x_dtype == torch.bfloat16), int(d_dtype == torch.bfloat16)))
    assert call["with_parts"] and call["args"] == (x, x, x, yd, None, x)
    p = call["p"]
    assert (p.Nz, p.M, p.Nr, p.Nc, p.Nd) == (*shape, Nd)
    assert (p.sharded, p.t_free, p.xe, p.ye) == (0, 0, 0, 0)
    assert out is x and parts.shape == (_count(shape),)
    assert profiling.counters() == {
        "launch.B2": 1, "launch.B2/spec_cp_primal_launch": 1}


@pytest.mark.parametrize("in_place", [True, False])
def test_an_unsharded_call_launches_the_volumes_table(launches, in_place):
    """In place (the denoising step: ``out`` is x) and out of place (the
    inverse solver: x itself in the x0 slot, x' into a second buffer), with
    a time multiplier plane: the volume's table, its storage flags and the
    operands in the C entry point's order."""
    cfg = TVConfig(scheme="hybrid", reg_time=0.5)
    x = torch.zeros(3, 2, 4, 8, dtype=torch.bfloat16)
    Nd = len(scheme_channels("hybrid", 3, 2, 1.0, 0.5)[0])
    yd, tm = torch.zeros(3, 2, Nd, 4, 8), torch.ones(4, 8)
    out = x if in_place else torch.empty_like(x)
    x0 = torch.zeros_like(x) if in_place else x
    got, parts = fused._cp_primal_kernel(x, x0, x, yd, tm, out=out, cfg=cfg,
                                         tau=0.1, nonneg=True)
    (call,) = launches
    assert (call["lib"], call["fn"], call["flags"]) == (
        "specialised", "spec_cp_primal_launch",
        (tables.table_id(cfg, 3, 2), 1, 0))
    assert call["args"] == (x, x0, x, yd, tm, out)
    assert got is out and parts.shape == (_count(x.shape),)
    assert (call["p"].has_tmul, call["p"].nonneg, call["p"].sharded) == \
        (1, 1, 0)
    assert profiling.counters() == {
        "launch.B2": 1, "launch.B2/spec_cp_primal_launch": 1}


class _Defines:
    """A stand-in library that has exactly the functions named."""

    def __init__(self, names):
        for name in names:
            setattr(self, name, types.SimpleNamespace())


def test_num_parts_name_resolves_the_new_count():
    """Pass B's launch has its own count (its runs are VEC_B columns, pass
    A's VEC), which ``_num_parts_name`` finds before the library's; pass A
    keeps the library's."""
    defined = set(re.findall(r"long long (\w+_num_parts)\(",
                             _source("specialised.cu")))
    assert defined == {"spec_num_parts", "spec_cp_primal_num_parts",
                       "spec_tv_gd_num_parts"}
    lib = _Defines(defined)
    assert fused._num_parts_name(lib, "spec", "spec_cp_primal_launch") == \
        "spec_cp_primal_num_parts"
    assert fused._num_parts_name(lib, "spec", "spec_tv_gd_launch") == \
        "spec_tv_gd_num_parts"
    assert fused._num_parts_name(lib, "spec", "spec_cp_dual_launch") == \
        "spec_num_parts"
    assert _body(_source("specialised.cu"),
                 "long long spec_cp_primal_num_parts").strip().endswith(
        "return dual_num_parts<VEC_B>(Nz, M, Nr, Nc);")


def test_the_library_binds_the_new_launch_and_count(monkeypatch, request):
    """``_lib`` binds ``spec_cp_primal_launch`` (the Params, three int flags,
    seven pointers and the stream) and its count (four ints to a long long);
    ``_num_parts`` hands out that count.  A stand-in for the built library:
    nothing is compiled."""
    prefix, _, fns = fused._ENTRY_POINTS["specialised"]
    names = {*fns, f"{prefix}_error_string", "spec_num_parts",
             "spec_cp_primal_num_parts"}
    monkeypatch.setattr(build, "load", lambda name: _Defines(names))
    for cache in (fused._lib, fused._num_parts):
        cache.cache_clear()
        request.addfinalizer(cache.cache_clear)
    lib = fused._lib("specialised")
    launch = lib.spec_cp_primal_launch
    assert launch.argtypes == ([ctypes.POINTER(fused._Params)]
                               + [ctypes.c_int] * 3
                               + [ctypes.c_void_p] * 8)
    assert launch.restype is ctypes.c_int
    count = fused._num_parts("specialised", "spec_cp_primal_launch")
    assert count is lib.spec_cp_primal_num_parts
    assert count.argtypes == [ctypes.c_int] * 4
    assert count.restype is ctypes.c_longlong


def test_the_entry_point_switches_every_table_and_pair():
    """``spec_cp_primal_launch`` refuses a shard's Params before its switch,
    switches over the 21 tables of ``CHANNEL_TABLES`` (any other id fails)
    into ``cp_primal_spec_table``, which instantiates the kernel for the four
    storage pairs; the kernel runs ``primal_spec_body`` with both gates on
    and its dual z neighbours M planes of the dual away."""
    spec = _source("specialised.cu")
    body = _body(spec, "int spec_cp_primal_launch")
    assert body.index("if (p->sharded) return (int)cudaErrorInvalidValue;") \
        < body.index("switch (id)")
    assert "CHANNEL_TABLES(SPEC_CASE)" in body
    assert "cp_primal_spec_table<code>(p, x_bf16, d_bf16," in body
    assert body.rstrip().endswith("return (int)cudaErrorInvalidValue;")
    table = _body(spec, "static int cp_primal_spec_table")
    assert re.findall(r"cp_primal_spec_launch<T, (\w+), (\w+)>", table) == [
        ("float", "float"), ("float", "B"), ("B", "float"), ("B", "B")]
    kernel = _body(spec, "cp_primal_spec_kernel")
    assert "zs = p.M * dplane;" in kernel
    assert ("p, z, t, z, p.Nz, t, p.M, x, x0, yA, yz, yz - zs, yz + zs, "
            "tmul, out,") in re.sub(r"\s+", " ", kernel)
    ids = re.findall(r"X\((\d+),", _source("tables.cuh"))
    assert sorted(map(int, ids)) == list(range(len(tables.TABLES)))
    # the unsharded launch's alignment rule is the sharded passes' one
    launch = _body(spec, "static int cp_primal_spec_launch")
    assert "runs_aligned<VEC_B, TX, TD>(p, x, x0, yA, yD, out, tmul)" in \
        launch
    assert "dual_grid<VEC_B>(p);" in launch


# (id, config, step options, shape): hybrid 4D and the 2D table
JAX_CASES = [
    ("hybrid-4d", dict(scheme="hybrid", reg_time=0.5),
     dict(fidelity="l2", nonneg=False, tmul=True), (4, 3, 16, 128)),
    ("hybrid-4d-l1-nonneg", dict(scheme="hybrid", reg_time=0.7,
                                 reg_z_over_reg=0.3),
     dict(fidelity="l1", nonneg=True, tmul=False), (4, 3, 16, 128)),
    ("hybrid-2d-kl", dict(scheme="hybrid"),
     dict(fidelity="kl", nonneg=False, tmul=False), (1, 1, 16, 128)),
]


def _inputs(cfg, shape, fidelity, tmul, seed, dtype=np.float32):
    rng = np.random.default_rng(seed)
    x0 = rng.random(shape).astype(dtype)
    x = (x0 + 0.1 * rng.random(shape)).astype(dtype)
    y_A = rng.random(shape).astype(dtype)
    if fidelity == "l1":
        y_A = 2 * y_A - 1
    Nd = len(scheme_channels(cfg.scheme, *shape[:2], cfg.reg_z_over_reg,
                             cfg.reg_time)[0])
    y_D = (0.5 * rng.standard_normal(shape[:2] + (Nd,) + shape[2:])
           ).astype(dtype)
    tm = (rng.random(shape[2:]) + 0.5).astype(dtype) if tmul else None
    return x, x0, y_A, y_D, tm


@pytest.mark.parametrize("case", JAX_CASES, ids=[c[0] for c in JAX_CASES])
def test_cp_primal_plain_matches_the_jax_kernel(case):
    """The JAX package's pass A, then its pass B (Pallas, in the
    interpreter, float32); the port's plain pass B on JAX's y_A', y_D':
    x' and the fidelity sum at the CP bar."""
    _, cfg_kw, opts, shape = case
    cfg = TVConfig(**cfg_kw)
    fid_kw = dict(fidelity=opts["fidelity"],
                  fid_weight=0.7 if opts["fidelity"] != "l2" else 1.0)
    x, x0, y_A, y_D, tm = _inputs(cfg, shape, opts["fidelity"], opts["tmul"],
                                  seed=11)
    jcfg = JConfig(**cfg_kw)
    jtm = None if tm is None else jnp.asarray(tm)
    dual = jfused.make_cp_dual_kernel(jcfg, shape, "float32", 0.5, 1.0, 0.5,
                                      True, t_plane=tm is not None, **fid_kw)
    primal = jfused.make_cp_primal_kernel(
        jcfg, shape, "float32", 0.1, True, t_plane=tm is not None,
        nonneg=opts["nonneg"], **fid_kw)
    jyA, jyD, dt_local, _ = dual(jnp.asarray(x), jnp.asarray(x0),
                                 jnp.asarray(y_A), jnp.asarray(y_D), jtm)
    jx, jfid = primal(jnp.asarray(x), jnp.asarray(x0), jyA, jyD, dt_local,
                      jtm)

    tx = torch.tensor(x)
    got, fid = fused.cp_primal(
        tx, torch.tensor(x0), torch.tensor(np.asarray(jyA)),
        torch.tensor(np.asarray(jyD)),
        None if tm is None else torch.tensor(tm), cfg=cfg, tau=0.1,
        nonneg=opts["nonneg"], **fid_kw)
    assert got is tx  # in place, the plain version on the CPU
    np.testing.assert_allclose(got.numpy(), np.asarray(jx), **TOL)
    assert float(fid.sum()) == pytest.approx(float(jfused._sum_parts(jfid)),
                                             rel=1e-5)


@pytest.mark.parametrize("case", JAX_CASES, ids=[c[0] for c in JAX_CASES])
def test_cp_primal_plain_matches_the_f64_reference(case):
    """The JAX package's operators in float64 on a seeded float64 input:
    x' = x - tau y_A - tau D^T y_D (then max(x', 0)), and its fidelity
    term; the port's plain pass B (``cp_primal_plain``: the wrapper takes
    float32 and bfloat16 storage only), out of place on the float64
    arrays, computes in float32 as the kernel does and is held at the CP
    bar."""
    _, cfg_kw, opts, shape = case
    cfg = TVConfig(**cfg_kw)
    fid, fw = opts["fidelity"], 0.7 if opts["fidelity"] != "l2" else 1.0
    x, x0, y_A, y_D, tm = _inputs(cfg, shape, fid, opts["tmul"], seed=12,
                                  dtype=np.float64)
    tau = 0.1
    dty = jD_T(jnp.asarray(y_D.transpose(0, 2, 1, 3, 4)), cfg.scheme,
               weight_time=None if tm is None else jnp.asarray(tm),
               **JConfig(**cfg_kw).kwargs())
    want = jnp.asarray(x) - tau * jnp.asarray(y_A) - tau * dty
    if opts["nonneg"]:
        want = jnp.maximum(want, 0.0)
    want_fid = float(jfidelity_loss(want, jnp.asarray(x0), fid, fw))

    tx = torch.tensor(x)
    out = torch.empty_like(tx)
    got, parts = fused.cp_primal_plain(
        tx, torch.tensor(x0), torch.tensor(y_A), torch.tensor(y_D),
        None if tm is None else torch.tensor(tm, dtype=torch.float32),
        cfg=cfg, tau=tau, fidelity=fid, fid_weight=fw,
        nonneg=opts["nonneg"], out=out)
    assert got is out and torch.equal(tx, torch.tensor(x))  # x untouched
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert float(parts.sum()) == pytest.approx(want_fid, rel=1e-5)
