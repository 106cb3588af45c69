"""The port's sharded CP and GD solvers on the fused kernels
(``parallel.fused_halo``; the kernels' plain versions on the CPU) against
the unsharded port, slot for slot, and against the JAX package's sharded
fused solvers, whose Pallas kernels run in the interpreter under
``shard_map`` on the virtual CPU mesh: twins of the fused tests of
``tests/test_sharding.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytv4d_tpu.parallel as jpar
from pytv4d_tpu.core.config import TVConfig as JConfig
from pytv4d_tpu.kernels.fused import to_internal_layout as j_to_internal
from pytv4d_tpu.solvers.cp import init_state as j_init_state
from pytv4d_tpu_torch.core.config import TVConfig
from pytv4d_tpu_torch.core.schemes import channel_weight, scheme_channels
from pytv4d_tpu_torch.kernels.fused import to_internal_layout
from pytv4d_tpu_torch.ops.operators import abs_d_channel
from pytv4d_tpu_torch.parallel import (
    gather_volume,
    make_mesh,
    make_sharded_cp_solver_fused,
    make_sharded_gd_solver_fused,
    shard_volume,
)
from pytv4d_tpu_torch.solvers.cp import chambolle_pock, init_state
from pytv4d_tpu_torch.solvers.gd import subgradient_descent

SCHEMES = ("upwind", "downwind", "central", "hybrid")
N_ITER = 8
# the JAX package's bars between its sharded fused solvers and its jnp ones
JAX_X = dict(atol=1e-5, rtol=1e-4)
JAX_LOSS = 1e-5
BF16_X = dict(atol=3e-2, rtol=2e-2)
DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _jax_mesh(zt):
    """The JAX package's mesh on the first ``z * t`` virtual devices, or
    None where the process has too few (then only the port's half runs)."""
    n = zt[0] * zt[1]
    if len(jax.devices()) < n:
        return None
    return jpar.make_mesh(z=zt[0], t=zt[1], devices=jax.devices()[:n])


def _noisy(shape, seed, dtype="float32"):
    base = (np.random.default_rng(seed).random(shape) + 3.0).astype(np.float32)
    return torch.tensor(base).to(DT[dtype]), jnp.asarray(base).astype(dtype)


def _solve_cp(noisy, cfg, zt, solver_kw):
    """The port's sharded fused solve from a cold start, gathered:
    ``(x, y_A, y_D_int, losses)``."""
    st_time = zt[1] > 1
    mesh = make_mesh(*zt, device="cpu")
    solve = make_sharded_cp_solver_fused(
        mesh, cfg, tuple(noisy.shape), reg=0.4, n_iter=N_ITER,
        shard_time=st_time, **solver_kw)
    st = init_state(noisy, cfg)
    x, y_A, y_D, losses = solve(
        shard_volume(noisy, mesh, st_time), shard_volume(st.x, mesh, st_time),
        shard_volume(st.y_A, mesh, st_time),
        shard_volume(to_internal_layout(st.y_D), mesh, st_time))
    return gather_volume(x), gather_volume(y_A), gather_volume(y_D), losses


def _solve_cp_jax(jnoisy, cfg_kw, zt, solver_kw):
    jmesh = _jax_mesh(zt)
    if jmesh is None:
        return None
    st_time = zt[1] > 1
    jcfg = JConfig(**cfg_kw)
    kw = dict(solver_kw)
    dual = kw.get("dual_dtype")
    solve = jpar.make_sharded_cp_solver_fused(
        jmesh, jcfg, tuple(jnoisy.shape), reg=0.4, n_iter=N_ITER,
        shard_time=st_time, interpret=True, **kw)
    st = j_init_state(jnoisy, jcfg)
    yd = j_to_internal(st.y_D)
    if dual:
        yd = yd.astype(dual)
    x, _, _, losses = solve(
        jpar.shard_volume(jnoisy, jmesh, shard_time=st_time),
        jpar.shard_volume(st.x, jmesh, shard_time=st_time),
        jpar.shard_volume(st.y_A, jmesh, shard_time=st_time),
        jax.device_put(yd, jpar.internal_d_sharding(jmesh,
                                                    shard_time=st_time)))
    return np.asarray(x.astype(jnp.float32)), np.asarray(losses, np.float32)


def _check_cp(cfg_kw, zt, shape, seed, solver_kw=None, dtype="float32",
              ref_kw=None):
    """The sharded solve equals the unsharded fused solve bit for bit (the
    losses to the order of their sum) and tracks the JAX sharded solve."""
    solver_kw = dict(solver_kw or {})
    if dtype != "float32":
        solver_kw["dtype"] = dtype
    noisy, jnoisy = _noisy(shape, seed, dtype)
    cfg = TVConfig(**cfg_kw)
    ref_kw = dict(ref_kw or {})
    for k in ("dual_dtype", "mask_static", "fidelity", "fidelity_weight",
              "nonneg"):
        if k in solver_kw:
            ref_kw[k] = solver_kw[k]
    ref = chambolle_pock(noisy, n_iter=N_ITER, reg=0.4, cfg=cfg, **ref_kw)
    x, y_A, y_D, losses = _solve_cp(noisy, cfg, zt, solver_kw)
    assert x.dtype == DT[dtype]
    assert torch.equal(x, ref.x) and torch.equal(y_A, ref.state.y_A)
    assert torch.equal(y_D.transpose(1, 2).to(ref.state.y_D.dtype),
                       ref.state.y_D)
    bf16 = dtype == "bfloat16" or "dual_dtype" in solver_kw
    np.testing.assert_allclose(losses.numpy(), ref.loss.numpy(),
                               rtol=1e-4 if bf16 else 1e-6)
    got = _solve_cp_jax(jnoisy, cfg_kw, zt, solver_kw)
    if got is not None:
        jx, jlosses = got
        np.testing.assert_allclose(losses.numpy(), jlosses,
                                   rtol=2e-2 if bf16 else JAX_LOSS)
        np.testing.assert_allclose(x.float().numpy(), jx,
                                   **(BF16_X if bf16 else JAX_X))
    return x, losses


@pytest.mark.parametrize("scheme", SCHEMES)
def test_sharded_fused_cp_tracks_unsharded(scheme):
    """Ghost-plane halos for every scheme, central's reflect ghosts
    included, on a (4 x 2) mesh."""
    _check_cp(dict(scheme=scheme, reg_time=0.5), (4, 2), (8, 4, 16, 16), 38)


def test_sharded_fused_cp_one_plane_shards():
    """z=8 mesh over Nz=8: every shard holds ONE z-plane, all z stencil
    reads cross shards, and central's reflect ghost comes from the halo."""
    _check_cp(dict(scheme="central", reg_time=0.5), (8, 1), (8, 2, 16, 16),
              39)


@pytest.mark.parametrize("scheme,mesh_zt,shape", [
    ("hybrid", (4, 2), (8, 4, 16, 16)),
    ("central", (4, 2), (8, 4, 16, 16)),
    ("central", (8, 1), (8, 2, 16, 16)),   # 1-plane shards, reflect ghosts
    ("central", (2, 4), (4, 8, 16, 16)),   # 1-frame time shards
    ("upwind", (8, 1), (8, 2, 16, 16)),
    ("downwind", (4, 2), (8, 4, 16, 16)),
])
def test_sharded_fused_gd_tracks_unsharded(scheme, mesh_zt, shape):
    _check_gd(dict(scheme=scheme, reg_time=0.5), mesh_zt, shape, 40)


def _check_gd(cfg_kw, zt, shape, seed, dtype="float32"):
    noisy, jnoisy = _noisy(shape, seed, dtype)
    cfg = TVConfig(**cfg_kw)
    st_time = zt[1] > 1
    kw = dict(reg=0.4, n_iter=N_ITER, step_size=1e-2)
    ref = subgradient_descent(noisy, cfg=cfg, **kw)
    mesh = make_mesh(*zt, device="cpu")
    solve = make_sharded_gd_solver_fused(mesh, cfg, shape, shard_time=st_time,
                                         dtype=dtype, **kw)
    xs = shard_volume(noisy, mesh, st_time)
    x, losses = solve(xs, xs)
    x = gather_volume(x)
    bf16 = dtype == "bfloat16"
    assert x.dtype == DT[dtype] and torch.equal(x, ref.x)
    assert torch.equal(gather_volume(xs), noisy)  # the inputs are intact
    np.testing.assert_allclose(losses.numpy(), ref.loss.numpy(),
                               rtol=2e-2 if bf16 else 1e-6)
    jmesh = _jax_mesh(zt)
    if jmesh is None:
        return
    jsolve = jpar.make_sharded_gd_solver_fused(
        jmesh, JConfig(**cfg_kw), shape, shard_time=st_time, dtype=dtype,
        interpret=True, **kw)
    jxs = jpar.shard_volume(jnoisy, jmesh, shard_time=st_time)
    jx, jlosses = jsolve(jxs, jxs)
    np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses, np.float32),
                               rtol=2e-2 if bf16 else JAX_LOSS)
    np.testing.assert_allclose(x.float().numpy(),
                               np.asarray(jx.astype(jnp.float32)),
                               **(BF16_X if bf16 else JAX_X))


def test_sharded_aniso_paths():
    """Anisotropic TV on the sharded fused CP (the box prox in pass A) and
    the sharded fused GD (the sign subgradient, which reads no norms)."""
    cfg_kw = dict(scheme="hybrid", reg_time=0.5, norm="aniso")
    _check_cp(cfg_kw, (4, 2), (8, 4, 16, 16), 61)
    _check_gd(cfg_kw, (4, 2), (8, 4, 16, 16), 61)


OVERLAP_SHAPE = (16, 3, 8, 32)   # 4 z-shards of 4 planes: overlap engages
MASK = np.tri(8, 32, dtype=bool)[None, None]
OVERLAP_CASES = {
    "upwind": ("upwind", dict(), dict()),
    "downwind": ("downwind", dict(), dict()),
    "central": ("central", dict(), dict()),
    "hybrid": ("hybrid", dict(), dict()),
    "hybrid-aniso": ("hybrid", dict(norm="aniso"), dict()),
    "hybrid-huber": ("hybrid", dict(norm="huber", huber_delta=0.3), dict()),
    "hybrid-bf16dual": ("hybrid", dict(), dict(dual_dtype="bfloat16")),
    "hybrid-mask": ("hybrid", dict(factor_reg_static=0.3),
                    dict(mask_static=MASK)),
    "hybrid-l1": ("hybrid", dict(), dict(fidelity="l1", fidelity_weight=0.7)),
    "central-kl-nonneg": ("central", dict(),
                          dict(fidelity="kl", nonneg=True)),
}


@pytest.mark.parametrize("case", list(OVERLAP_CASES.values()),
                         ids=list(OVERLAP_CASES))
def test_sharded_cp_overlap_matches_ghost_path(case):
    """The interior kernels + boundary kernels must equal both the ghost
    path and the unsharded fused solver slot for slot, across schemes,
    norms, storage, masks and fidelities."""
    scheme, cfg_kw, extra = case
    cfg_kw = dict(scheme=scheme, reg_time=0.5, **cfg_kw)
    out = {}
    for ov in (False, True):
        out[ov] = _check_cp(cfg_kw, (4, 1), OVERLAP_SHAPE, 50,
                            dict(overlap=ov, **extra))
    assert torch.equal(out[True][0], out[False][0])
    np.testing.assert_allclose(out[True][1].numpy(), out[False][1].numpy(),
                               rtol=1e-6)


def test_overlap_default_and_guard():
    cfg = TVConfig(scheme="hybrid", reg_time=0.5)
    z4, z4t2 = make_mesh(4, device="cpu"), make_mesh(4, 2, device="cpu")
    kw = dict(reg=0.4, n_iter=1)
    assert make_sharded_cp_solver_fused(z4, cfg, (16, 3, 8, 32), **kw).overlap
    # 2 local planes, a t-sharded mesh, no z channel: the ghost path
    assert not make_sharded_cp_solver_fused(z4, cfg, (8, 3, 8, 32),
                                            **kw).overlap
    assert not make_sharded_cp_solver_fused(z4t2, cfg, (16, 4, 8, 32),
                                            **kw).overlap
    noz = TVConfig(scheme="hybrid", reg_time=0.5, reg_z_over_reg=0.0)
    assert not make_sharded_cp_solver_fused(z4, noz, (16, 3, 8, 32),
                                            **kw).overlap
    for mesh, c, shape in ((z4, cfg, (8, 3, 8, 32)),
                           (z4t2, cfg, (16, 4, 8, 32)),
                           (z4, noz, (16, 3, 8, 32))):
        with pytest.raises(ValueError, match="3 local z planes"):
            make_sharded_cp_solver_fused(mesh, c, shape, overlap=True, **kw)
    with pytest.raises(ValueError, match="not divisible"):
        make_sharded_cp_solver_fused(z4, cfg, (10, 3, 8, 32), **kw)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        make_sharded_cp_solver_fused(z4, cfg, (16, 3, 8, 32),
                                     dtype="float64", **kw)
    solve = make_sharded_cp_solver_fused(z4, cfg, (16, 3, 8, 32), **kw)
    x = shard_volume(np.zeros((16, 3, 8, 32)), z4)   # float64 shards
    with pytest.raises(ValueError, match="shards must be torch.float32"):
        solve(x, x, x, x)


@pytest.mark.parametrize("overlap", [False, True])
def test_sharded_fused_cp_bf16_primary(overlap):
    """bf16 PRIMARY storage (x / y_A / x0): both halo paths equal the
    unsharded fused solver run at the same storage dtypes."""
    x, _ = _check_cp(dict(scheme="hybrid", reg_time=0.5), (4, 1),
                     OVERLAP_SHAPE, 62, dict(overlap=overlap),
                     dtype="bfloat16")
    assert x.dtype == torch.bfloat16


def test_sharded_huber_gd_paths():
    _check_gd(dict(scheme="hybrid", reg_time=0.5, norm="huber",
                   huber_delta=0.3), (4, 2), (8, 4, 16, 16), 64)


def test_sharded_fused_gd_bf16_primary():
    _check_gd(dict(scheme="hybrid", reg_time=0.5), (4, 2), (8, 4, 16, 16), 63,
              dtype="bfloat16")


def _valid_slots(cfg, shape):
    """(Nz, Nd, M, Nr, Nc) bool: the slots where a channel's difference is
    defined (elsewhere the reference's zero-slot boundary holds)."""
    chans, _ = scheme_channels(cfg.scheme, shape[0], shape[1],
                               cfg.reg_z_over_reg, cfg.reg_time)
    ones = torch.ones(shape)
    return torch.stack([abs_d_channel(ones, ch.axis, ch.kind) > 0
                        for ch in chans], dim=1)


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("overlap", [False, True])
def test_dual_stays_zero_at_globally_invalid_slots(scheme, overlap):
    """The invariant the sharded adjoint pass relies on (zero halos stand
    for the volume's edge): after every iteration y_D is exactly zero where
    a channel's slot is invalid in the WHOLE volume."""
    shape = OVERLAP_SHAPE
    cfg = TVConfig(scheme=scheme, reg_time=0.5)
    noisy, _ = _noisy(shape, 70)
    mesh = make_mesh(4, device="cpu")
    solve = make_sharded_cp_solver_fused(mesh, cfg, shape, reg=0.4, n_iter=1,
                                         shard_time=False, overlap=overlap)
    st = init_state(noisy, cfg)
    x0 = shard_volume(noisy, mesh, False)
    state = (shard_volume(st.x, mesh, False), shard_volume(st.y_A, mesh, False),
             shard_volume(to_internal_layout(st.y_D), mesh, False))
    invalid = ~_valid_slots(cfg, shape)
    assert invalid.any()
    for _ in range(5):
        *state, _ = solve(x0, *state)
        y_D = gather_volume(state[2]).transpose(1, 2)
        assert y_D.abs().max() > 0 and not y_D[invalid].any()
