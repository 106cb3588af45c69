"""The port's plain halo-exchange path (``parallel.halo``) against the
unsharded port, slot for slot in float64, and against the JAX package's
``shard_map`` functions on the 8-virtual-device CPU mesh: twins of the
operator and CP tests of ``tests/test_sharding.py``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytv4d_tpu.parallel as jpar
from pytv4d_tpu.core.config import TVConfig as JConfig
from pytv4d_tpu.solvers.cp import init_state as j_init_state
from pytv4d_tpu_torch.core.config import TVConfig
from pytv4d_tpu_torch.core.schemes import num_channels
from pytv4d_tpu_torch.ops import operators as ops
from pytv4d_tpu_torch.ops.tv import tv_and_subgrad
from pytv4d_tpu_torch.parallel import (
    gather_d_volume,
    gather_volume,
    make_mesh,
    make_sharded_cp_solver,
    shard_d_volume,
    shard_volume,
    sharded_D,
    sharded_D_T,
    sharded_tv_and_subgrad,
)
from pytv4d_tpu_torch.solvers.cp import chambolle_pock, init_state

SCHEMES = ("upwind", "downwind", "central", "hybrid")
SHAPE = (8, 4, 16, 16)
PORT = dict(rtol=1e-12, atol=1e-12)   # against the unsharded port
JAX = dict(rtol=1e-9, atol=1e-9)      # against the JAX sharded function


def _jax_mesh():
    """The JAX package's (4, 2) mesh, or None where the process has fewer
    than 8 virtual devices (then only the port's half of a test runs)."""
    if len(jax.devices()) < 8:
        return None
    return jpar.make_mesh(z=4, t=2)


def _mesh():
    return make_mesh(4, 2, device="cpu")


@pytest.mark.parametrize("scheme", SCHEMES)
def test_sharded_D_matches_local(scheme):
    img = np.random.default_rng(31).random(SHAPE)
    kw = dict(scheme=scheme, reg_time=0.5, reg_z_over_reg=0.7)
    cfg, mesh = TVConfig(**kw), _mesh()
    got = gather_d_volume(sharded_D(mesh, cfg, SHAPE)(shard_volume(img, mesh)))
    local = ops.D(torch.tensor(img), scheme, **cfg.kwargs())
    np.testing.assert_allclose(got.numpy(), local.numpy(), **PORT)
    jmesh = _jax_mesh()
    if jmesh is not None:
        ref = jpar.sharded_D(jmesh, JConfig(**kw), SHAPE)(
            jpar.shard_volume(jnp.asarray(img), jmesh))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **JAX)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_sharded_D_T_matches_local(scheme):
    kw = dict(scheme=scheme, reg_time=0.5)
    cfg, mesh = TVConfig(**kw), _mesh()
    Nd = num_channels(scheme, 8, 4, cfg.reg_z_over_reg, cfg.reg_time)
    y = np.random.default_rng(32).random((8, Nd, 4, 16, 16))
    got = gather_volume(sharded_D_T(mesh, cfg, SHAPE)(shard_d_volume(y, mesh)))
    local = ops.D_T(torch.tensor(y), scheme, **cfg.kwargs())
    np.testing.assert_allclose(got.numpy(), local.numpy(), **PORT)
    jmesh = _jax_mesh()
    if jmesh is not None:
        ref = jpar.sharded_D_T(jmesh, JConfig(**kw), SHAPE)(jnp.asarray(y))
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **JAX)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_sharded_adjointness(scheme):
    """Cross-shard-edge scatter contributions must keep
    <Y, D X> == <D^T Y, X> exactly."""
    rng = np.random.default_rng(33)
    cfg = TVConfig(scheme=scheme, reg_time=0.8, reg_z_over_reg=0.4)
    mesh = _mesh()
    Nd = num_channels(scheme, 8, 4, cfg.reg_z_over_reg, cfg.reg_time)
    X = torch.tensor(rng.random(SHAPE))
    Y = torch.tensor(rng.random((8, Nd, 4, 16, 16)))
    DX = gather_d_volume(sharded_D(mesh, cfg, SHAPE)(shard_volume(X, mesh)))
    DTY = gather_volume(sharded_D_T(mesh, cfg, SHAPE)(shard_d_volume(Y, mesh)))
    lhs, rhs = float(torch.sum(Y * DX)), float(torch.sum(DTY * X))
    # normalise by the inner-product scale, not |lhs| (which can cancel)
    scale = float(torch.linalg.norm(Y.ravel()) * torch.linalg.norm(DX.ravel()))
    assert abs(lhs - rhs) / scale < 1e-14


@pytest.mark.parametrize("norm", ["iso", "aniso", "huber"])
def test_sharded_tv_and_subgrad_matches_local(norm):
    img = np.random.default_rng(34).random(SHAPE)
    kw = dict(scheme="hybrid", reg_time=0.5, norm=norm, huber_delta=0.3)
    cfg, mesh = TVConfig(**kw), _mesh()
    tv_s, G_s = sharded_tv_and_subgrad(mesh, cfg, SHAPE)(
        shard_volume(img, mesh))
    G_s = gather_volume(G_s)
    tv_l, G_l = tv_and_subgrad(torch.tensor(img), "hybrid", reg_time=0.5,
                               norm_type=norm, huber_delta=0.3)
    assert float(tv_s) == pytest.approx(float(tv_l), rel=1e-12)
    np.testing.assert_allclose(G_s.numpy(), G_l.numpy(), **PORT)
    jmesh = _jax_mesh()
    if jmesh is not None:
        jtv, jG = jpar.sharded_tv_and_subgrad(jmesh, JConfig(**kw), SHAPE)(
            jpar.shard_volume(jnp.asarray(img), jmesh))
        assert float(tv_s) == pytest.approx(float(jtv), rel=1e-12)
        np.testing.assert_allclose(G_s.numpy(), np.asarray(jG), **JAX)


@pytest.mark.parametrize("case", [
    ("hybrid", "iso", "l2", False), ("central", "aniso", "l1", False),
    ("upwind", "huber", "kl", True)], ids=lambda c: "-".join(map(str, c)))
def test_sharded_cp_tracks_unsharded(case):
    scheme, norm, fidelity, nonneg = case
    noisy = np.random.default_rng(35).random(SHAPE) + 10.0
    kw = dict(scheme=scheme, reg_time=0.5, norm=norm, huber_delta=0.3)
    fid = dict(fidelity=fidelity, fidelity_weight=0.7, nonneg=nonneg)
    cfg, mesh = TVConfig(**kw), _mesh()
    x0 = torch.tensor(noisy)
    ref = chambolle_pock(x0, n_iter=10, reg=0.5, cfg=cfg, fused=False, **fid)
    solve = make_sharded_cp_solver(mesh, cfg, SHAPE, reg=0.5, n_iter=10,
                                   **fid)
    st = init_state(x0, cfg)
    x, y_A, y_D, losses = solve(
        shard_volume(x0, mesh), shard_volume(st.x, mesh),
        shard_volume(st.y_A, mesh), shard_d_volume(st.y_D, mesh))
    np.testing.assert_allclose(losses.numpy(), ref.loss.numpy(), rtol=1e-12)
    for got, want in ((gather_volume(x), ref.x),
                      (gather_volume(y_A), ref.state.y_A),
                      (gather_d_volume(y_D), ref.state.y_D)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), **PORT)
    jmesh = _jax_mesh()
    if jmesh is not None:
        jcfg = JConfig(**kw)
        jst = j_init_state(jnp.asarray(noisy), jcfg)
        jsolve = jpar.make_sharded_cp_solver(jmesh, jcfg, SHAPE, reg=0.5,
                                             n_iter=10, **fid)
        jx, _, jyD, jlosses = jsolve(
            jpar.shard_volume(jnp.asarray(noisy), jmesh),
            jpar.shard_volume(jst.x, jmesh),
            jpar.shard_volume(jst.y_A, jmesh),
            jax.device_put(jst.y_D, jpar.d_volume_sharding(jmesh)))
        np.testing.assert_allclose(losses.numpy(), np.asarray(jlosses),
                                   rtol=1e-9)
        np.testing.assert_allclose(gather_volume(x).numpy(), np.asarray(jx),
                                   **JAX)
        np.testing.assert_allclose(gather_d_volume(y_D).numpy(),
                                   np.asarray(jyD), **JAX)


def test_grid_checks():
    cfg, mesh = TVConfig(scheme="hybrid"), _mesh()
    x = shard_volume(np.zeros(SHAPE), mesh)
    with pytest.raises(ValueError, match="4 x 2 grid"):
        sharded_D(mesh, cfg, SHAPE)(x[:2])
    with pytest.raises(ValueError, match="not divisible"):
        sharded_D(mesh, cfg, (6, 4, 16, 16))(x)
    with pytest.raises(ValueError, match="hold"):
        sharded_D(mesh, cfg, (16, 4, 16, 16))(x)
    with pytest.raises(ValueError, match="fidelity"):
        make_sharded_cp_solver(mesh, cfg, SHAPE, reg=1.0, n_iter=1,
                               fidelity="l3")
