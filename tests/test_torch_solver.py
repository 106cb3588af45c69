"""The port's Chambolle-Pock solver end to end: reference values, the
golden 4D trajectory, fused against plain, state carried between the JAX
package and the port, and the denoising front-ends."""

import dataclasses
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytv4d_tpu.models.denoise as jden
import pytv4d_tpu.solvers.cp as jcp
import pytv4d_tpu.solvers.fidelity as jfid
from pytv4d_tpu.core.config import TVConfig as JConfig
from pytv4d_tpu_torch import interop
from pytv4d_tpu_torch.core.config import TVConfig
from pytv4d_tpu_torch.models import TVDenoiser, add_noise, denoise_tv_chambolle
from pytv4d_tpu_torch.solvers import cp, fidelity
from pytv4d_tpu_torch.utils import cameraman, has_real_cameraman

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")


@pytest.fixture(scope="module")
def x0_small():
    return torch.tensor(np.random.default_rng(0).random((4, 3, 16, 128)),
                        dtype=torch.float32)


def test_cameraman_cp_reference_value():
    """README recipe: cameraman, noise 100, seed 0, reg 25, 300 iterations,
    f64 -> 38 575 639.48 (BASELINE.md)."""
    assert has_real_cameraman()
    noisy = torch.tensor(add_noise(cameraman().reshape(1, 1, 256, 256), 100,
                                   seed=0))
    res = TVDenoiser(reg=25).cp(noisy[0, 0], n_iter=300)
    assert res.x.shape == (256, 256) and res.loss.shape == (300,)
    assert float(res.loss[-1]) == pytest.approx(38575639.48, rel=1e-9)


def test_golden_solver4d_trajectory():
    g = np.load(os.path.join(GOLDEN, "golden_solver4d.npz"))
    cfg = TVConfig(scheme="hybrid", reg_time=float(g["reg_time"]))
    res = cp.chambolle_pock(torch.tensor(g["noisy"]), n_iter=150,
                            reg=float(g["reg"]), cfg=cfg, tau=float(g["tau"]))
    np.testing.assert_allclose(res.loss.numpy(), g["cp_losses"], rtol=1e-9)


def test_fused_matches_plain(x0_small):
    """fused=True on the CPU runs the plain kernel versions in the fused
    layout; over 50 iterations its loss tracks the plain cp_step loop."""
    cfg = TVConfig(scheme="hybrid", reg_time=0.5)
    a = cp.chambolle_pock(x0_small, n_iter=50, reg=0.3, cfg=cfg, fused=False)
    b = cp.chambolle_pock(x0_small, n_iter=50, reg=0.3, cfg=cfg, fused=True)
    np.testing.assert_allclose(b.loss.numpy(), a.loss.numpy(), rtol=1e-5)
    np.testing.assert_allclose(b.x.numpy(), a.x.numpy(), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(b.state.y_D.numpy(), a.state.y_D.numpy(),
                               atol=1e-5, rtol=1e-5)
    assert torch.equal(x0_small, torch.tensor(
        np.random.default_rng(0).random((4, 3, 16, 128)), dtype=torch.float32))


def test_fused_features_match_plain(x0_small):
    """Static mask + weight_time planes (the tmul multiplier), l1 / kl
    fidelity, nonneg and the huber norm on the fused path."""
    cfg = TVConfig(scheme="central", reg_time=0.5, factor_reg_static=0.3,
                   norm="huber", huber_delta=0.2)
    rng = np.random.default_rng(4)
    kw = dict(mask_static=rng.random((1, 1, 16, 128)) < 0.5,
              weight_time=torch.tensor(rng.random((1, 1, 16, 128)) + 0.5,
                                       dtype=torch.float32))
    for fid in ("l1", "kl"):
        a = cp.chambolle_pock(x0_small, n_iter=20, reg=0.3, cfg=cfg,
                              fused=False, fidelity=fid, fidelity_weight=0.8,
                              nonneg=True, **kw)
        b = cp.chambolle_pock(x0_small, n_iter=20, reg=0.3, cfg=cfg,
                              fused=None, fidelity=fid, fidelity_weight=0.8,
                              nonneg=True, **kw)
        np.testing.assert_allclose(b.loss.numpy(), a.loss.numpy(), rtol=1e-5)
        assert float(b.x.min()) >= 0.0


def test_bf16_dual_storage(x0_small):
    cfg = TVConfig(scheme="hybrid", reg_time=0.5)
    a = cp.chambolle_pock(x0_small, n_iter=15, reg=0.3, cfg=cfg)
    b = cp.chambolle_pock(x0_small, n_iter=15, reg=0.3, cfg=cfg,
                          dual_dtype="bfloat16")
    np.testing.assert_allclose(b.loss.numpy(), a.loss.numpy(), rtol=2e-2)
    assert b.state.y_D.dtype == torch.float32  # public state keeps x's dtype
    c = cp.chambolle_pock(x0_small, n_iter=15, reg=0.3, cfg=cfg,
                          return_dual=False)
    assert c.state.y_D is None
    with pytest.raises(ValueError, match="dual_dtype"):
        cp.chambolle_pock(x0_small.double(), n_iter=2, dual_dtype="bfloat16")


def _jax_problem():
    g = np.load(os.path.join(GOLDEN, "golden_solver4d.npz"))
    jcfg = JConfig(scheme="hybrid", reg_time=float(g["reg_time"]))
    return g["noisy"], jcfg, dict(reg=float(g["reg"]))


def test_state_round_trip_jax_to_port():
    noisy, jcfg, kw = _jax_problem()
    j10 = jcp.chambolle_pock(jnp.asarray(noisy), n_iter=10, cfg=jcfg, **kw)
    j20 = jcp.chambolle_pock(jnp.asarray(noisy), n_iter=20, cfg=jcfg, **kw)
    st = interop.state_from_numpy(*(np.asarray(a) for a in j10.state),
                                  device="cpu", dtype=torch.float64)
    cfg = interop.config_from_fields(**dataclasses.asdict(jcfg))
    p = cp.chambolle_pock(torch.tensor(noisy), n_iter=10, cfg=cfg, state=st,
                          **kw)
    np.testing.assert_allclose(p.loss.numpy(), np.asarray(j20.loss)[10:],
                               rtol=1e-9)
    for a, b in zip(interop.state_to_numpy(p.state), j20.state):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-9, atol=1e-9)


def test_state_round_trip_port_to_jax():
    noisy, jcfg, kw = _jax_problem()
    cfg = interop.config_from_fields(**dataclasses.asdict(jcfg))
    p10 = cp.chambolle_pock(torch.tensor(noisy), n_iter=10, cfg=cfg, **kw)
    p20 = cp.chambolle_pock(torch.tensor(noisy), n_iter=20, cfg=cfg, **kw)
    jst = jcp.CPState(*(jnp.asarray(a)
                        for a in interop.state_to_numpy(p10.state)))
    j = jcp.chambolle_pock(jnp.asarray(noisy), n_iter=10, cfg=jcfg,
                           state=jst, **kw)
    np.testing.assert_allclose(np.asarray(j.loss), p20.loss.numpy()[10:],
                               rtol=1e-9)
    np.testing.assert_allclose(np.asarray(j.x), p20.x.numpy(), rtol=1e-9,
                               atol=1e-9)


def test_fused_resume_from_state(x0_small):
    """A fused run resumed from its own state continues the trajectory."""
    cfg = TVConfig(scheme="upwind", reg_time=0.5)
    full = cp.chambolle_pock(x0_small, n_iter=12, reg=0.3, cfg=cfg)
    half = cp.chambolle_pock(x0_small, n_iter=6, reg=0.3, cfg=cfg)
    rest = cp.chambolle_pock(x0_small, n_iter=6, reg=0.3, cfg=cfg,
                             state=half.state)
    np.testing.assert_allclose(rest.loss.numpy(), full.loss.numpy()[6:],
                               rtol=1e-6)


@pytest.mark.parametrize("channel_axis", [None, -1, 0])
def test_denoise_tv_chambolle_matches_jax(channel_axis):
    rng = np.random.default_rng(6)
    shape = {None: (20, 24), -1: (20, 24, 3), 0: (2, 3, 20, 24)}[channel_axis]
    img = rng.random(shape)
    got = denoise_tv_chambolle(img, weight=0.2, max_num_iter=30,
                               channel_axis=channel_axis, device="cpu")
    ref = np.asarray(jden.denoise_tv_chambolle(img, weight=0.2,
                                               max_num_iter=30,
                                               channel_axis=channel_axis))
    assert got.shape == img.shape
    np.testing.assert_allclose(got, ref, rtol=1e-9, atol=1e-12)


def test_denoise_tv_chambolle_unported_options():
    """No option is unported any more: ``eps`` and ``coupled_channels``,
    which raised ``NotImplementedError`` until they were ported, now solve
    (against the JAX function: tests/test_torch_vectorial.py)."""
    img = np.random.default_rng(0).random((8, 8))
    out = denoise_tv_chambolle(img, eps=1e-3, device="cpu")
    assert out.shape == (8, 8) and np.isfinite(out).all()
    rgb = np.random.default_rng(1).random((8, 8, 3))
    out = denoise_tv_chambolle(rgb, channel_axis=-1, coupled_channels=True,
                               max_num_iter=5, device="cpu")
    assert out.shape == (8, 8, 3) and np.isfinite(out).all()
    with pytest.raises(ValueError, match="channel_axis"):
        denoise_tv_chambolle(img, coupled_channels=True)


@pytest.mark.parametrize("fid", ["l2", "l1", "kl"])
def test_fidelity_and_gap_match_jax(fid):
    rng = np.random.default_rng(7)
    y, ax, b = (rng.random((3, 2, 5, 6)) for _ in range(3))
    y = 2 * y - 1
    w = 0.7
    T = torch.tensor
    np.testing.assert_allclose(
        fidelity.fidelity_dual_prox(T(y), T(ax), T(b), 0.4, fid, w).numpy(),
        np.asarray(jfid.fidelity_dual_prox(y, ax, b, 0.4, fid, w)),
        rtol=1e-12)
    assert float(fidelity.fidelity_loss(T(ax), T(b), fid, w)) == \
        pytest.approx(float(jfid.fidelity_loss(ax, b, fid, w)), rel=1e-12)
    yc, vc = fidelity.fidelity_conjugate(T(y), T(b), fid, w)
    jy, jv = jfid.fidelity_conjugate(y, b, fid, w)
    np.testing.assert_allclose(yc.numpy(), np.asarray(jy), rtol=1e-12)
    assert float(vc) == pytest.approx(float(jv), rel=1e-12)
    with pytest.raises(ValueError, match="positive"):
        fidelity.validate_fidelity(fid, T(b), 0.0)

    noisy, jcfg, kw = _jax_problem()
    cfg = TVConfig(**dataclasses.asdict(jcfg))
    p = cp.chambolle_pock(torch.tensor(noisy), n_iter=8, cfg=cfg,
                          fidelity=fid, fidelity_weight=w, nonneg=True, **kw)
    j = jcp.chambolle_pock(jnp.asarray(noisy), n_iter=8, cfg=jcfg,
                           fidelity=fid, fidelity_weight=w, nonneg=True, **kw)
    np.testing.assert_allclose(p.loss.numpy(), np.asarray(j.loss), rtol=1e-9)
    if fid == "l2":
        gap = cp.pd_gap(p.state, torch.tensor(noisy), kw["reg"], cfg)
        jgap = jcp.pd_gap(j.state, jnp.asarray(noisy), kw["reg"], jcfg)
        assert float(gap) == pytest.approx(float(jgap), rel=1e-9)


def test_progress_every(x0_small):
    seen = []
    cp.chambolle_pock(x0_small, n_iter=7, reg=0.3, progress_every=3,
                      progress_fn=lambda i, loss: seen.append((i, loss)))
    assert [i for i, _ in seen] == [0, 3, 6]
    assert all(isinstance(v, float) for _, v in seen)
