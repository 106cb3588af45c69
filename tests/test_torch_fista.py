"""The port's dual FISTA against the JAX package's, in float64 on the CPU:
the same seeded input through both."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytv4d_tpu.solvers import fista_mod as jfista
from pytv4d_tpu.core.config import TVConfig as JConfig
from pytv4d_tpu.models.denoise import TVDenoiser as JDenoiser
from pytv4d_tpu_torch import interop
from pytv4d_tpu_torch.core.config import TVConfig
from pytv4d_tpu_torch.models import TVDenoiser
from pytv4d_tpu_torch.solvers import fista_mod as fista

SHAPE = (3, 2, 12, 16)
RTOL = 1e-9  # float64, the same operations in the same order

CASES = {
    "hybrid-time": (dict(scheme="hybrid", reg_time=0.5), {}),
    "upwind-zt": (dict(scheme="upwind", reg_time=0.7, reg_z_over_reg=0.3),
                  {}),
    "central": (dict(scheme="central", reg_time=0.5), {}),
    "downwind-aniso": (dict(scheme="downwind", norm="aniso"), {}),
    "hybrid-L": (dict(scheme="hybrid", reg_time=0.5), dict(L=12.0)),
}


def _noisy(seed=0):
    return np.random.default_rng(seed).random(SHAPE)


@pytest.mark.parametrize("case", list(CASES))
def test_fista_matches_jax(case):
    cfg_kw, kw = CASES[case]
    x0 = _noisy()
    want = jfista.fista(jnp.asarray(x0), n_iter=25, reg=0.3,
                        cfg=JConfig(**cfg_kw), **kw)
    got = fista.fista(torch.tensor(x0), n_iter=25, reg=0.3,
                      cfg=TVConfig(**cfg_kw), **kw)
    assert isinstance(got, fista.FISTAResult)
    assert got.loss.dtype == torch.float64 and tuple(got.loss.shape) == (25,)
    np.testing.assert_allclose(got.loss.numpy(), np.asarray(want.loss),
                               rtol=RTOL)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=RTOL,
                               atol=1e-12)
    np.testing.assert_allclose(got.y.numpy(), np.asarray(want.y), rtol=RTOL,
                               atol=1e-12)


def test_fista_planes_match_jax():
    cfg_kw = dict(scheme="hybrid", reg_time=0.5, factor_reg_static=0.3)
    rng = np.random.default_rng(3)
    mask = rng.random((1, 1) + SHAPE[2:]) < 0.5
    wt = 0.5 + 0.5 * rng.random((1, 1) + SHAPE[2:])
    x0 = _noisy()
    want = jfista.fista(jnp.asarray(x0), n_iter=10, reg=0.3,
                        cfg=JConfig(**cfg_kw), mask_static=jnp.asarray(mask),
                        weight_time=jnp.asarray(wt))
    got = fista.fista(torch.tensor(x0), n_iter=10, reg=0.3,
                      cfg=TVConfig(**cfg_kw), mask_static=torch.tensor(mask),
                      weight_time=torch.tensor(wt))
    np.testing.assert_allclose(got.loss.numpy(), np.asarray(want.loss),
                               rtol=RTOL)


def test_fista_huber_error_speaks_as_jax():
    x0 = _noisy()
    with pytest.raises(ValueError) as want:
        jfista.fista(jnp.asarray(x0), n_iter=1,
                     cfg=JConfig(norm="huber", huber_delta=0.2))
    with pytest.raises(ValueError) as got:
        fista.fista(torch.tensor(x0), n_iter=1,
                    cfg=TVConfig(norm="huber", huber_delta=0.2))
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("norm", ("iso", "aniso"))
def test_project_dual_matches_jax(norm):
    y = np.random.default_rng(4).standard_normal((3, 4, 2, 6, 8))
    y[0, :, 0, 0, 0] = 0.0
    want = jfista._project_dual(jnp.asarray(y), 0.7, norm)
    got = fista._project_dual(torch.tensor(y), 0.7, norm)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-14,
                               atol=0)


def test_fista_warm_start_carries_across_packages():
    """``y_init`` resumes the dual (the momentum restarts, in both
    packages alike)."""
    cfg_kw = dict(scheme="hybrid", reg_time=0.5)
    x0 = _noisy(1)
    a = fista.fista(torch.tensor(x0), n_iter=8, reg=0.3,
                    cfg=TVConfig(**cfg_kw))
    ja = jfista.fista(jnp.asarray(x0), n_iter=8, reg=0.3,
                      cfg=JConfig(**cfg_kw))
    want = jfista.fista(jnp.asarray(x0), n_iter=8, reg=0.3,
                        cfg=JConfig(**cfg_kw), y_init=ja.y)
    # the port resumed from its own dual, and from the JAX run's
    y = interop.fista_dual_from_numpy(np.asarray(ja.y), device="cpu")
    assert y.dtype == torch.float64 and y.device.type == "cpu"
    for y_init in (a.y, y):
        got = fista.fista(torch.tensor(x0), n_iter=8, reg=0.3,
                          cfg=TVConfig(**cfg_kw), y_init=y_init)
        np.testing.assert_allclose(got.loss.numpy(), np.asarray(want.loss),
                                   rtol=RTOL)
    assert float(got.loss[0]) < float(a.loss[0])  # the warm start helps
    # and back: a port dual warm-starts the JAX solver
    back = jfista.fista(jnp.asarray(x0), n_iter=8, reg=0.3,
                        cfg=JConfig(**cfg_kw), y_init=jnp.asarray(a.y.numpy()))
    np.testing.assert_allclose(np.asarray(back.loss), np.asarray(want.loss),
                               rtol=RTOL)


def test_fista_keeps_the_input_and_float32():
    x0 = torch.tensor(_noisy(), dtype=torch.float32)
    keep = x0.clone()
    res = fista.fista(x0, n_iter=3, reg=0.3)
    assert torch.equal(x0, keep)
    assert res.x.dtype == res.y.dtype == res.loss.dtype == torch.float32
    assert float(res.loss[-1]) < float(res.loss[0])


@pytest.mark.parametrize("rank", (2, 3, 4))
def test_denoiser_fista_matches_jax(rank):
    img = np.random.default_rng(6).random(SHAPE[4 - rank:])
    want = JDenoiser(reg=0.3).fista(jnp.asarray(img), n_iter=10)
    got = TVDenoiser(reg=0.3).fista(img, n_iter=10, device="cpu")
    assert tuple(got.x.shape) == img.shape and got.x.dtype == torch.float64
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=RTOL,
                               atol=1e-12)
    np.testing.assert_allclose(got.loss.numpy(), np.asarray(want.loss),
                               rtol=RTOL)
