"""The port's ADMM TV denoising against the JAX package's, in float64 on
the CPU: the same seeded input through both."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytv4d_tpu.solvers import admm_mod as jadmm
from pytv4d_tpu.core.config import TVConfig as JConfig
from pytv4d_tpu.models.denoise import TVDenoiser as JDenoiser
from pytv4d_tpu_torch import interop
from pytv4d_tpu_torch.core.config import TVConfig
from pytv4d_tpu_torch.models import TVDenoiser
from pytv4d_tpu_torch.solvers import admm_mod as admm

SHAPE = (3, 2, 12, 16)
# float64, the same operations in the same order on both sides; the CG
# inner solve divides by sums over the volume, whose order of additions
# differs between the packages
RTOL = 1e-9

CASES = {
    "hybrid-time": dict(scheme="hybrid", reg_time=0.5),
    "upwind-zt": dict(scheme="upwind", reg_time=0.7, reg_z_over_reg=0.3),
    "central-huber": dict(scheme="central", reg_time=0.5, norm="huber",
                          huber_delta=0.2),
    "downwind-aniso": dict(scheme="downwind", norm="aniso"),
}


def _noisy(seed=0):
    return np.random.default_rng(seed).random(SHAPE)


@pytest.mark.parametrize("case", list(CASES))
def test_admm_matches_jax(case):
    cfg_kw = CASES[case]
    x0 = _noisy()
    kw = dict(n_iter=12, reg=0.3, rho=2.0, cg_iter=6)
    want = jadmm.admm(jnp.asarray(x0), cfg=JConfig(**cfg_kw), **kw)
    got = admm.admm(torch.tensor(x0), cfg=TVConfig(**cfg_kw), **kw)
    assert isinstance(got, admm.ADMMResult)
    assert isinstance(got.state, admm.ADMMState)
    assert got.loss.dtype == torch.float64 and tuple(got.loss.shape) == (12,)
    np.testing.assert_allclose(got.loss.numpy(), np.asarray(want.loss),
                               rtol=RTOL)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=RTOL,
                               atol=1e-12)
    for g, w, name in zip(got.state, want.state, admm.ADMMState._fields):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=1e-11, err_msg=name)


def test_admm_planes_match_jax():
    """A static mask and a weight_time plane ride the operators."""
    cfg_kw = dict(scheme="hybrid", reg_time=0.5, factor_reg_static=0.3)
    rng = np.random.default_rng(3)
    mask = rng.random((1, 1) + SHAPE[2:]) < 0.5
    wt = 0.5 + 0.5 * rng.random((1, 1) + SHAPE[2:])
    x0 = _noisy()
    kw = dict(n_iter=8, reg=0.3, rho=2.0, cg_iter=5)
    want = jadmm.admm(jnp.asarray(x0), cfg=JConfig(**cfg_kw),
                      mask_static=jnp.asarray(mask),
                      weight_time=jnp.asarray(wt), **kw)
    got = admm.admm(torch.tensor(x0), cfg=TVConfig(**cfg_kw),
                    mask_static=torch.tensor(mask),
                    weight_time=torch.tensor(wt), **kw)
    np.testing.assert_allclose(got.loss.numpy(), np.asarray(want.loss),
                               rtol=RTOL)


@pytest.mark.parametrize("norm", ("iso", "aniso", "huber"))
def test_group_soft_threshold_matches_jax(norm):
    v = np.random.default_rng(4).standard_normal((3, 4, 2, 6, 8))
    v[0, :, 0, 0, 0] = 0.0  # a zero group
    want = jadmm.group_soft_threshold(jnp.asarray(v), 0.4, norm, 0.3)
    got = admm.group_soft_threshold(torch.tensor(v), 0.4, norm, 0.3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-13,
                               atol=1e-15)


def test_cg_solve_matches_jax_and_solves():
    rng = np.random.default_rng(5)
    Q = rng.standard_normal((20, 20))
    A = Q @ Q.T + 20 * np.eye(20)
    b = rng.standard_normal(20)
    want = jadmm._cg_solve(lambda v: jnp.asarray(A) @ v, jnp.asarray(b),
                           jnp.zeros(20), 25)
    got = admm._cg_solve(lambda v: torch.tensor(A) @ v, torch.tensor(b),
                         torch.zeros(20, dtype=torch.float64), 25)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-9,
                               atol=1e-13)
    np.testing.assert_allclose(A @ got.numpy(), b, atol=1e-10)


def test_admm_resume_is_exact_and_carries_across_packages():
    cfg_kw = dict(scheme="hybrid", reg_time=0.5)
    cfg = TVConfig(**cfg_kw)
    x0 = torch.tensor(_noisy(1))
    kw = dict(reg=0.3, rho=2.0, cg_iter=6, cfg=cfg)
    full = admm.admm(x0, n_iter=10, **kw)
    a = admm.admm(x0, n_iter=4, **kw)
    b = admm.admm(x0, n_iter=6, state=a.state, **kw)
    assert torch.equal(b.x, full.x)
    assert torch.equal(torch.cat([a.loss, b.loss]), full.loss)
    jkw = dict(reg=0.3, rho=2.0, cg_iter=6, cfg=JConfig(**cfg_kw))
    jhalf = jadmm.admm(jnp.asarray(x0.numpy()), n_iter=4, **jkw)
    st = interop.admm_state_from_numpy(*(np.asarray(f) for f in jhalf.state),
                                       device="cpu")
    assert isinstance(st, admm.ADMMState) and st.z.dtype == torch.float64
    c = admm.admm(x0, n_iter=6, state=st, **kw)
    np.testing.assert_allclose(c.loss.numpy(), full.loss[4:].numpy(),
                               rtol=RTOL)
    jrest = jadmm.admm(jnp.asarray(x0.numpy()), n_iter=6,
                       state=jadmm.ADMMState(*interop.state_to_numpy(a.state)),
                       **jkw)
    np.testing.assert_allclose(np.asarray(jrest.loss), full.loss[4:].numpy(),
                               rtol=RTOL)


def test_init_state_and_input_kept():
    cfg = TVConfig(scheme="hybrid", reg_time=0.5)
    x0 = torch.tensor(_noisy(), dtype=torch.float32)
    keep = x0.clone()
    st = admm.init_state(x0, cfg)
    assert st.x is x0 and st.z.dtype == torch.float32
    assert tuple(st.z.shape) == tuple(st.u.shape) == (3, 8, 2, 12, 16)
    assert not st.z.any() and not st.u.any()
    res = admm.admm(x0, n_iter=2, reg=0.3, cfg=cfg)
    assert torch.equal(x0, keep) and res.x.dtype == torch.float32


@pytest.mark.parametrize("rank", (2, 3, 4))
def test_denoiser_admm_matches_jax(rank):
    img = np.random.default_rng(6).random(SHAPE[4 - rank:])
    want = JDenoiser(reg=0.3).admm(jnp.asarray(img), n_iter=6, rho=2.0)
    got = TVDenoiser(reg=0.3).admm(img, n_iter=6, rho=2.0, device="cpu")
    assert tuple(got.x.shape) == img.shape and got.x.dtype == torch.float64
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=RTOL,
                               atol=1e-12)
    np.testing.assert_allclose(got.loss.numpy(), np.asarray(want.loss),
                               rtol=RTOL)
