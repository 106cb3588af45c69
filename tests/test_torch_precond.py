"""The port's diagonally-preconditioned Chambolle-Pock against the JAX
package's, in float64 on the CPU: the same seeded input through both."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytv4d_tpu.solvers.cp as jcp
from pytv4d_tpu.core.config import TVConfig as JConfig
from pytv4d_tpu_torch import interop
from pytv4d_tpu_torch.core.config import TVConfig
from pytv4d_tpu_torch.solvers import cp

SHAPE = (3, 2, 12, 16)
# float64, the same operations in the same order on both sides
RTOL = 1e-9

CASES = {
    "hybrid-time": (dict(scheme="hybrid", reg_time=0.5), {}),
    "upwind-zt": (dict(scheme="upwind", reg_time=0.7, reg_z_over_reg=0.3),
                  {}),
    "central-huber": (dict(scheme="central", reg_time=0.5, norm="huber",
                           huber_delta=0.2), {}),
    "downwind-aniso": (dict(scheme="downwind", norm="aniso"), {}),
    "hybrid-l1": (dict(scheme="hybrid", reg_time=0.5),
                  dict(fidelity="l1", fidelity_weight=0.7)),
    "hybrid-kl-nonneg": (dict(scheme="hybrid", reg_time=0.5),
                         dict(fidelity="kl", fidelity_weight=1.3,
                              nonneg=True)),
    "hybrid-sigmaA": (dict(scheme="hybrid", reg_time=0.5),
                      dict(sigma_A=0.5)),
}


def _noisy(seed=0):
    return np.random.default_rng(seed).random(SHAPE)


@pytest.mark.parametrize("case", list(CASES))
def test_precond_matches_jax(case):
    cfg_kw, kw = CASES[case]
    x0 = _noisy()
    want = jcp.chambolle_pock_precond(jnp.asarray(x0), n_iter=20, reg=0.3,
                                      cfg=JConfig(**cfg_kw), **kw)
    got = cp.chambolle_pock_precond(torch.tensor(x0), n_iter=20, reg=0.3,
                                    cfg=TVConfig(**cfg_kw), **kw)
    assert isinstance(got.state, cp.CPPrecondState)
    assert got.loss.dtype == torch.float64 and tuple(got.loss.shape) == (20,)
    np.testing.assert_allclose(got.loss.numpy(), np.asarray(want.loss),
                               rtol=RTOL)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=RTOL,
                               atol=1e-12)
    for g, w, name in zip(got.state, want.state, cp.CPPrecondState._fields):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=1e-12, err_msg=name)


def test_precond_step_matches_jax():
    cfg_kw = dict(scheme="hybrid", reg_time=0.5)
    rng = np.random.default_rng(2)
    x0 = _noisy()
    Nd = cp.num_channels("hybrid", SHAPE[0], SHAPE[1], 1.0, 0.5)
    carry = (rng.random(SHAPE), rng.random(SHAPE),
             rng.standard_normal(SHAPE),
             rng.standard_normal((SHAPE[0], Nd, SHAPE[1]) + SHAPE[2:]))
    from pytv4d_tpu.ops.operators import precond_maps as jmaps
    from pytv4d_tpu_torch.ops.operators import precond_maps

    js, jt = jmaps(SHAPE, "hybrid", 1.0, 0.5, sigma_A_rows=1.0)
    ts, tt = precond_maps(SHAPE, "hybrid", 1.0, 0.5, sigma_A_rows=1.0,
                          dtype=torch.float64, device="cpu")
    kw = dict(reg=0.3, sigma_A=1.0)
    (jx, jxb, jya, jyd), jloss = jcp.cp_step_precond(
        tuple(jnp.asarray(a) for a in carry), jnp.asarray(x0),
        sigma_D_map=js.astype(jnp.float64), tau_map=jt.astype(jnp.float64),
        cfg=JConfig(**cfg_kw), **kw)
    (tx, txb, tya, tyd), tloss = cp.cp_step_precond(
        tuple(torch.tensor(a) for a in carry), torch.tensor(x0),
        sigma_D_map=ts, tau_map=tt, cfg=TVConfig(**cfg_kw), **kw)
    for g, w in ((tx, jx), (txb, jxb), (tya, jya), (tyd, jyd)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=RTOL,
                                   atol=1e-12)
    assert float(tloss) == pytest.approx(float(jloss), rel=RTOL)


def test_precond_resume_is_exact_and_carries_across_packages():
    cfg_kw = dict(scheme="hybrid", reg_time=0.5)
    cfg = TVConfig(**cfg_kw)
    x0 = torch.tensor(_noisy(1))
    full = cp.chambolle_pock_precond(x0, n_iter=16, reg=0.3, cfg=cfg)
    a = cp.chambolle_pock_precond(x0, n_iter=7, reg=0.3, cfg=cfg)
    b = cp.chambolle_pock_precond(x0, n_iter=9, reg=0.3, cfg=cfg,
                                  state=a.state)
    assert torch.equal(b.x, full.x)
    assert torch.equal(torch.cat([a.loss, b.loss]), full.loss)
    # a plain tuple resumes too, as in the JAX package
    c = cp.chambolle_pock_precond(x0, n_iter=9, reg=0.3, cfg=cfg,
                                  state=tuple(a.state))
    assert torch.equal(c.x, full.x)
    # a JAX run resumes in the port
    jhalf = jcp.chambolle_pock_precond(jnp.asarray(x0.numpy()), n_iter=7,
                                       reg=0.3, cfg=JConfig(**cfg_kw))
    st = interop.precond_state_from_numpy(
        *(np.asarray(f) for f in jhalf.state), device="cpu")
    assert isinstance(st, cp.CPPrecondState) and st.x.dtype == torch.float64
    d = cp.chambolle_pock_precond(x0, n_iter=9, reg=0.3, cfg=cfg, state=st)
    np.testing.assert_allclose(d.loss.numpy(), full.loss[7:].numpy(),
                               rtol=RTOL)
    # and back
    jrest = jcp.chambolle_pock_precond(
        jnp.asarray(x0.numpy()), n_iter=9, reg=0.3, cfg=JConfig(**cfg_kw),
        state=jcp.CPPrecondState(*interop.state_to_numpy(a.state)))
    np.testing.assert_allclose(np.asarray(jrest.loss), full.loss[7:].numpy(),
                               rtol=RTOL)


def test_precond_validation_speaks_as_jax():
    x0 = _noisy()
    for kw in (dict(fidelity_weight=np.ones(SHAPE)),
               dict(fidelity="huber"), dict(fidelity="l1",
                                            fidelity_weight=-1.0)):
        with pytest.raises(ValueError) as want:
            jcp.chambolle_pock_precond(jnp.asarray(x0), n_iter=1, **kw)
        with pytest.raises(ValueError) as got:
            cp.chambolle_pock_precond(torch.tensor(x0), n_iter=1, **kw)
        if "fidelity_weight" in kw and "fidelity" not in kw:
            assert "SCALAR fidelity_weight" in str(got.value)
            assert "chambolle_pock_precond" in str(got.value)
        else:
            assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="nonnegative data"):
        cp.chambolle_pock_precond(torch.tensor(x0 - 0.5), n_iter=1,
                                  fidelity="kl")


def test_precond_keeps_the_input_and_float32():
    x0 = torch.tensor(_noisy(), dtype=torch.float32)
    keep = x0.clone()
    res = cp.chambolle_pock_precond(x0, n_iter=3, reg=0.3)
    assert torch.equal(x0, keep)
    assert res.x.dtype == res.loss.dtype == torch.float32
    assert all(f.dtype == torch.float32 for f in res.state)
