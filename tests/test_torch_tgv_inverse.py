"""The port's TGV-2 inverse solver (``solvers.tgv.tgv_inverse``,
``tgv_gap_inverse``, ``models.ct.tgv_reconstruct``) against the JAX
package's on the same seeded numpy inputs, in float64: both run the same
plain iteration, so they agree to round-off (1e-9)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytv4d_tpu.models.ct as jct
import pytv4d_tpu.solvers.tgv as jtgv
from pytv4d_tpu_torch.models import ct
from pytv4d_tpu_torch.solvers import tgv

SHAPE = (3, 2, 8, 12)
TOL = dict(rtol=1e-9, atol=1e-12)
REG = dict(alpha1=0.1, alpha0=0.2, huber_delta=0.3)


def jblur(x):
    return (x + jnp.roll(x, 1, axis=-1) + jnp.roll(x, -1, axis=-1)) / 3.0


def tblur(x):
    return (x + torch.roll(x, 1, -1) + torch.roll(x, -1, -1)) / 3.0


B = np.random.default_rng(0).random(SHAPE)


def _assert_states(tstate, jstate):
    assert tstate._fields == jstate._fields
    for name, a, b in zip(tstate._fields, tstate, jstate):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name,
                                   **TOL)


@pytest.mark.parametrize("precond", (False, True))
@pytest.mark.parametrize("norm", ("iso", "aniso", "huber"))
@pytest.mark.parametrize("axes", ("2d", "3d", "4d"))
def test_tgv_inverse_matches_jax(axes, norm, precond):
    kw = dict(n_iter=6, axes=axes, norm=norm, precond=precond, nonneg=True,
              **REG)
    if not precond:
        kw["op_norm"] = 1.0
    want = jtgv.tgv_inverse(jblur, jnp.asarray(B), SHAPE, **kw)
    got = tgv.tgv_inverse(tblur, torch.tensor(B), SHAPE, **kw)
    assert isinstance(got.state, tgv.TGVInverseState)
    assert got.x is got.state.x and got.w is got.state.w
    _assert_states(got.state, want.state)
    np.testing.assert_allclose(got.loss.numpy(), np.asarray(want.loss),
                               rtol=1e-9)
    gap_kw = dict(axes=axes, norm=norm, x_box=2.0, **REG)
    jg = jtgv.tgv_gap_inverse(want.state, jblur, jnp.asarray(B), **gap_kw)
    tg = tgv.tgv_gap_inverse(got.state, tblur, torch.tensor(B), **gap_kw)
    assert float(tg) == pytest.approx(float(jg), rel=1e-9)
    assert float(tg) >= 0.0


@pytest.mark.parametrize("fidelity", ("l1", "kl"))
def test_tgv_inverse_fidelities_weight_and_power_method(fidelity):
    """No ``op_norm``: the seeded power method; a per-measurement weight."""
    w = np.random.default_rng(1).uniform(0.5, 1.5, SHAPE)
    kw = dict(n_iter=5, fidelity=fidelity, x_init=np.full(SHAPE, 0.5), **REG)
    want = jtgv.tgv_inverse(jblur, jnp.asarray(B), SHAPE,
                            fidelity_weight=jnp.asarray(w), **kw)
    got = tgv.tgv_inverse(tblur, torch.tensor(B), SHAPE,
                          fidelity_weight=torch.tensor(w), **kw)
    _assert_states(got.state, want.state)


def test_tgv_inverse_resume():
    b = torch.tensor(B)
    kw = dict(op_norm=1.0, axes="3d", **REG)
    one = tgv.tgv_inverse(tblur, b, SHAPE, n_iter=8, **kw)
    first = tgv.tgv_inverse(tblur, b, SHAPE, n_iter=4, **kw)
    second = tgv.tgv_inverse(tblur, b, SHAPE, n_iter=4, state=first.state,
                             **kw)
    for a, c in zip(second.state, one.state):
        assert torch.equal(a, c)
    assert torch.equal(second.loss, one.loss[4:])
    # a JAX state resumes in the port; without the projections they are
    # recomputed once
    jfirst = jtgv.tgv_inverse(jblur, jnp.asarray(B), SHAPE, n_iter=4, **kw)
    want = jtgv.tgv_inverse(jblur, jnp.asarray(B), SHAPE, n_iter=4,
                            state=jfirst.state, **kw)
    fields = [torch.tensor(np.asarray(a)) for a in jfirst.state]
    for state in (fields, fields[:7]):
        got = tgv.tgv_inverse(tblur, b, SHAPE, n_iter=4, state=state, **kw)
        _assert_states(got.state, want.state)


def test_tgv_inverse_guards():
    b = torch.tensor(B)
    with pytest.raises(ValueError, match="rank-4"):
        tgv.tgv_inverse(tblur, b[0], SHAPE[1:], n_iter=1, op_norm=1.0)
    with pytest.raises(ValueError, match="norm must be"):
        tgv.tgv_inverse(tblur, b, SHAPE, n_iter=1, op_norm=1.0, norm="l3")
    with pytest.raises(ValueError, match="axes must be"):
        tgv.tgv_inverse(tblur, b, SHAPE, n_iter=1, op_norm=1.0, axes="5d")
    with pytest.raises(ValueError, match="mutually exclusive"):
        tgv.tgv_inverse(tblur, b, SHAPE, n_iter=1, op_norm=1.0, precond=True)
    with pytest.raises(ValueError, match="nonnegative coefficients"):
        tgv.tgv_inverse(lambda x: x - 2.0 * torch.roll(x, 1, -1), b, SHAPE,
                        n_iter=1, precond=True)
    with pytest.raises(ValueError, match="x_box"):
        tgv.tgv_gap_inverse(None, tblur, b)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA device"):
            tgv.tgv_inverse(tblur, B, SHAPE, n_iter=1, op_norm=1.0)
    res = tgv.tgv_inverse(tblur, B, SHAPE, n_iter=1, op_norm=1.0,
                          device="cpu")
    assert res.x.device.type == "cpu" and res.x.dtype == torch.float64


@pytest.mark.parametrize("precond", (False, True))
def test_tgv_reconstruct_matches_jax(precond):
    shape = (2, 2, 16, 16)
    angles = np.linspace(0.0, np.pi, 8, endpoint=False)
    vol = np.zeros(shape)
    vol[:, :, 4:12, 5:11] = np.linspace(0.0, 1.0, 6)  # a ramp: TGV's case
    sino = np.asarray(jct.radon(jnp.asarray(vol), angles))
    kw = dict(n_iter=8, alpha1=0.05, alpha0=0.1, nonneg=True,
              precond=precond)
    want = jct.tgv_reconstruct(jnp.asarray(sino), angles, shape,
                               method="gather", **kw)
    got = ct.tgv_reconstruct(torch.tensor(sino), angles, shape, **kw)
    assert isinstance(got, ct.CPReconResult)
    np.testing.assert_allclose(got.loss.numpy(), np.asarray(want.loss),
                               rtol=1e-9)
    _assert_states(got.state, want.state)
    for bad in (dict(fused=True), dict(dual_dtype="bfloat16"),
                dict(loss_every=2)):
        with pytest.raises(NotImplementedError, match="tgv_reconstruct"):
            ct.tgv_reconstruct(torch.tensor(sino), angles, shape, n_iter=2,
                               **bad)
