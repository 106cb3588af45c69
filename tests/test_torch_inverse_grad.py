"""Hyperparameter gradients through the port's unrolled inverse solvers
against the JAX package's ``jax.grad``: ``cp_inverse`` in ``reg`` (a
tensor that requires grad takes the plain step and stays a tensor) and
``tgv_inverse`` in ``alpha1``, in the setups of ``tests/test_solvers.py``;
the fused step refuses such a ``reg``, and a float ``reg`` runs as it did.

Tolerances: the gradients 1e-9 of JAX's (float64), a central finite
difference 2e-3 (its own truncation error)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytv4d_tpu.solvers as jsolvers
from pytv4d_tpu_torch.solvers import cp_inverse, tgv_inverse

SHAPE = (1, 1, 12, 12)
# jax.grad of the JAX package's solve at reg = 0.15 (float64, the CPU)
JAX_GRAD = 12.524983749292943


def _problem():
    rng = np.random.default_rng(41)
    truth = np.zeros(SHAPE)
    truth[0, 0, 3:9, 3:9] = 1.0
    return truth, truth + 0.1 * rng.standard_normal(SHAPE)


def _recon_err(reg, b, truth, **kw):
    res = cp_inverse(lambda v: v, b, SHAPE, A_T=lambda v: v, n_iter=40,
                     reg=reg, op_norm=1.0, **kw)
    return torch.sum(torch.square(res.x - truth))


def test_cp_inverse_gradient_in_reg_matches_jax():
    truth, b = _problem()

    def j_err(reg):
        res = jsolvers.cp_inverse(lambda v: v, jnp.asarray(b), SHAPE,
                                  A_T=lambda v: v, n_iter=40, reg=reg,
                                  op_norm=1.0)
        return jnp.sum(jnp.square(res.x - jnp.asarray(truth)))

    want = float(jax.grad(j_err)(0.15))
    assert want == pytest.approx(JAX_GRAD, rel=1e-12)
    tb, tt = torch.as_tensor(b), torch.as_tensor(truth)
    reg = torch.tensor(0.15, dtype=torch.float64, requires_grad=True)
    (got,) = torch.autograd.grad(_recon_err(reg, tb, tt), reg)
    assert float(got) == pytest.approx(want, rel=1e-9)
    h = 1e-4
    fd = (float(_recon_err(0.15 + h, tb, tt))
          - float(_recon_err(0.15 - h, tb, tt))) / (2 * h)
    assert float(got) == pytest.approx(fd, rel=2e-3)


def test_the_default_transpose_carries_the_gradient():
    """Without ``A_T`` the solve's transpose is ``A``'s recorded vjp; a
    ``y_A`` that requires grad gets an ``A^T y_A`` differentiable in it."""
    truth, b = _problem()
    tb, tt = torch.as_tensor(b), torch.as_tensor(truth)

    def err(reg):
        res = cp_inverse(lambda v: 2.0 * v, 2.0 * tb, SHAPE, n_iter=40,
                         reg=reg, op_norm=2.0)
        return torch.sum(torch.square(res.x - tt))

    reg = torch.tensor(0.15, dtype=torch.float64, requires_grad=True)
    (got,) = torch.autograd.grad(err(reg), reg)
    h = 1e-4
    fd = (float(err(0.15 + h)) - float(err(0.15 - h))) / (2 * h)
    assert float(got) == pytest.approx(fd, rel=2e-3)


@pytest.mark.parametrize("dtype", (torch.float32, torch.float64))
def test_a_reg_that_needs_grad_takes_the_plain_step(dtype):
    """``fused=None`` picks the plain step for it (on a float32 volume the
    fused step would serve a float reg), whose x equals the float reg's
    plain solve bit for bit; ``fused=True`` raises."""
    truth, b = _problem()
    tb = torch.as_tensor(b, dtype=dtype)
    kw = dict(A_T=lambda v: v, n_iter=10, op_norm=1.0)
    reg = torch.tensor(0.15, dtype=dtype, requires_grad=True)
    got = cp_inverse(lambda v: v, tb, SHAPE, reg=reg, **kw)
    assert got.x.requires_grad
    plain = cp_inverse(lambda v: v, tb, SHAPE, reg=0.15, fused=False, **kw)
    assert torch.equal(got.x.detach(), plain.x)
    with pytest.raises(ValueError, match="requires grad"):
        cp_inverse(lambda v: v, tb, SHAPE, reg=reg, fused=True, **kw)


@pytest.mark.parametrize("fused", (None, False))
def test_a_float_reg_runs_as_before(fused):
    """A float ``reg``, and a tensor that needs no grad, give the same
    bits on either step (float32, where ``fused=None`` takes the fused
    step), and no graph."""
    truth, b = _problem()
    tb = torch.as_tensor(b, dtype=torch.float32)
    kw = dict(A_T=lambda v: v, n_iter=10, op_norm=1.0, fused=fused)
    want = cp_inverse(lambda v: v, tb, SHAPE, reg=0.15, **kw)
    got = cp_inverse(lambda v: v, tb, SHAPE, reg=torch.tensor(0.15), **kw)
    assert not want.x.requires_grad and not got.x.requires_grad
    assert torch.equal(got.x, want.x) and torch.equal(got.loss, want.loss)
    if fused is None:
        fused_x = cp_inverse(lambda v: v, tb, SHAPE, reg=0.15,
                             **dict(kw, fused=True)).x
        assert torch.equal(want.x, fused_x)


def test_tgv_inverse_gradient_in_alpha1_matches_jax():
    rng = np.random.default_rng(2)
    shape = (1, 1, 10, 10)
    b = rng.random(shape)

    def j_f(a1):
        r = jsolvers.tgv_inverse(lambda v: v, jnp.asarray(b), shape,
                                 A_T=lambda v: v, n_iter=20, alpha1=a1,
                                 alpha0=0.2, op_norm=1.0)
        return jnp.sum(jnp.square(r.x))

    want = float(jax.grad(j_f)(0.1))
    assert want == pytest.approx(-34.86008904006, rel=1e-9)

    def f(a1):
        r = tgv_inverse(lambda v: v, torch.as_tensor(b), shape,
                        A_T=lambda v: v, n_iter=20, alpha1=a1, alpha0=0.2,
                        op_norm=1.0)
        return torch.sum(torch.square(r.x))

    a1 = torch.tensor(0.1, dtype=torch.float64, requires_grad=True)
    (got,) = torch.autograd.grad(f(a1), a1)
    assert float(got) == pytest.approx(want, rel=1e-9)
