"""The port's TGV-2 denoising solver against the JAX package's jnp path in
f64 on the CPU: every mode and norm, the loss options, resume (also from a
state the JAX package made), the hand-written adjoints, the error messages,
the ramp experiment and the cameraman reference value."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytv4d_tpu.solvers.tgv as jtgv
from pytv4d_tpu_torch import interop
from pytv4d_tpu_torch.models import TVDenoiser, add_noise
from pytv4d_tpu_torch.solvers import tgv
from pytv4d_tpu_torch.utils import cameraman, has_real_cameraman

SHAPES = [(3, 2, 16, 16), (2, 2, 12, 20)]
MODES = ["2d", "3d", "4d"]
NORMS = ["iso", "aniso", "huber"]
KW = dict(alpha1=2.0, alpha0=4.0, huber_delta=0.3)
TOL = dict(rtol=1e-10, atol=1e-12)
# TVDenoiser(reg=25).tgv(add_noise(cameraman(), 100, seed=0), 300), final
# loss of the JAX package in f64 on the CPU
CAMERAMAN_TGV = 37211904.16116732


def _volume(shape, seed=0):
    return np.random.default_rng(seed).random(shape)


def _assert_state(got, ref):
    for name, a, b in zip(tgv.TGVState._fields, got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name,
                                   **TOL)


@pytest.mark.parametrize("shape", SHAPES, ids=["16x16", "12x20"])
@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("axes", MODES)
def test_tgv_denoise_matches_jax(axes, norm, shape):
    """20 iterations of the plain loop: x, w, the full state and the loss
    history against ``tgv_denoise(fused=False)`` of the JAX package."""
    x = _volume(shape)
    j = jtgv.tgv_denoise(jnp.asarray(x), n_iter=20, axes=axes, norm=norm,
                         fused=False, **KW)
    t = tgv.tgv_denoise(torch.tensor(x), n_iter=20, axes=axes, norm=norm,
                        **KW)
    assert t.x.dtype == torch.float64 and t.loss.shape == (20,)
    np.testing.assert_allclose(t.x.numpy(), np.asarray(j.x), **TOL)
    np.testing.assert_allclose(t.w.numpy(), np.asarray(j.w), **TOL)
    _assert_state(t.state, j.state)
    np.testing.assert_allclose(t.loss.numpy(), np.asarray(j.loss), rtol=1e-10)


@pytest.mark.parametrize("axes", MODES)
def test_compute_loss_false_and_loss_every(axes):
    """``compute_loss=False`` gives the same iterates and a (0,) loss;
    ``loss_every=k`` samples ``loss[k-1::k]``; both equal the JAX package."""
    x = torch.tensor(_volume(SHAPES[0], 3))
    full = tgv.tgv_denoise(x, n_iter=20, axes=axes, **KW)
    lean = tgv.tgv_denoise(x, n_iter=20, axes=axes, compute_loss=False, **KW)
    assert torch.equal(full.x, lean.x) and torch.equal(full.w, lean.w)
    assert lean.loss.shape == (0,)
    for k in (5, 20):
        sampled = tgv.tgv_denoise(x, n_iter=20, axes=axes, loss_every=k, **KW)
        assert torch.equal(sampled.x, full.x)
        assert torch.equal(sampled.loss, full.loss[k - 1::k])
    j = jtgv.tgv_denoise(jnp.asarray(x.numpy()), n_iter=20, axes=axes,
                         loss_every=5, fused=False, **KW)
    sampled = tgv.tgv_denoise(x, n_iter=20, axes=axes, loss_every=5, **KW)
    np.testing.assert_allclose(sampled.loss.numpy(), np.asarray(j.loss),
                               rtol=1e-10)


@pytest.mark.parametrize("source", ["port", "jax"])
@pytest.mark.parametrize("axes", MODES)
def test_resume_from_state(axes, source):
    """10 + 10 iterations equal 20, from the port's own state and from a
    state made by the JAX package and carried over as numpy."""
    x = _volume(SHAPES[1], 5)
    xt = torch.tensor(x)
    full = tgv.tgv_denoise(xt, n_iter=20, axes=axes, norm="huber", **KW)
    if source == "port":
        st = tgv.tgv_denoise(xt, n_iter=10, axes=axes, norm="huber",
                             **KW).state
    else:
        j10 = jtgv.tgv_denoise(jnp.asarray(x), n_iter=10, axes=axes,
                               norm="huber", fused=False, **KW)
        st = interop.tgv_state_from_numpy(
            *(np.asarray(a) for a in j10.state), device="cpu")
        assert isinstance(st, tgv.TGVState) and st.q.dtype == torch.float64
    before = [t.clone() for t in st]
    rest = tgv.tgv_denoise(xt, n_iter=10, axes=axes, norm="huber", state=st,
                           **KW)
    assert all(torch.equal(a, b) for a, b in zip(st, before))
    _assert_state(rest.state, full.state)
    np.testing.assert_allclose(rest.loss.numpy(), full.loss.numpy()[10:],
                               rtol=1e-10)
    for a, b in zip(interop.state_to_numpy(rest.state), full.state):
        np.testing.assert_allclose(a, b.numpy(), **TOL)


@pytest.mark.parametrize("shape", [(3, 2, 5, 7), (1, 1, 6, 2), (2, 1, 1, 4)],
                         ids=["3x2x5x7", "Nz1M1", "Nr1"])
@pytest.mark.parametrize("axes", MODES)
def test_adjointness(axes, shape):
    """<D x, p> = <x, D^T p> and <E w, q> = <w, E^T q> in f64 to 1e-12,
    also where an axis has one or two slots."""
    d_fwd, sym_grad, d_T, sym_T, n_w, n_q, _ = tgv._tgv_ops(axes)
    rng = np.random.default_rng(2)
    Nz, M, Nr, Nc = shape
    x = torch.tensor(rng.standard_normal(shape))
    p = torch.tensor(rng.standard_normal((Nz, n_w, M, Nr, Nc)))
    w = torch.tensor(rng.standard_normal((Nz, n_w, M, Nr, Nc)))
    q = torch.tensor(rng.standard_normal((Nz, n_q, M, Nr, Nc)))
    for lhs, rhs in ((torch.sum(d_fwd(x) * p), torch.sum(x * d_T(p))),
                     (torch.sum(sym_grad(w) * q), torch.sum(w * sym_T(q)))):
        scale = max(abs(float(lhs)), 1.0)
        assert abs(float(lhs) - float(rhs)) / scale < 1e-12


@pytest.mark.parametrize("axes", MODES)
def test_operators_match_jax(axes):
    """D and E (channel order of ``_q_pairs``) and the hand-written adjoints
    against the JAX package's operators and ``jax.linear_transpose``."""
    d_fwd, sym_grad, d_T, sym_T, n_w, n_q, L_sq = tgv._tgv_ops(axes)
    shape = (3, 2, 5, 6)
    jd, js, jdT, jsT, jn_w, jn_q, jL = jtgv._tgv_ops(axes, shape, jnp.float64)
    assert (n_w, n_q, L_sq) == (jn_w, jn_q, jL)
    assert tgv.TGV_FIELDS == jtgv.TGV_FIELDS
    assert tgv.TGV_NORM_BOUND_SQ == jtgv.TGV_NORM_BOUND_SQ
    rng = np.random.default_rng(4)
    x = rng.standard_normal(shape)
    w = rng.standard_normal((3, n_w, 2, 5, 6))
    q = rng.standard_normal((3, n_q, 2, 5, 6))
    T = torch.tensor
    # the JAX package's operator names, for the same modes
    suffix = {"2d": "", "3d": "3", "4d": "4"}[axes]
    assert torch.equal(getattr(tgv, "_d_fwd" + suffix)(T(x)), d_fwd(T(x)))
    assert torch.equal(getattr(tgv, "_sym_grad" + suffix)(T(w)),
                       sym_grad(T(w)))
    np.testing.assert_allclose(d_fwd(T(x)).numpy(), np.asarray(jd(x)),
                               rtol=0, atol=0)
    np.testing.assert_allclose(sym_grad(T(w)).numpy(), np.asarray(js(w)),
                               rtol=0, atol=1e-15)
    np.testing.assert_allclose(d_T(T(w)).numpy(), np.asarray(jdT(w)),
                               rtol=0, atol=1e-14)
    np.testing.assert_allclose(sym_T(T(q)).numpy(), np.asarray(jsT(q)),
                               rtol=0, atol=1e-14)


def test_error_messages():
    x = torch.tensor(_volume((2, 2, 8, 8)))
    with pytest.raises(ValueError, match="rank-4"):
        tgv.tgv_denoise(x[0, 0])
    with pytest.raises(ValueError, match="rank-4"):
        tgv.tgv_denoise(np.zeros((8, 8)))
    with pytest.raises(TypeError, match="torch.Tensor"):
        tgv.tgv_denoise(np.zeros((2, 2, 8, 8)))
    with pytest.raises(ValueError, match="'2d', '3d' or '4d'"):
        tgv.tgv_denoise(x, n_iter=2, axes="5d")
    with pytest.raises(ValueError, match="'iso', 'aniso' or 'huber'"):
        tgv.tgv_denoise(x, n_iter=2, norm="bogus")
    with pytest.raises(ValueError, match="positive divisor of n_iter"):
        tgv.tgv_denoise(x, n_iter=20, loss_every=3)
    with pytest.raises(ValueError, match="positive divisor of n_iter"):
        tgv.tgv_denoise(x, n_iter=20, loss_every=-5)
    # fused=True for a coupled mode with the per-iteration loss raised here
    # in the JAX package's rule; the port streams it with the objective
    # kernel (its plain version on the CPU), the plain loop's losses
    fus = tgv.tgv_denoise(x, n_iter=5, axes="3d", fused=True)
    ref = tgv.tgv_denoise(x, n_iter=5, axes="3d", fused=False)
    np.testing.assert_allclose(fus.loss.numpy(), ref.loss.numpy(),
                               rtol=1e-12)


def test_tgv_fixes_staircasing():
    """The ramp experiment of the JAX package's tests at its own size: on
    piecewise-linear content TGV recovers the slope and beats first-order
    TV's staircased RMSE; 2D in gives 2D out."""
    rng = np.random.default_rng(0)
    rng.random((2, 2, 3, 16, 16)), rng.random((2, 3, 3, 16, 16))  # as there
    N = 64
    ramp = np.linspace(0, 100, N)[None, :] * np.ones((N, 1))
    noisy = torch.tensor(ramp + 10 * rng.standard_normal((N, N)))
    tv = TVDenoiser(reg=8.0).cp(noisy, n_iter=400)
    res = TVDenoiser(reg=8.0).tgv(noisy, n_iter=800)
    err_tv = float(np.sqrt(np.mean((tv.x.numpy() - ramp) ** 2)))
    err_tgv = float(np.sqrt(np.mean((res.x.numpy() - ramp) ** 2)))
    assert err_tgv < err_tv < 10.0, (err_tgv, err_tv)
    assert err_tgv < 2.0
    assert float(res.loss[-1]) < 0.5 * float(res.loss[0])
    assert res.x.shape == noisy.shape


def test_denoiser_tgv_ranks_and_alpha0():
    x = _volume((3, 2, 8, 10), 6)
    model = TVDenoiser(reg=2.0)
    assert model.tgv(x[0, 0], n_iter=3, device="cpu").x.shape == (8, 10)
    assert model.tgv(torch.tensor(x[:, 0]), n_iter=3).x.shape == (3, 8, 10)
    four = model.tgv(torch.tensor(x), n_iter=3, axes="3d")
    direct = tgv.tgv_denoise(torch.tensor(x), n_iter=3, alpha1=2.0,
                             alpha0=4.0, axes="3d")
    assert four.x.shape == x.shape and torch.equal(four.x, direct.x)
    other = model.tgv(torch.tensor(x), n_iter=3, alpha0=3.0)
    direct = tgv.tgv_denoise(torch.tensor(x), n_iter=3, alpha1=2.0,
                             alpha0=3.0)
    assert torch.equal(other.x, direct.x)


def test_cameraman_tgv_reference_value():
    """cameraman, noise 100, seed 0, reg 25 (alpha0 50), 300 iterations in
    f64 -> the JAX package's value."""
    assert has_real_cameraman()
    noisy = torch.tensor(add_noise(cameraman(), 100, seed=0))
    threads = torch.get_num_threads()
    torch.set_num_threads(1)  # see tests/test_torch_gd.py
    try:
        res = TVDenoiser(reg=25).tgv(noisy, n_iter=300)
    finally:
        torch.set_num_threads(threads)
    assert res.x.shape == (256, 256) and res.loss.shape == (300,)
    assert float(res.loss[-1]) == pytest.approx(CAMERAMAN_TGV, rel=1e-9)
    assert float(res.loss[-1]) < 0.5 * float(res.loss[0])
    # one rise, at iteration 9; monotone from there on
    assert bool((res.loss[11:] <= res.loss[10:-1]).all())
