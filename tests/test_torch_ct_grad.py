"""Hyperparameter gradients through the port's CT solves against the JAX
package's ``jax.grad``: ``cp_reconstruct`` in ``reg`` and
``tgv_reconstruct`` in ``alpha1`` on the parallel, fan and cone gather
pairs and the parallel spectral pair (float64, the CPU).  The gather pairs'
transposes run, for a sinogram that requires grad, as an autograd Function
whose backward is the pair's own forward projector; any other sinogram
takes the transpose as before, bit for bit.

Tolerance: the gradients 1e-9 relative of JAX's."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytv4d_tpu.models.ct as jct
from pytv4d_tpu_torch.models import ct

SHAPE = (1, 1, 12, 12)
ANGLES = np.linspace(0.0, np.pi, 6)[:-1]
N_ITER, AT = 5, 0.05
PAIRS = {
    "parallel": (None, None, "gather"),
    "fan": (jct.FanBeamGeometry(source_dist=30.0, det_dist=10.0),
            ct.FanBeamGeometry(source_dist=30.0, det_dist=10.0), "gather"),
    "cone": (jct.ConeBeamGeometry(source_dist=30.0, det_dist=10.0),
             ct.ConeBeamGeometry(source_dist=30.0, det_dist=10.0), "gather"),
    "spectral": (None, None, "spectral"),
}
SOLVERS = {"cp": ("cp_reconstruct", "reg"),
           "tgv": ("tgv_reconstruct", "alpha1")}


def _volume():
    return np.random.default_rng(0).random(SHAPE)


@functools.lru_cache(maxsize=None)
def _sinogram(pair):
    """The JAX package's projection of the volume with the pair's
    geometry."""
    jgeom = PAIRS[pair][0]
    vol = jnp.asarray(_volume())
    if jgeom is None:
        return np.asarray(jct.radon(vol, jnp.asarray(ANGLES)))
    if isinstance(jgeom, jct.ConeBeamGeometry):
        return np.asarray(jct.radon_cone(vol, jnp.asarray(ANGLES), jgeom))
    return np.asarray(jct.radon_fan(vol, jnp.asarray(ANGLES), jgeom))


def _solve(mod, solver, pair, sino, value, geom):
    fn_name, arg = SOLVERS[solver]
    kw = {arg: value, "n_iter": N_ITER, "geom": geom,
          "method": PAIRS[pair][2]}
    if solver == "cp":
        kw["fused"] = False
    return getattr(mod, fn_name)(sino, ANGLES, SHAPE, **kw).x


@functools.lru_cache(maxsize=None)
def _jax_grad(solver, pair):
    sino = jnp.asarray(_sinogram(pair))
    return float(jax.grad(lambda v: jnp.sum(_solve(
        jct, solver, pair, sino, v, PAIRS[pair][0])))(AT))


@pytest.mark.parametrize("pair", list(PAIRS))
@pytest.mark.parametrize("solver", list(SOLVERS))
def test_gradient_matches_jax(solver, pair):
    want = _jax_grad(solver, pair)
    value = torch.tensor(AT, dtype=torch.float64, requires_grad=True)
    x = _solve(ct, solver, pair, torch.tensor(_sinogram(pair)), value,
               PAIRS[pair][1])
    (got,) = torch.autograd.grad(torch.sum(x), value)
    assert float(got) == pytest.approx(want, rel=1e-9)


def test_c4_setup_values():
    """The JAX package's gradients in the C4 setup, as ROADMAP.md records
    them (parallel beam, the gather path on the CPU)."""
    assert _jax_grad("cp", "parallel") == pytest.approx(
        3.9001711572085798, rel=1e-12)
    assert _jax_grad("tgv", "parallel") == pytest.approx(
        2.752330171748034, rel=1e-12)


def _gather_pair(pair, dtype):
    geom = PAIRS[pair][1]
    if geom is None:
        return ct.make_projector(SHAPE, ANGLES, dtype=dtype,
                                 method="gather")
    if isinstance(geom, ct.ConeBeamGeometry):
        return ct.make_cone_projector(SHAPE, ANGLES, geom, dtype=dtype)
    return ct.make_fan_projector(SHAPE, ANGLES, geom, dtype=dtype)


@pytest.mark.parametrize("dtype", (torch.float32, torch.float64))
@pytest.mark.parametrize("pair", ("parallel", "fan", "cone"))
def test_gather_transpose_float_path_is_unchanged(pair, dtype):
    """A sinogram that needs no grad, or any sinogram under ``no_grad``,
    takes the scatter itself: bit-equal results, and no graph.  One that
    requires grad gets the same values with a graph whose backward is the
    forward projector."""
    A, A_T = _gather_pair(pair, dtype)
    y = torch.as_tensor(np.random.default_rng(3).random(
        tuple(_sinogram(pair).shape)), dtype=dtype)
    got = A_T(y)
    with torch.no_grad():
        want = A_T(y)
        raw = (ct._radon_adjoint(y, ANGLES, SHAPE) if pair == "parallel"
               else ct._radon_fan_adjoint(y, ANGLES, PAIRS[pair][1], SHAPE)
               if pair == "fan"
               else ct._radon_cone_adjoint(y, ANGLES, PAIRS[pair][1], SHAPE))
        with_grad = A_T(y.clone().requires_grad_())
    assert not got.requires_grad and torch.equal(got, want)
    assert torch.equal(got, raw) and torch.equal(with_grad, raw)
    yg = y.clone().requires_grad_()
    out = A_T(yg)
    assert out.requires_grad and torch.equal(out.detach(), raw)
    x = torch.as_tensor(np.random.default_rng(4).random(SHAPE), dtype=dtype)
    (g,) = torch.autograd.grad(torch.sum(out * x), yg)
    assert torch.equal(g, A(x))
