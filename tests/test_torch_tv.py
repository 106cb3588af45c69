"""The port's TV value and subgradient (``ops.tv``, ``make_tv`` and the
reference-named ``tv_GPU`` / ``tv_operators_GPU`` modules) against the JAX
package's ``ops.tv`` on the same seeded numpy inputs."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytv4d_tpu.ops.tv as jtv
from pytv4d_tpu_torch import tv_GPU, tv_operators_GPU
from pytv4d_tpu_torch.ops import operators, tv

SCHEMES = ("upwind", "downwind", "central", "hybrid")
SHAPE = (4, 3, 16, 128)
CONFIGS = {"base": dict(), "time": dict(reg_time=0.5),
           "zt": dict(reg_time=0.7, reg_z_over_reg=0.3),
           "noz": dict(reg_z_over_reg=0.0)}
F32 = dict(atol=3e-6, rtol=1e-5)  # the JAX package's fused-vs-jnp bar
F64 = dict(atol=1e-12, rtol=1e-12)  # the same operations in f64
README_TV = 532166.8251801673  # tv_hybrid(rand(20, 4, 100, 100)), seed 0


@pytest.fixture(scope="module")
def x64():
    return np.random.default_rng(0).random(SHAPE)


def _both(x, dtype, **kw):
    """(port, jax) results of tv_and_subgrad on x as ``dtype``."""
    t = tv.tv_and_subgrad(torch.tensor(x, dtype=dtype), **kw)
    jdt = jnp.float32 if dtype == torch.float32 else jnp.float64
    j = jtv.tv_and_subgrad(jnp.asarray(x, jdt), **kw)
    return t, j


def _check(t, j, tol, tv_rel):
    assert float(t[0]) == pytest.approx(float(j[0]), rel=tv_rel)
    for a, b in zip(t[1:], j[1:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **tol)


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("config", list(CONFIGS))
def test_tv_and_subgrad_matches_jax(x64, scheme, config):
    kw = dict(scheme=scheme, **CONFIGS[config])
    _check(*_both(x64, torch.float32, **kw), F32, 1e-6)
    _check(*_both(x64, torch.float64, **kw), F64, 1e-12)


@pytest.mark.parametrize("norm", ["iso", "aniso", "huber"])
def test_norm_types_and_grad_norms(x64, norm):
    kw = dict(scheme="central", reg_time=0.5, norm_type=norm, huber_delta=0.3,
              return_grad_norms=True)
    t, j = _both(x64, torch.float64, **kw)
    assert len(t) == 3
    _check(t, j, F64, 1e-12)
    _check(*_both(x64, torch.float32, **kw), F32, 1e-6)
    if norm == "iso":  # the reference's +inf at zero norm (the corners)
        assert bool(torch.isinf(t[2]).any())


def test_mask_kwarg(x64):
    mask = np.random.default_rng(1).random(SHAPE) < 0.7
    t, j = _both(x64, torch.float64, scheme="hybrid", reg_time=0.5,
                 mask=mask)
    _check(t, j, F64, 1e-12)
    zeroed = tv.tv_and_subgrad(torch.tensor(np.where(mask, x64, 0.0)),
                               "hybrid", reg_time=0.5)
    assert float(t[0]) == float(zeroed[0])


@pytest.mark.parametrize("norm", ["iso", "aniso", "huber"])
def test_plane_mask_static_weight_time(x64, norm):
    rng = np.random.default_rng(2)
    mask = rng.random((1, 1) + SHAPE[2:]) < 0.5
    wt = 0.5 + rng.random((1, 1) + SHAPE[2:])
    for ms, w in ((mask, None), (False, wt), (mask, wt)):
        kw = dict(scheme="hybrid", reg_time=0.7, factor_reg_static=0.3,
                  norm_type=norm, mask_static=ms)
        t = tv.tv_and_subgrad(torch.tensor(x64), weight_time=(
            None if w is None else torch.tensor(w)), **kw)
        j = jtv.tv_and_subgrad(jnp.asarray(x64), weight_time=(
            None if w is None else jnp.asarray(w)), **kw)
        _check(t, j, F64, 1e-12)


def test_flat_image_zero_subgradient():
    for norm in ("iso", "aniso", "huber"):
        tv_val, G = tv.tv_and_subgrad(torch.full(SHAPE, 3.0), "hybrid",
                                      reg_time=1.0, norm_type=norm)
        assert float(tv_val) == 0.0
        assert bool((G == 0).all()) and not bool(torch.isnan(G).any())


def test_make_tv_gradient_matches_jax():
    """make_tv's backward is grad_out * G: 0 at zero-gradient pixels where
    autograd of the L2,1 norm would give NaN."""
    x = np.random.default_rng(3).random(SHAPE)
    x[:, :, 4:9, 20:40] = 0.5  # a flat patch: zero-norm pixels inside
    img = torch.tensor(x, requires_grad=True)
    fn = tv.make_tv("hybrid", 1.0, 0.5)
    value = fn(img)
    (g,) = torch.autograd.grad(3.0 * value, img)
    jfn = jtv.make_tv("hybrid", 1.0, 0.5)
    jg = jax.grad(lambda a: 3.0 * jfn(a))(jnp.asarray(x))
    assert float(value.detach()) == pytest.approx(
        float(jfn(jnp.asarray(x))), rel=1e-12)
    assert not bool(torch.isnan(g).any())
    assert float(g[1, 1, 6, 30]) == 0.0
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), **F64)
    assert tv.make_tv("hybrid", 1.0, 0.5) is fn


def test_tv_GPU_readme_value_on_cpu_tensor():
    """The README value in f64 through tv_GPU.tv_hybrid on a CPU tensor:
    tensor in, tensors out on the same device."""
    np.random.seed(0)
    img = torch.tensor(np.random.rand(20, 4, 100, 100))
    tv_val, G, norms = tv_GPU.tv_hybrid(img, return_grad_norms=True)
    assert isinstance(G, torch.Tensor) and G.device == img.device
    assert G.dtype == torch.float64 and norms.shape == img.shape
    assert float(tv_val) == pytest.approx(README_TV, rel=1e-12)
    ref = tv.tv_hybrid(img)
    assert torch.equal(G, ref[1])


def test_tv_GPU_numpy_input_goes_to_cuda():
    """A numpy input runs on the GPU and comes back as numpy; where there is
    no GPU it raises instead of running on the CPU."""
    np.random.seed(0)
    img = np.random.rand(2, 3, 20, 24)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            tv_GPU.tv_upwind(img)
        with pytest.raises(RuntimeError, match="CUDA"):
            tv_operators_GPU.D_upwind(img)
        return
    tv_val, G = tv_GPU.tv_upwind(img)
    assert isinstance(tv_val, float) and isinstance(G, np.ndarray)


def test_tv_operators_GPU_on_cpu_tensor():
    x = torch.tensor(np.random.default_rng(4).random(SHAPE))
    D_img = tv_operators_GPU.D_hybrid(x, reg_time=0.5, mask_static=False)
    assert torch.equal(D_img, operators.D(x, "hybrid", reg_time=0.5))
    assert torch.equal(tv_operators_GPU.D_T_hybrid(D_img, reg_time=0.5),
                       operators.D_T(D_img, "hybrid", reg_time=0.5))
    l21, arr = tv_operators_GPU.compute_L21_norm(D_img, return_array=True)
    assert isinstance(l21, torch.Tensor) and arr.shape == SHAPE
    with pytest.raises(TypeError, match="unexpected"):
        tv_operators_GPU.D_hybrid(x, nope=1)
    like = tv_operators_GPU.type_like(np.ones(3), torch.zeros(1))
    assert isinstance(like, torch.Tensor) and like.dtype == torch.float32
    back = tv_operators_GPU.type_like(torch.ones(3), np.zeros(1, np.float64))
    assert isinstance(back, np.ndarray) and back.dtype == np.float64
