"""The port's pass A for inverse problems (kernel B5 through its wrapper,
which takes the plain PyTorch version for CPU tensors) against the JAX
package's ``make_tv_dual_kernel``, whose Pallas kernel runs in the
interpreter on the CPU; and pass B (B2) writing out of place."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytv4d_tpu.core.config import TVConfig as JConfig
from pytv4d_tpu.kernels import fused as jfused
from pytv4d_tpu_torch.core.config import TVConfig
from pytv4d_tpu_torch.core.schemes import num_channels
from pytv4d_tpu_torch.kernels import fused
from pytv4d_tpu_torch.utils import profiling

SCHEMES = ("upwind", "downwind", "central", "hybrid")
NORMS = ("iso", "aniso", "huber")
SHAPE = (4, 3, 16, 128)
# the JAX package's fused-vs-jnp bar: both sides compute the same f32
# expression per voxel and differ by the order of a few additions
TOL = dict(atol=2e-6, rtol=1e-5)
# a bf16 dual: both sides compute the f32 value within TOL and round it to
# bf16 where they store, so a value near a rounding midpoint may land one
# bf16 ulp (2^-7 relative) apart; at most 1% of the elements may
BF16_TOL = dict(atol=2e-6, rtol=2.0 ** -7)
SIGMA_D, REG = 0.4, 0.5


def _inputs(cfg, dual_dtype, seed):
    rng = np.random.default_rng(seed)
    x_bar = rng.standard_normal(SHAPE).astype(np.float32)
    Nd = num_channels(cfg.scheme, SHAPE[0], SHAPE[1], cfg.reg_z_over_reg,
                      cfg.reg_time)
    y_D = rng.uniform(-1, 1, (SHAPE[0], SHAPE[1], Nd) + SHAPE[2:]).astype(
        np.float32)
    if dual_dtype == "bfloat16":  # both packages start from the same bf16
        y_D = torch.tensor(y_D).bfloat16().float().numpy()
    return x_bar, y_D


@pytest.mark.parametrize("dual_dtype", ("float32", "bfloat16"))
@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("scheme", SCHEMES)
def test_tv_dual_matches_jax_kernel(scheme, norm, dual_dtype):
    cfg_kw = dict(scheme=scheme, norm=norm, reg_time=0.5, reg_z_over_reg=0.6,
                  huber_delta=0.3)
    cfg = TVConfig(**cfg_kw)
    x_bar, y_D = _inputs(cfg, dual_dtype, seed=5)

    kernel = jfused.make_tv_dual_kernel(
        JConfig(**cfg_kw), SHAPE, "float32", SIGMA_D, REG, True,
        dual_dtype_name=dual_dtype)
    j_yD, _dt_local, j_parts = kernel(
        jnp.asarray(x_bar), jnp.asarray(y_D, jnp.dtype(dual_dtype)))

    t_dual = torch.tensor(y_D).to(getattr(torch, dual_dtype))
    before = profiling.counters()
    t_yD, t_parts = fused.tv_dual(torch.tensor(x_bar), t_dual, cfg=cfg,
                                  sigma_D=SIGMA_D, reg=REG)
    assert profiling.counters() == before  # no kernel on the CPU
    assert t_yD is t_dual and t_yD.dtype == getattr(torch, dual_dtype)

    got = t_yD.float().numpy()
    want = np.asarray(j_yD.astype(jnp.float32))
    if dual_dtype == "bfloat16":
        np.testing.assert_allclose(got, want, **BF16_TOL)
        beyond = np.abs(got - want) > TOL["atol"] + TOL["rtol"] * np.abs(want)
        assert beyond.mean() <= 0.01  # such flips are rare
    else:
        np.testing.assert_allclose(got, want, **TOL)
    assert t_parts.dtype == torch.float32
    assert float(t_parts.sum()) == pytest.approx(
        float(jfused._sum_parts(j_parts)), rel=1e-5)


@pytest.mark.parametrize("norm", NORMS)
def test_tv_dual_is_the_tv_half_of_cp_dual(norm):
    """The same y_D' and TV partial as pass A of the denoising step (B1)."""
    cfg = TVConfig(scheme="hybrid", norm=norm, reg_time=0.5, huber_delta=0.3)
    x_bar, y_D = _inputs(cfg, "float32", seed=6)
    x = torch.tensor(x_bar)
    a, b = torch.tensor(y_D), torch.tensor(y_D)
    _, tv_a = fused.tv_dual(x, a, cfg=cfg, sigma_D=SIGMA_D, reg=REG)
    _, _, tv_b = fused.cp_dual(x, x.clone(), torch.zeros_like(x), b, cfg=cfg,
                               sigma_D=SIGMA_D, sigma_A=1.0, reg=REG)
    assert torch.equal(a, b) and torch.equal(tv_a, tv_b)


@pytest.mark.parametrize("nonneg", (False, True))
@pytest.mark.parametrize("dtype", (torch.float32, torch.bfloat16))
def test_cp_primal_out_of_place_equals_in_place(dtype, nonneg):
    cfg = TVConfig(scheme="hybrid", reg_time=0.5)
    x_bar, y_D = _inputs(cfg, "float32", seed=7)
    rng = np.random.default_rng(8)
    x = torch.tensor(x_bar).to(dtype)
    at = torch.tensor(rng.standard_normal(SHAPE).astype(np.float32)).to(dtype)
    y = torch.tensor(y_D).to(dtype)
    kw = dict(cfg=cfg, tau=0.1, nonneg=nonneg)
    x_before, out = x.clone(), torch.full_like(x, float("nan"))
    # the inverse solver's call: x in the x0 slot, A^T y_A in the y_A slot
    got, _ = fused.cp_primal(x, x, at, y, out=out, **kw)
    assert got is out and torch.equal(x, x_before)
    in_place, _ = fused.cp_primal(x.clone(), x, at, y, **kw)
    assert torch.equal(out, in_place)
    if nonneg:
        assert float(out.float().min()) >= 0.0


def test_wrapper_checks():
    cfg = TVConfig(scheme="hybrid")
    x = torch.zeros(SHAPE)
    y_D = torch.zeros((SHAPE[0], SHAPE[1], 6) + SHAPE[2:])
    kw = dict(cfg=cfg, sigma_D=0.5, reg=1.0)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fused.tv_dual(x.double(), y_D, **kw)
    with pytest.raises(ValueError, match="y_D must be"):
        fused.tv_dual(x, y_D[:, :, :4].contiguous(), **kw)
    with pytest.raises(ValueError, match="contiguous"):
        fused.tv_dual(x, y_D.transpose(1, 2), **kw)
    with pytest.raises(TypeError, match="torch.Tensor"):
        fused.tv_dual(x.numpy(), y_D, **kw)
    with pytest.raises(ValueError, match="out must match"):
        fused.cp_primal(x, x, x, y_D, cfg=cfg, tau=0.1, out=x.bfloat16())
    with pytest.raises(ValueError, match="contiguous"):
        fused.cp_primal(x, x, x, y_D, cfg=cfg, tau=0.1,
                        out=torch.zeros(SHAPE[:2] + SHAPE[:1:-1]).transpose(
                            2, 3))
