"""The port's fused TV value and subgradient (kernels B3/B4 through their
wrappers, which take the plain PyTorch versions for CPU tensors) against the
JAX package's ``tv_and_subgrad_fused``, whose Pallas kernels run in the
interpreter on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytv4d_tpu.core.config import TVConfig as JConfig
from pytv4d_tpu.kernels import fused as jfused
from pytv4d_tpu.kernels.dispatch import t_plane_multiplier as j_tmul
from pytv4d_tpu_torch.core.config import TVConfig
from pytv4d_tpu_torch.kernels import fused
from pytv4d_tpu_torch.utils import device_time, profiling, tv_traffic_model

SCHEMES = ("upwind", "downwind", "central", "hybrid")
SHAPE = (4, 3, 16, 128)
CONFIGS = {"base": dict(), "time": dict(reg_time=0.5),
           "zt": dict(reg_time=0.7, reg_z_over_reg=0.3),
           "noz": dict(reg_z_over_reg=0.0)}
HYB = dict(scheme="hybrid", reg_time=0.5)
F32 = dict(atol=3e-6, rtol=1e-5)     # the JAX fused-vs-jnp bar
TMUL = dict(atol=5e-6, rtol=1e-4)    # its bar with a tmul plane
BF16_RTOL = 2.0 ** -7                # one bf16 ulp
BF16_MAX_FLIPPED = 0.01


def _cases():
    """(id, config kwargs, tmul, storage): the case matrix of chip_smoke.py's
    GD kernel phase."""
    for scheme in SCHEMES:
        for name, kw in CONFIGS.items():
            yield f"{scheme}-{name}", dict(scheme=scheme, **kw), False, "f32"
    for norm in ("aniso", "huber"):
        for scheme in ("hybrid", "central"):
            yield (f"{scheme}-time-{norm}", dict(scheme=scheme, reg_time=0.5,
                                                norm=norm, huber_delta=0.3),
                   False, "f32")
    for norm in ("iso", "aniso", "huber"):
        yield (f"hybrid-time-tmul-{norm}", dict(norm=norm, huber_delta=0.3,
                                                factor_reg_static=0.3, **HYB),
               True, "f32")
    for scheme in SCHEMES:
        yield (f"{scheme}-zt-bf16", dict(scheme=scheme, **CONFIGS["zt"]),
               False, "bf16")
    yield "hybrid-time-tmul-bf16", dict(factor_reg_static=0.3, **HYB), True, \
        "bf16"


CASES = list(_cases())


def _tmul():
    """A static mask and a weight_time plane composed by the JAX package's
    ``t_plane_multiplier``, as ``tests/test_fused_features.py`` makes them."""
    mask = np.zeros((1, 1) + SHAPE[2:], bool)
    mask[0, 0, 4:10, 30:90] = True
    wt = 0.5 + np.random.default_rng(4).random((1, 1) + SHAPE[2:])
    tm = j_tmul(SHAPE, JConfig(factor_reg_static=0.3, **HYB), mask,
                jnp.asarray(wt, jnp.float32))
    return np.asarray(tm, np.float32)


def _bf16_close(got, ref):
    """Within the f32 bar plus one bf16 ulp, and at most 1% of elements
    beyond the f32 bar (rounding flips near a bf16 midpoint)."""
    got = got.float().numpy()
    ref = np.asarray(ref, np.float32)
    err = np.abs(got - ref)
    f32_bar = F32["atol"] + F32["rtol"] * np.abs(ref)
    assert (err <= f32_bar + BF16_RTOL * np.abs(ref)).all()
    assert (err > f32_bar).mean() <= BF16_MAX_FLIPPED


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_tv_and_subgrad_fused_matches_jax(case):
    _, cfg_kw, use_tmul, storage = case
    x = np.random.default_rng(0).random(SHAPE).astype(np.float32)
    tm = _tmul() if use_tmul else None
    jx = jnp.asarray(x)
    tx = torch.tensor(x)
    if storage == "bf16":
        jx, tx = jx.astype(jnp.bfloat16), tx.to(torch.bfloat16)
    jtv, jG, jn = jfused.tv_and_subgrad_fused(
        jx, JConfig(**cfg_kw), interpret=True, return_grad_norms=True,
        tmul=None if tm is None else jnp.asarray(tm))
    ttv, tG, tn = fused.tv_and_subgrad_fused(
        tx, TVConfig(**cfg_kw), return_grad_norms=True,
        tmul=None if tm is None else torch.tensor(tm))

    assert ttv.dtype == torch.float32 and tn.dtype == torch.float32
    assert tG.dtype == tx.dtype and tG.shape == SHAPE
    tol = TMUL if use_tmul else F32
    assert float(ttv) == pytest.approx(float(jtv),
                                       rel=1e-5 if use_tmul else 1e-6)
    np.testing.assert_array_equal(np.isinf(tn.numpy()), np.isinf(jn))
    finite = np.isfinite(np.asarray(jn))
    np.testing.assert_allclose(tn.numpy()[finite], np.asarray(jn)[finite],
                               **tol)
    if storage == "bf16":
        _bf16_close(tG, jG.astype(jnp.float32))
        f32_tv = fused.tv_and_subgrad_fused(
            torch.tensor(x), TVConfig(**cfg_kw),
            tmul=None if tm is None else torch.tensor(tm))[0]
        assert float(ttv) == pytest.approx(float(f32_tv), rel=2e-2)
    else:
        np.testing.assert_allclose(tG.numpy(), np.asarray(jG), **tol)


def test_flat_image_inf_convention():
    x = torch.full(SHAPE, 3.0)
    tv_val, G, norms = fused.tv_and_subgrad_fused(
        x, TVConfig(scheme="hybrid", reg_time=1.0), return_grad_norms=True)
    assert float(tv_val) == 0.0 and bool((G == 0).all())
    assert bool(torch.isinf(norms).all())


def test_aniso_subgradient_reads_no_norms():
    cfg = TVConfig(norm="aniso", **HYB)
    x = torch.tensor(np.random.default_rng(1).random(SHAPE),
                     dtype=torch.float32)
    norms, _ = fused.tv_norms(x, cfg=cfg)
    assert torch.equal(fused.tv_subgrad(x, torch.zeros(SHAPE), cfg=cfg),
                       fused.tv_subgrad(x, norms, cfg=cfg))


def test_wrapper_checks():
    cfg = TVConfig(**HYB)
    x = torch.zeros(SHAPE)
    norms = torch.ones(SHAPE)
    with pytest.raises(ValueError, match="contiguous"):
        fused.tv_norms(x.transpose(2, 3), cfg=cfg)
    with pytest.raises(ValueError, match="contiguous"):
        fused.tv_subgrad(x, norms.transpose(0, 1), cfg=cfg)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fused.tv_norms(x.double(), cfg=cfg)
    with pytest.raises(ValueError, match="Nz, M, Nr, Nc"):
        fused.tv_norms(x[0], cfg=cfg)
    with pytest.raises(ValueError, match="norms must be float32"):
        fused.tv_subgrad(x, norms.double(), cfg=cfg)
    with pytest.raises(ValueError, match="norms must be float32"):
        fused.tv_subgrad(x, norms[:2].contiguous(), cfg=cfg)
    with pytest.raises(TypeError, match="norms"):
        fused.tv_subgrad(x, None, cfg=cfg)
    with pytest.raises(ValueError, match="tmul"):
        fused.tv_norms(x, torch.ones(3, 3), cfg=cfg)
    with pytest.raises(ValueError, match="tmul"):
        fused.tv_subgrad(x, norms, torch.ones(SHAPE[2:]).double(), cfg=cfg)
    with pytest.raises(ValueError, match="fits_kernel"):
        fused.tv_norms(torch.zeros(300, 300, 2, 2), cfg=cfg)


def test_launch_counters_stay_on_cpu():
    before = profiling.counters()
    fused.tv_and_subgrad_fused(torch.rand(SHAPE), TVConfig(**HYB))
    assert profiling.counters() == before


def test_tv_traffic_model():
    vox = int(np.prod(SHAPE))
    assert tv_traffic_model(SHAPE) == (8 * vox, 12 * vox)
    assert tv_traffic_model(SHAPE, torch.bfloat16) == (6 * vox, 8 * vox)
    assert tv_traffic_model(SHAPE, norm="aniso") == (8 * vox, 8 * vox)


def test_device_time_needs_cuda():
    with pytest.raises(ValueError, match="CUDA"):
        device_time(lambda: None, 1, "cpu")
