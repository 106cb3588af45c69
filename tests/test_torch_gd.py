"""The port's subgradient-descent solver end to end: against the JAX
package's solver on both paths, the README cameraman value, the denoiser's
rank round trip, bf16 storage, progress reports, and the public
``ops.api.tv_and_subgrad`` on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytv4d_tpu.solvers.gd as jgd
from pytv4d_tpu.core.config import TVConfig as JConfig
from pytv4d_tpu_torch.core.config import TVConfig
from pytv4d_tpu_torch.models import TVDenoiser, add_noise
from pytv4d_tpu_torch.ops import api, tv
from pytv4d_tpu_torch.solvers import gd
from pytv4d_tpu_torch.utils import cameraman, has_real_cameraman

SHAPE = (4, 3, 16, 128)
CAMERAMAN_GD = 39074939.776927  # BASELINE.md, f64 reference
VARIANTS = {
    "iso": dict(cfg=dict(scheme="hybrid", reg_time=0.5), planes=False),
    "aniso": dict(cfg=dict(scheme="central", reg_time=0.5, norm="aniso"),
                  planes=False),
    "huber": dict(cfg=dict(scheme="upwind", reg_time=0.5, norm="huber",
                           huber_delta=0.3), planes=False),
    "tmul": dict(cfg=dict(scheme="hybrid", reg_time=0.7,
                          factor_reg_static=0.3), planes=True),
}


@pytest.fixture(scope="module")
def x0():
    return np.random.default_rng(0).random(SHAPE).astype(np.float32)


def _planes():
    rng = np.random.default_rng(5)
    mask = rng.random((1, 1) + SHAPE[2:]) < 0.5
    wt = (0.5 + rng.random((1, 1) + SHAPE[2:])).astype(np.float32)
    return mask, wt


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_subgradient_descent_matches_jax(x0, variant, fused):
    """20 iterations, loss rtol 1e-4 and x atol 1e-5 / rtol 1e-4 (the JAX
    package's fused-vs-jnp GD bar, tests/test_kernels.py:219-226)."""
    var = VARIANTS[variant]
    kw = dict(n_iter=20, reg=0.3, step_size=1e-2, fused=fused)
    jkw, tkw = {}, {}
    if var["planes"]:
        mask, wt = _planes()
        jkw = dict(mask_static=mask, weight_time=jnp.asarray(wt))
        tkw = dict(mask_static=mask, weight_time=torch.tensor(wt))
    j = jgd.subgradient_descent(jnp.asarray(x0), cfg=JConfig(**var["cfg"]),
                                **jkw, **kw)
    t = gd.subgradient_descent(torch.tensor(x0), cfg=TVConfig(**var["cfg"]),
                               **tkw, **kw)
    assert t.loss.shape == t.tv.shape == (20,)
    assert t.loss.dtype == torch.float32 and t.x.dtype == torch.float32
    np.testing.assert_allclose(t.loss.numpy(), np.asarray(j.loss), rtol=1e-4)
    np.testing.assert_allclose(t.tv.numpy(), np.asarray(j.tv), rtol=1e-4)
    np.testing.assert_allclose(t.x.numpy(), np.asarray(j.x), atol=1e-5,
                               rtol=1e-4)


def test_cameraman_gd_reference_value():
    """README recipe: cameraman, noise 100, seed 0, reg 25, step 5e-3, 300
    iterations in f64 -> 39 074 939.78 (BASELINE.md; a nonsmooth iteration,
    hence the 1e-5 bar of tests/test_solvers.py)."""
    assert has_real_cameraman()
    noisy = torch.tensor(add_noise(cameraman().reshape(1, 1, 256, 256), 100,
                                   seed=0))
    # one thread: 2,000 small multi-threaded ops in two pytest workers at
    # once starve each other's OpenMP threads (88 s instead of 1 s)
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        res = TVDenoiser(reg=25).gd(noisy[0, 0], n_iter=300)
    finally:
        torch.set_num_threads(threads)
    assert res.x.shape == (256, 256) and res.x.dtype == torch.float64
    assert res.loss.shape == (300,) and res.loss.dtype == torch.float64
    assert float(res.loss[-1]) == pytest.approx(CAMERAMAN_GD, rel=1e-5)


def test_denoiser_gd_rank_round_trip(x0):
    model = TVDenoiser(reg=0.3)
    assert model.gd(x0[0, 0], n_iter=3, device="cpu").x.shape == SHAPE[2:]
    out3d = model.gd(torch.tensor(x0[:, 0]), n_iter=3)
    assert out3d.x.shape == (SHAPE[0],) + SHAPE[2:]
    four = model.gd(torch.tensor(x0), n_iter=3)
    assert four.x.shape == SHAPE
    direct = gd.subgradient_descent(torch.tensor(x0), n_iter=3, reg=0.3)
    assert torch.equal(four.x, direct.x)


def test_bf16_storage(x0):
    """bf16 x updates in bf16; the TV and loss histories are float32 and
    track the f32 run within bf16 rounding (3e-2, the JAX package's bar)."""
    cfg = TVConfig(scheme="hybrid", reg_time=0.5)
    a = gd.subgradient_descent(torch.tensor(x0), n_iter=20, reg=0.3,
                               step_size=1e-2, cfg=cfg)
    b = gd.subgradient_descent(torch.tensor(x0).to(torch.bfloat16), n_iter=20,
                               reg=0.3, step_size=1e-2, cfg=cfg)
    assert b.x.dtype == torch.bfloat16
    assert b.loss.dtype == torch.float32 and b.tv.dtype == torch.float32
    np.testing.assert_allclose(b.loss.numpy(), a.loss.numpy(), rtol=3e-2)


def test_inputs_untouched_and_x_init(x0):
    noisy = torch.tensor(x0)
    start = torch.tensor(x0[::-1].copy())
    before = (noisy.clone(), start.clone())
    res = gd.subgradient_descent(noisy, n_iter=4, reg=0.3, x_init=start)
    assert torch.equal(noisy, before[0]) and torch.equal(start, before[1])
    x1, loss, tv_val = gd.gd_step(start, noisy, reg=0.3, step_size=5e-3,
                                  cfg=TVConfig())
    first = gd.subgradient_descent(noisy, n_iter=1, reg=0.3, x_init=start)
    np.testing.assert_allclose(first.x.numpy(), x1.numpy(), atol=1e-6)
    assert float(first.loss[0]) == pytest.approx(float(loss), rel=1e-6)
    assert not torch.equal(res.x, first.x)


def test_progress_every(x0):
    seen = []
    gd.subgradient_descent(torch.tensor(x0), n_iter=7, reg=0.3,
                           progress_every=3,
                           progress_fn=lambda i, loss: seen.append((i, loss)))
    assert [i for i, _ in seen] == [0, 3, 6]
    assert all(isinstance(v, float) for _, v in seen)


def test_api_tv_and_subgrad_on_cpu_equals_ops_tv(x0):
    """On a CPU tensor (or numpy with ``device="cpu"``) the public entry
    point takes the plain ops.tv path, mask_static / weight_time / norms
    included."""
    mask, wt = _planes()
    x = torch.tensor(x0, dtype=torch.float64)
    for kw in (dict(), dict(reg_time=0.5, norm_type="huber", huber_delta=0.3),
               dict(reg_time=0.7, factor_reg_static=0.3, mask_static=mask,
                    weight_time=torch.tensor(wt, dtype=torch.float64)),
               dict(reg_time=0.5, mask=mask[0, 0],
                    return_grad_norms=True)):
        got = api.tv_and_subgrad(x, "central", **kw)
        ref = tv.tv_and_subgrad(x, "central", **kw)
        for a, b in zip(got, ref):
            assert torch.equal(a, b)
    got = api.tv_hybrid(x0.astype(np.float64), mask_static=False, mask=[],
                        device="cpu")
    ref = tv.tv_hybrid(torch.tensor(x0, dtype=torch.float64))
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
