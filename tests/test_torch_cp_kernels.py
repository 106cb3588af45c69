"""The port's fused CP step (kernels B1/B2 through their wrappers, which
take the plain PyTorch versions for CPU tensors) against the JAX package's
fused step, whose Pallas kernels run in the interpreter on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytv4d_tpu.core.config import TVConfig as JConfig
from pytv4d_tpu.kernels import fused as jfused
from pytv4d_tpu_torch.core.config import TVConfig
from pytv4d_tpu_torch.core.schemes import num_channels
from pytv4d_tpu_torch.kernels import fused
from pytv4d_tpu_torch.kernels.dispatch import can_fuse, t_plane_multiplier
from pytv4d_tpu_torch.solvers.cp import CPState, cp_step, default_tau
from pytv4d_tpu_torch.utils import profiling

SCHEMES = ("upwind", "downwind", "central", "hybrid")
SHAPE = (4, 3, 16, 128)
CONFIGS = {"base": dict(), "time": dict(reg_time=0.5),
           "zt": dict(reg_time=0.7, reg_z_over_reg=0.3),
           "noz": dict(reg_z_over_reg=0.0)}
# each config also carries one variant of the step, so the 16 cases cover
# every norm, fidelity, nonneg and the time-channel multiplier plane
VARIANTS = {
    "base": dict(norm="iso", fidelity="l2", nonneg=False, tmul=False),
    "time": dict(norm="aniso", fidelity="l1", nonneg=False, tmul=True),
    "zt": dict(norm="huber", fidelity="kl", nonneg=True, tmul=True),
    "noz": dict(norm="iso", fidelity="l2", nonneg=True, tmul=False),
}
TOL = dict(atol=2e-6, rtol=1e-5)  # the JAX package's fused-vs-jnp bar


def _inputs(cfg_kw, fidelity, tmul, seed):
    rng = np.random.default_rng(seed)
    f32 = np.float32
    x0 = rng.random(SHAPE).astype(f32)
    x = (x0 + 0.1 * rng.random(SHAPE)).astype(f32)
    y_A = rng.random(SHAPE).astype(f32)
    if fidelity == "l1":
        y_A = 2 * y_A - 1
    cfg = TVConfig(**cfg_kw)
    Nd = num_channels(cfg.scheme, SHAPE[0], SHAPE[1], cfg.reg_z_over_reg,
                      cfg.reg_time)
    y_D = rng.random((SHAPE[0], SHAPE[1], Nd) + SHAPE[2:]).astype(f32)
    tm = (rng.random(SHAPE[2:]) + 0.5).astype(f32) if tmul else None
    return x, x0, y_A, y_D, tm


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("config", list(CONFIGS))
def test_cp_step_fused_internal_matches_jax(scheme, config):
    var = VARIANTS[config]
    cfg_kw = dict(scheme=scheme, norm=var["norm"], huber_delta=0.3,
                  **CONFIGS[config])
    x, x0, y_A, y_D, tm = _inputs(cfg_kw, var["fidelity"], var["tmul"], 1)
    cfg = TVConfig(**cfg_kw)
    tau = default_tau(cfg, SHAPE[0], SHAPE[1])
    kw = dict(reg=0.5, sigma_D=0.5, sigma_A=1.0, tau=tau,
              fidelity=var["fidelity"], nonneg=var["nonneg"])
    fw = 0.7 if var["fidelity"] != "l2" else 1.0

    jx, jyA, jyD, jloss = jfused.cp_step_fused_internal(
        jnp.asarray(x), jnp.asarray(y_A), jnp.asarray(y_D), jnp.asarray(x0),
        cfg=JConfig(**cfg_kw), interpret=True,
        tmul=None if tm is None else jnp.asarray(tm), fid_weight=fw, **kw)

    tx, tyA, tyD, tloss = fused.cp_step_fused_internal(
        torch.tensor(x), torch.tensor(y_A), torch.tensor(y_D),
        torch.tensor(x0), cfg=cfg,
        tmul=None if tm is None else torch.tensor(tm), fid_weight=fw, **kw)

    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), **TOL)
    np.testing.assert_allclose(tyA.numpy(), np.asarray(jyA), **TOL)
    np.testing.assert_allclose(tyD.numpy(), np.asarray(jyD), **TOL)
    assert tloss.dtype == torch.float32
    assert float(tloss) == pytest.approx(float(jloss), rel=1e-5)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_cp_step_fused_matches_cp_step(scheme):
    """The drop-in ``cp_step_fused`` equals the plain ``cp_step`` on a public
    state (f64 plain step vs f32 fused step) and leaves its inputs alone."""
    cfg = TVConfig(scheme=scheme, reg_time=0.5, reg_z_over_reg=0.6)
    x, x0, y_A, y_D_int, _ = _inputs(dict(scheme=scheme, reg_time=0.5,
                                          reg_z_over_reg=0.6), "l2", False, 2)
    y_D = np.ascontiguousarray(np.swapaxes(y_D_int, 1, 2))
    st = CPState(*(torch.tensor(a) for a in (x, y_A, y_D)))
    before = [t.clone() for t in st]
    tau = default_tau(cfg, SHAPE[0], SHAPE[1])
    kw = dict(reg=0.5, sigma_D=0.5, sigma_A=1.0, tau=tau, cfg=cfg)
    got, loss = fused.cp_step_fused(st, torch.tensor(x0), **kw)
    ref, loss_ref = cp_step(CPState(*(t.double() for t in st)),
                            torch.tensor(x0).double(), **kw)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), r.numpy(), atol=2e-6,
                                   rtol=1e-5)
    assert float(loss) == pytest.approx(float(loss_ref), rel=1e-6)
    for b, t in zip(before, st):
        assert torch.equal(b, t)


def test_bf16_storage_rounds_where_the_kernel_stores():
    """bf16 primary/dual storage: the plain versions compute in f32 and
    round to bf16 where the kernels store.  Pass A's outputs are the f32
    step's rounded to nearest (half a bf16 ulp, 2^-8 relative); x' also
    sees the rounded y_A', y_D' (|y| < 1 here), which moves it by at most
    tau * (1 + sum |w|) * 2^-9 < 3e-3.  The launch counters stay put on the
    CPU."""
    cfg = TVConfig(scheme="hybrid", reg_time=0.5)
    x, x0, y_A, y_D, _ = _inputs(dict(scheme="hybrid", reg_time=0.5), "l2",
                                 False, 3)
    bf = torch.bfloat16
    args32 = [torch.tensor(a).to(bf).float() for a in (x, y_A, y_D, x0)]
    args16 = [torch.tensor(a).to(bf) for a in (x, y_A, y_D, x0)]
    kw = dict(reg=0.5, sigma_D=0.5, sigma_A=1.0, tau=0.1, cfg=cfg)
    before = profiling.counters()
    r32 = fused.cp_step_fused_internal(*args32, **kw)
    r16 = fused.cp_step_fused_internal(*args16, **kw)
    assert profiling.counters() == before
    for a, b in zip(r16[1:3], r32[1:3]):
        assert a.dtype == bf
        np.testing.assert_allclose(a.float().numpy(), b.numpy(),
                                   rtol=2 ** -8, atol=1e-30)
    assert r16[0].dtype == bf
    np.testing.assert_allclose(r16[0].float().numpy(), r32[0].numpy(),
                               rtol=2 ** -8, atol=3e-3)
    assert float(r16[3]) == pytest.approx(float(r32[3]), rel=1e-4)


def test_wrapper_checks():
    cfg = TVConfig(scheme="hybrid")
    x = torch.zeros(SHAPE)
    y_D = torch.zeros((SHAPE[0], SHAPE[1], 6) + SHAPE[2:])
    kw = dict(cfg=cfg, sigma_D=0.5, sigma_A=1.0, reg=1.0)
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        fused.cp_dual(x.double(), x.double(), x.double(), y_D, **kw)
    with pytest.raises(ValueError, match="y_D must be"):
        fused.cp_dual(x, x, x.clone(), y_D[:, :, :4].contiguous(), **kw)
    with pytest.raises(ValueError, match="contiguous"):
        fused.cp_dual(x, x, x.clone(), y_D.transpose(1, 2), **kw)
    with pytest.raises(ValueError, match="tmul"):
        fused.cp_dual(x, x, x.clone(), y_D, torch.ones(3, 3), **kw)


def test_can_fuse_guard_and_tmul():
    cfg = TVConfig(scheme="hybrid", reg_time=0.5)
    assert can_fuse((8, 4, 256, 256), cfg)
    assert can_fuse((8, 4, 2048, 2048), cfg, dtype=torch.bfloat16)
    assert not can_fuse((8, 4, 256, 256), cfg, dtype="float64")
    assert not can_fuse((4, 256, 256), cfg)
    assert not can_fuse((300, 300, 8, 8), cfg)  # Nz * M beyond the grid
    assert can_fuse((8, 4, 256, 256), cfg,
                    mask_static=np.ones((1, 1, 256, 256), bool))
    assert not can_fuse((8, 4, 256, 256), cfg,
                        mask_static=np.ones((8, 4, 256, 256), bool))
    assert not can_fuse((8, 4, 256, 256), cfg,
                        weight_time=np.ones((8, 4, 256, 256)))
    mask = np.zeros((1, 1, 4, 5), bool)
    mask[..., 1, 2] = True
    wt = np.full((1, 1, 4, 5), 2.0)
    tm = t_plane_multiplier((3, 2, 4, 5), TVConfig(reg_time=0.5,
                                                   factor_reg_static=0.25),
                            mask, wt, device="cpu")
    expect = np.full((4, 5), 2.0)
    expect[1, 2] = 1.0
    np.testing.assert_allclose(tm.numpy(), expect)
    assert t_plane_multiplier((3, 2, 4, 5), TVConfig(), mask, wt,
                              device="cpu") is None
