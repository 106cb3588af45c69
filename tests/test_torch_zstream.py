"""The port's z-marching pass A (kernel B10 through its wrapper, which takes
the plain PyTorch version for CPU tensors) against the JAX package's
``make_cp_dual_kernel_zstream``, whose Pallas kernel runs in the interpreter
on the CPU, on the cases of the JAX package's own zstream tests."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytv4d_tpu.core.config import TVConfig as JConfig
from pytv4d_tpu.kernels import fused as jfused
from pytv4d_tpu.kernels import zstream as jzstream
from pytv4d_tpu_torch.core.config import TVConfig
from pytv4d_tpu_torch.core.schemes import num_channels
from pytv4d_tpu_torch.kernels import fused, zstream
from pytv4d_tpu_torch.utils import profiling

# float32 round-off: the JAX package's own bar between its two pass-A kernels
ATOL = 3e-7
KW = dict(sigma_D=0.5, sigma_A=1.0, reg=0.3)
HYB = dict(scheme="hybrid", reg_time=0.5)

CASES = {
    "upwind": ((4, 2, 16, 128), dict(scheme="upwind", reg_time=0.5), {}),
    "downwind": ((4, 2, 16, 128), dict(scheme="downwind", reg_time=0.5), {}),
    "central": ((4, 2, 16, 128), dict(scheme="central", reg_time=0.5), {}),
    "hybrid": ((4, 2, 16, 128), HYB, {}),
    "l1": ((4, 2, 16, 128), HYB, dict(fidelity="l1", fid_weight=0.7)),
    "kl": ((3, 2, 16, 128), HYB, dict(fidelity="kl", fid_weight=1.3)),
    "aniso": ((4, 2, 16, 128), dict(norm="aniso", **HYB), {}),
    "huber": ((4, 2, 16, 128), dict(norm="huber", huber_delta=0.2, **HYB),
              {}),
}


def _inputs(shape, cfg, seed=0):
    rng = np.random.default_rng(seed)
    Nz, M, Nr, Nc = shape
    Nd = num_channels(cfg.scheme, Nz, M, cfg.reg_z_over_reg, cfg.reg_time)
    x = rng.random(shape).astype(np.float32)
    x0 = rng.random(shape).astype(np.float32)
    yA = (0.1 * rng.standard_normal(shape)).astype(np.float32)
    yD = (0.1 * rng.standard_normal((Nz, M, Nd, Nr, Nc))).astype(np.float32)
    return x, x0, yA, yD


def _jax_zstream(shape, cfg_kw, fid_kw, arrays, dual_dtype="float32"):
    kernel = jzstream.make_cp_dual_kernel_zstream(
        JConfig(**cfg_kw), shape, "float32", interpret=True,
        dual_dtype_name=dual_dtype, **KW, **fid_kw)
    x, x0, yA, yD = arrays
    return kernel(jnp.asarray(x), jnp.asarray(x0), jnp.asarray(yA),
                  jnp.asarray(yD, jnp.dtype(dual_dtype)))


@pytest.mark.parametrize("case", list(CASES))
def test_zstream_matches_jax_kernel(case):
    shape, cfg_kw, fid_kw = CASES[case]
    cfg = TVConfig(**cfg_kw)
    arrays = _inputs(shape, cfg)
    jA, jD, _dt_local, jparts = _jax_zstream(shape, cfg_kw, fid_kw, arrays)

    x, x0, yA, yD = (torch.tensor(a) for a in arrays)
    launches = profiling.counters()["launch.B10"]
    tA, tD, parts = zstream.cp_dual_zstream(x, x0, yA, yD, cfg=cfg, **KW,
                                            **fid_kw)
    assert profiling.counters()["launch.B10"] == launches  # CPU: plain version
    assert tA is yA and tD is yD  # updated in place, as fused.cp_dual
    np.testing.assert_array_equal(x.numpy(), arrays[0])
    np.testing.assert_allclose(tA.numpy(), np.asarray(jA), atol=ATOL, rtol=0)
    np.testing.assert_allclose(tD.numpy(), np.asarray(jD), atol=ATOL, rtol=0)
    np.testing.assert_allclose(float(parts.sum()),
                               float(jnp.sum(jparts[..., 0, 0])), rtol=2e-6)


def test_zstream_bf16_dual_within_one_ulp():
    shape, cfg_kw = (4, 2, 16, 128), HYB
    cfg = TVConfig(**cfg_kw)
    x, x0, yA, yD = _inputs(shape, cfg)
    yD = torch.tensor(yD).bfloat16().float().numpy()  # one bf16 start
    _, jD, _, jparts = _jax_zstream(shape, cfg_kw, {}, (x, x0, yA, yD),
                                    "bfloat16")
    t_dual = torch.tensor(yD).bfloat16()
    _, tD, parts = zstream.cp_dual_zstream(
        torch.tensor(x), torch.tensor(x0), torch.tensor(yA), t_dual, cfg=cfg,
        **KW)
    assert tD.dtype == torch.bfloat16
    want = np.asarray(jD.astype(jnp.float32))
    got = tD.float().numpy()
    # both compute the f32 value within ATOL and round it to bf16: a value
    # near a rounding midpoint may land one bf16 ulp (2^-7 relative) apart
    assert np.all(np.abs(got - want) <= ATOL + 2.0 ** -7 * np.abs(want))
    assert np.mean(got != want) <= 0.01
    np.testing.assert_allclose(float(parts.sum()),
                               float(jnp.sum(jparts[..., 0, 0])), rtol=2e-6)


def test_zstream_then_pass_b_matches_the_jax_step():
    """The composed step: zstream pass A and pass B against the JAX
    package's zstream pass A and its production pass B."""
    shape, cfg_kw = (4, 2, 16, 128), HYB
    cfg = TVConfig(**cfg_kw)
    arrays = _inputs(shape, cfg, seed=3)
    jA, jD, jdt, _ = _jax_zstream(shape, cfg_kw, {}, arrays)
    primal = jfused.make_cp_primal_kernel(JConfig(**cfg_kw), shape, "float32",
                                          tau=0.1, interpret=True,
                                          dual_dtype_name="float32")
    jx, _ = primal(jnp.asarray(arrays[0]), jnp.asarray(arrays[1]), jA, jD,
                   jdt, None)

    x, x0, yA, yD = (torch.tensor(a) for a in arrays)
    zstream.cp_dual_zstream(x, x0, yA, yD, cfg=cfg, **KW)
    tx, _ = fused.cp_primal(x, x0, yA, yD, cfg=cfg, tau=0.1)
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), atol=ATOL, rtol=0)


def test_zstream_equals_the_per_launch_pass_a():
    """One function, two traffic schedules: on the CPU both wrappers take
    the same plain version, bit for bit."""
    shape = (5, 3, 9, 20)  # no multiple of 8: the TPU's seam rule is gone
    cfg = TVConfig(**HYB)
    x, x0, yA, yD = (torch.tensor(a) for a in _inputs(shape, cfg, seed=4))
    a = zstream.cp_dual_zstream(x, x0, yA.clone(), yD.clone(), cfg=cfg, **KW)
    b = fused.cp_dual(x, x0, yA.clone(), yD.clone(), cfg=cfg, **KW)
    for g, w in zip(a, b):
        assert torch.equal(g, w)


@pytest.mark.parametrize("guard", ("Nz", "z channels"))
def test_zstream_guards_speak_as_the_jax_kernel(guard):
    if guard == "Nz":
        shape, cfg_kw = (2, 2, 16, 128), HYB
    else:
        shape, cfg_kw = (4, 2, 16, 128), dict(scheme="hybrid",
                                              reg_z_over_reg=0.0)
    with pytest.raises(ValueError) as want:
        jzstream.make_cp_dual_kernel_zstream(JConfig(**cfg_kw), shape,
                                             "float32", interpret=True)
    cfg = TVConfig(**cfg_kw)
    x, x0, yA, yD = (torch.tensor(a) for a in _inputs(shape, cfg))
    for fn in (zstream.cp_dual_zstream, zstream.cp_dual_zstream_plain):
        with pytest.raises(ValueError) as got:
            fn(x, x0, yA, yD, cfg=cfg, **KW)
        assert str(got.value) == str(want.value)


def test_zstream_refuses_other_devices_and_bad_operands():
    cfg = TVConfig(**HYB)
    x, x0, yA, yD = (torch.tensor(a) for a in _inputs((4, 2, 16, 128), cfg))
    with pytest.raises(ValueError, match="unsupported device"):
        zstream.cp_dual_zstream(*(t.to("meta") for t in (x, x0, yA, yD)),
                                cfg=cfg, **KW)
    with pytest.raises(ValueError, match="y_D must be"):
        zstream.cp_dual_zstream(x, x0, yA, yD.transpose(1, 2).contiguous(),
                                cfg=cfg, **KW)
    with pytest.raises(ValueError, match="storage"):
        zstream.cp_dual_zstream(x.double(), x0.double(), yA.double(), yD,
                                cfg=cfg, **KW)
