"""The port's whole-solve factories (kernel B9 through its wrappers, which
take the plain PyTorch loop for CPU tensors) against the JAX package's
``make_resident_cp_solver`` / ``make_resident_gd_solver``, whose Pallas
kernels run in the interpreter on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytv4d_tpu.core.config import TVConfig as JConfig
from pytv4d_tpu.kernels import resident as jresident
from pytv4d_tpu.solvers.cp import default_tau as jdefault_tau
from pytv4d_tpu.solvers.gd import subgradient_descent as jsubgradient_descent
from pytv4d_tpu_torch.core.config import TVConfig
from pytv4d_tpu_torch.core.schemes import num_channels
from pytv4d_tpu_torch.kernels import resident
from pytv4d_tpu_torch.solvers.cp import chambolle_pock, default_tau
from pytv4d_tpu_torch.solvers.gd import subgradient_descent
from pytv4d_tpu_torch.utils import profiling

SCHEMES = ("upwind", "downwind", "central", "hybrid")
SHAPE = (4, 3, 16, 128)  # the fixture shape of the JAX kernel tests
N_ITER = 15
# float32 on both sides, the same expression per voxel in another order of
# additions: the per-call bar of the fused kernels (atol 2e-6, rtol 1e-5)
# times ten for 15 iterations of a contraction, as the whole-solve TGV
# kernel is held
TOL = dict(atol=2e-5, rtol=1e-4)
LOSS_RTOL = 1e-5


def _inputs(cfg, seed=0):
    rng = np.random.default_rng(seed)
    Nd = num_channels(cfg.scheme, SHAPE[0], SHAPE[1], cfg.reg_z_over_reg,
                      cfg.reg_time)
    x0 = rng.random(SHAPE).astype(np.float32)
    x = (x0 + 0.1 * rng.random(SHAPE)).astype(np.float32)
    y_A = (0.1 * rng.standard_normal(SHAPE)).astype(np.float32)
    y_D = (0.1 * rng.standard_normal(
        (SHAPE[0], Nd, SHAPE[1]) + SHAPE[2:])).astype(np.float32)
    return x0, x, y_A, y_D


@pytest.mark.parametrize("norm", ("iso", "huber"))
@pytest.mark.parametrize("scheme", SCHEMES)
def test_resident_cp_matches_jax_kernel(scheme, norm):
    cfg_kw = dict(scheme=scheme, reg_time=0.5, norm=norm, huber_delta=0.3)
    cfg = TVConfig(**cfg_kw)
    arrays = _inputs(cfg)
    tau = default_tau(cfg, SHAPE[0], SHAPE[1])
    assert tau == jdefault_tau(JConfig(**cfg_kw), SHAPE[0], SHAPE[1])
    kw = dict(reg=0.4, sigma_D=0.5, sigma_A=1.0, tau=tau)

    jsolve = jresident.make_resident_cp_solver(
        JConfig(**cfg_kw), SHAPE, N_ITER, "float32", interpret=True, **kw)
    want = jsolve(*(jnp.asarray(a) for a in arrays))

    launches = profiling.counters()["launch.B9.cp"]
    solve = resident.make_resident_cp_solver(cfg, SHAPE, N_ITER, "float32",
                                             **kw)
    tensors = [torch.tensor(a) for a in arrays]
    got = solve(*tensors)
    assert profiling.counters()["launch.B9.cp"] == launches  # CPU: plain
    for t, a in zip(tensors, arrays):  # the inputs are not modified
        np.testing.assert_array_equal(t.numpy(), a)
    for g, w, name in zip(got[:3], want[:3], ("x", "y_A", "y_D")):
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32, name
        np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                                   **TOL)
    assert tuple(got[3].shape) == (N_ITER,)
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]),
                               rtol=LOSS_RTOL)


@pytest.mark.parametrize("norm", ("iso", "aniso"))
@pytest.mark.parametrize("scheme", SCHEMES)
def test_resident_gd_matches_jax_kernel(scheme, norm):
    cfg_kw = dict(scheme=scheme, reg_time=0.5, norm=norm)
    cfg = TVConfig(**cfg_kw)
    x0, x, _, _ = _inputs(cfg, seed=1)
    kw = dict(reg=0.4, step_size=1e-2)

    if norm == "iso":
        jsolve = jresident.make_resident_gd_solver(
            JConfig(**cfg_kw), SHAPE, N_ITER, "float32", interpret=True, **kw)
        jx, jlosses = jsolve(jnp.asarray(x0), jnp.asarray(x))
    else:
        # the JAX kernel's body calls tv_and_subgrad without the norm, so
        # it descends along the isotropic subgradient whatever cfg.norm
        # says; the port follows gd_step, which honours it, and is held
        # against the JAX solver's plain path here
        ref = jsubgradient_descent(
            jnp.asarray(x0), n_iter=N_ITER, cfg=JConfig(**cfg_kw),
            x_init=jnp.asarray(x), fused=False, **kw)
        jx, jlosses = ref.x, ref.loss

    launches = profiling.counters()["launch.B9.gd"]
    solve = resident.make_resident_gd_solver(cfg, SHAPE, N_ITER, "float32",
                                             **kw)
    gx, glosses = solve(torch.tensor(x0), torch.tensor(x))
    assert profiling.counters()["launch.B9.gd"] == launches
    # subgradient descent is nonsmooth: a sign or a zero norm decided the
    # other way by a last-bit difference moves single voxels by step * reg
    # * weight, so x is held on all but a few voxels and the losses tightly
    diff = np.abs(gx.numpy() - np.asarray(jx))
    bar = TOL["atol"] + TOL["rtol"] * np.abs(np.asarray(jx))
    assert np.mean(diff > bar) <= 1e-3
    assert diff.max() <= 2 * N_ITER * kw["step_size"] * kw["reg"]
    np.testing.assert_allclose(glosses.numpy(), np.asarray(jlosses),
                               rtol=LOSS_RTOL)


def test_resident_solvers_equal_the_solvers_plain_path():
    """The explicit API computes what ``chambolle_pock`` and
    ``subgradient_descent`` compute on their plain paths, as in the JAX
    package's own test: bit for bit on the CPU, where both are the same
    PyTorch ops."""
    cfg = TVConfig(scheme="hybrid", reg_time=0.5)
    x0 = torch.tensor(np.random.default_rng(0).random(SHAPE), dtype=torch.float32)
    tau = default_tau(cfg, SHAPE[0], SHAPE[1])
    ref = chambolle_pock(x0, n_iter=N_ITER, reg=0.4, cfg=cfg, fused=False)
    Nd = ref.state.y_D.shape[1]
    solve = resident.make_resident_cp_solver(cfg, SHAPE, N_ITER, "float32",
                                             reg=0.4, sigma_D=0.5,
                                             sigma_A=1.0, tau=tau)
    x, y_A, y_D, losses = solve(
        x0, x0.clone(), torch.zeros_like(x0),
        torch.zeros((SHAPE[0], Nd, SHAPE[1]) + SHAPE[2:]))
    assert torch.equal(losses, ref.loss) and torch.equal(x, ref.x)
    assert torch.equal(y_A, ref.state.y_A) and torch.equal(y_D, ref.state.y_D)

    gref = subgradient_descent(x0, n_iter=N_ITER, reg=0.4, step_size=1e-2,
                               cfg=cfg, fused=False)
    gx, glosses = resident.make_resident_gd_solver(
        cfg, SHAPE, N_ITER, "float32", reg=0.4, step_size=1e-2)(x0, x0)
    assert torch.equal(glosses, gref.loss) and torch.equal(gx, gref.x)


def test_resident_fits_answers():
    cfg = TVConfig(scheme="hybrid", reg_time=0.5)
    jcfg = JConfig(scheme="hybrid", reg_time=0.5)
    # where the JAX package's test pins its guard, the port answers alike
    for shape in (SHAPE, (64, 16, 512, 512)):
        assert resident.resident_fits(shape, cfg) == \
            jresident.resident_fits(shape, jcfg)
    assert resident.resident_fits(SHAPE, cfg)
    assert resident.resident_fits((1, 1, 256, 256), TVConfig())
    assert resident.resident_fits(SHAPE, cfg, "float32")
    assert resident.resident_fits(SHAPE, cfg, torch.float32)
    assert not resident.resident_fits((64, 16, 512, 512), cfg)
    assert not resident.resident_fits(SHAPE, cfg, "bfloat16")
    assert not resident.resident_fits(SHAPE, cfg, torch.float64)
    assert not resident.resident_fits(SHAPE[1:], cfg)
    assert not resident.resident_fits((0, 1, 8, 8), cfg)
    # the state (x, y_A and Nd channels of y_D) must stay in the L2 budget
    Nd = num_channels("hybrid", 8, 4, 1.0, 0.5)
    side = int((resident.L2_STATE_BUDGET / (4 * (2 + Nd) * 32)) ** 0.5)
    assert resident.resident_fits((8, 4, side, side), cfg)
    assert not resident.resident_fits((8, 4, side + 1, side + 1), cfg)


@pytest.mark.parametrize("which", ("cp", "gd"))
def test_factories_and_solvers_refuse_what_they_cannot_take(which):
    cfg = TVConfig(scheme="hybrid", reg_time=0.5)
    make = (resident.make_resident_cp_solver if which == "cp"
            else resident.make_resident_gd_solver)
    with pytest.raises(ValueError, match="resident_fits"):
        make(cfg, (64, 16, 512, 512), 3)
    with pytest.raises(ValueError, match="resident_fits"):
        make(cfg, SHAPE, 3, "bfloat16")
    with pytest.raises(ValueError, match="n_iter"):
        make(cfg, SHAPE, -1)
    solve = make(cfg, SHAPE, 2)
    x0, x, y_A, y_D = (torch.tensor(a) for a in _inputs(cfg))
    args = (x0, x, y_A, y_D) if which == "cp" else (x0, x)
    solve(*args)
    bad = list(args)
    bad[1] = x[:, :2].contiguous()
    with pytest.raises(ValueError, match="x must be float32"):
        solve(*bad)
    bad[1] = x.double()
    with pytest.raises(ValueError, match="x must be float32"):
        solve(*bad)
    bad[1] = x.transpose(2, 3)
    with pytest.raises(ValueError):
        solve(*bad)
    if not torch.cuda.is_available():  # numpy goes to the card, or raises
        with pytest.raises(RuntimeError, match="CUDA device"):
            solve(x0.numpy(), *args[1:])
    # only a CPU tensor takes the plain version: any other device must
    # reach the kernel or raise, never compute somewhere else
    with pytest.raises(ValueError, match="unsupported device"):
        solve(*(t.to("meta") for t in args))


def test_zero_iterations_return_the_state_and_no_losses():
    cfg = TVConfig(scheme="hybrid", reg_time=0.5)
    x0, x, y_A, y_D = (torch.tensor(a) for a in _inputs(cfg))
    out = resident.make_resident_cp_solver(cfg, SHAPE, 0)(x0, x, y_A, y_D)
    assert torch.equal(out[0], x) and torch.equal(out[2], y_D)
    assert tuple(out[3].shape) == (0,)
    gx, gl = resident.make_resident_gd_solver(cfg, SHAPE, 0)(x0, x)
    assert torch.equal(gx, x) and tuple(gl.shape) == (0,)
