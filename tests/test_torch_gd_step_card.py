"""Pass 2 with the subgradient-descent step in its epilogue on the card: the
GD instance of ``tv_subgrad_spec_kernel`` (``csrc/specialised.cu``,
``fused.tv_gd_step``) against B3, the standalone pass 2 (``fused.tv_subgrad``)
and the eager update on the same operands: x' bit for bit, and its
fidelity partials against a float64 sum of the same rounded squares (1e-5
relative), over the four schemes in float32 and bfloat16 storage, the iso,
aniso and huber norms, a time multiplier plane, an odd width, arrays one
element off alignment and x0 that is x; the standalone G against its plain
version at the bar of the JAX package's fused-vs-jnp GD test; and whole
solves, whose fused steps must give the eager loop's x to the bit.  Needs
a CUDA device and ``nvcc``, and skips without them."""

import numpy as np
import pytest
import torch

from pytv4d_tpu_torch.core.config import TVConfig
from pytv4d_tpu_torch.core.schemes import SCHEMES
from pytv4d_tpu_torch.kernels import build, fused
from pytv4d_tpu_torch.kernels.dispatch import t_plane_multiplier
from pytv4d_tpu_torch.ops.space import TENSOR
from pytv4d_tpu_torch.solvers import gd
from pytv4d_tpu_torch.utils import profiling

TOL = dict(atol=3e-6, rtol=1e-5)   # the JAX fused-vs-jnp bar for B3 / B4
BF16_RTOL = 2.0 ** -7              # one bf16 ulp
BF16_MAX_FLIPPED = 0.01            # share of bf16 G beyond the f32 bar
REG, STEP = 25.0, 5e-3             # the README recipe's
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
CASES = {
    **{s: dict(scheme=s, reg_time=0.5) for s in SCHEMES},
    "aniso": dict(scheme="central", reg_time=0.5, norm="aniso"),
    "huber": dict(scheme="hybrid", reg_time=0.5, norm="huber",
                  huber_delta=0.3),
    "tmul": dict(scheme="hybrid", reg_time=0.5, factor_reg_static=0.3),
}
LAYOUTS = {"aligned": (4, 3, 32, 96), "odd width": (4, 3, 24, 71),
           "off alignment": (4, 3, 32, 96)}


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    try:
        build.find_nvcc()
    except build.BuildError:
        pytest.skip("needs nvcc to build the kernel")


def _shifted(t):
    """A copy of t that starts one element past an aligned address."""
    out = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:]
    return out.view(t.shape).copy_(t)


def _operands(case, dtype, shape, layout, seed=3):
    """x, x0 (near x, as a solve's), the time multiplier or None, on the
    card, in ``dtype``."""
    dev = torch.device("cuda", 0)
    cfg = TVConfig(**CASES[case])
    gen = torch.Generator(device=dev).manual_seed(seed)
    x0 = 255 * torch.rand(shape, generator=gen, device=dev)
    x = x0 + 20 * torch.rand(shape, generator=gen, device=dev)
    tm = None
    if case == "tmul":
        mask = torch.rand(shape[2:], generator=gen, device=dev) < 0.5
        wt = 1.0 + torch.rand(shape[2:], generator=gen, device=dev)
        tm = t_plane_multiplier(shape, cfg, mask[None, None], wt[None, None],
                                device=dev).float().contiguous()
    move = _shifted if layout == "off alignment" else torch.clone
    return cfg, move(x.to(dtype)), move(x0.to(dtype)), tm


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


@pytest.mark.parametrize("same", [False, True], ids=["x0", "x0 is x"])
@pytest.mark.parametrize("layout", list(LAYOUTS))
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(CASES))
def test_the_gd_step_equals_the_eager_update(case, dtype, layout, same):
    _need_card()
    cfg, x, x0, tm = _operands(case, DTYPES[dtype], LAYOUTS[layout], layout)
    if same:
        x0 = x
    before = x.clone()
    norms, _ = fused.tv_norms(x, tm, cfg=cfg)
    G = fused.tv_subgrad(x, norms, tm, cfg=cfg)
    want = x - STEP * ((x - x0) + REG * G)
    sq = torch.square(want - x0)        # rounded to x's dtype, as the loss's
    launches = profiling.counters()
    got, parts = fused.tv_gd_step(x, x0, norms, tm, cfg=cfg, reg=REG,
                                  step_size=STEP)
    torch.cuda.synchronize()
    after = profiling.counters()
    assert after["launch.B4_gd"] == launches["launch.B4_gd"] + 1
    assert after["launch.B4"] == launches["launch.B4"] + 1
    assert torch.equal(x, before) and got.dtype == x.dtype
    assert torch.equal(_bits(got), _bits(want))
    fid = 0.5 * float(sq.double().sum())
    assert float(parts.double().sum()) == pytest.approx(fid, rel=1e-5)


@pytest.mark.parametrize("layout", ["aligned", "odd width"])
@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(CASES))
def test_the_standalone_g_keeps_its_bar(case, dtype, layout):
    """The G instance of pass 2 against ``tv_subgrad_plain`` on the same
    norms: float32 within the bar, bfloat16 within it plus one bf16 ulp,
    with at most 1% of the voxels beyond the float32 bar."""
    _need_card()
    cfg, x, _, tm = _operands(case, DTYPES[dtype], LAYOUTS[layout], layout)
    norms, _ = fused.tv_norms(x, tm, cfg=cfg)
    got = fused.tv_subgrad(x, norms, tm, cfg=cfg).float()
    want = fused.tv_subgrad_plain(x, norms, tm, cfg=cfg).float()
    err = (got - want).abs()
    bar = TOL["atol"] + TOL["rtol"] * want.abs()
    if dtype == "bf16":
        assert bool((err <= bar + BF16_RTOL * want.abs()).all())
        assert float((err > bar).float().mean()) <= BF16_MAX_FLIPPED
    else:
        assert bool((err <= bar).all()), float(err.max())


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", ["hybrid", "aniso", "tmul"])
def test_a_solve_steps_by_the_gd_instance(case, dtype):
    """``subgradient_descent`` on a CUDA tensor launches the GD instance
    every iteration and gives the x, to the bit, of the loop that steps by
    the eager update on the standalone pass 2; its TV history equal, its
    loss history within 1e-5 (the fidelity summed in another order)."""
    _need_card()
    cfg, x0, _, _ = _operands(case, DTYPES[dtype], (4, 3, 32, 96), "aligned")
    kw = dict(n_iter=10, reg=REG, step_size=STEP, cfg=cfg)
    if case == "tmul":
        gen = torch.Generator(device=x0.device).manual_seed(8)
        kw["mask_static"] = (torch.rand((1, 1, 32, 96), generator=gen,
                                        device=x0.device) < 0.5)
        kw["weight_time"] = 1.0 + torch.rand((1, 1, 32, 96), generator=gen,
                                             device=x0.device)
    tm = t_plane_multiplier(tuple(x0.shape), cfg, kw.get("mask_static"),
                            kw.get("weight_time"), dtype=x0.dtype,
                            device=x0.device)
    tm = None if tm is None else tm.float().contiguous()
    before = profiling.counters()["launch.B4_gd"]
    got = gd.subgradient_descent(x0, **kw)
    torch.cuda.synchronize()
    assert profiling.counters()["launch.B4_gd"] == before + 10
    step = gd.eager_step(
        TENSOR, lambda v: fused.tv_and_subgrad_fused(v, cfg, tmul=tm), x0,
        REG, STEP)
    x, losses, tvs = gd.gd_loop(TENSOR, step, x0, n_iter=10,
                                hist_dtype=torch.float32)
    assert torch.equal(_bits(got.x), _bits(x))
    assert torch.equal(got.tv, tvs)
    np.testing.assert_allclose(got.loss.cpu().numpy(), losses.cpu().numpy(),
                               rtol=1e-5 if dtype == "f32" else 1e-2)
