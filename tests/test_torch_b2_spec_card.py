"""CP pass B (B2) on an unsharded volume on the card: ``cp_primal_spec_kernel``
(``csrc/specialised.cu``, per channel table) against its plain version on
the same operands (in place and out of place, f32, a bf16 dual and bf16, an
odd width and arrays one element off alignment, where the runs go element
by element), at the CP bar (bf16: plus one bf16 ulp); and its x' bit for bit
its halo-mode instance's (``csrc/specialised_cp.cu``) on a 1 x 1 grid.
Needs a CUDA device and ``nvcc``, and skips without them; ``chip_smoke.py``
phase 3 holds the kernel the same way over every table and storage pair."""

import numpy as np
import pytest
import torch

from pytv4d_tpu_torch.core.config import TVConfig
from pytv4d_tpu_torch.core.schemes import scheme_channels
from pytv4d_tpu_torch.kernels import fused
from pytv4d_tpu_torch.parallel import fused_halo
from pytv4d_tpu_torch.utils import profiling

TOL = dict(atol=2e-6, rtol=1e-5)   # the CP bar
BF16_RTOL = 2.0 ** -7              # one bf16 ulp
CFG = TVConfig(scheme="hybrid", reg_time=0.5)
PAIRS = {"f32": (torch.float32, torch.float32),
         "bf16 dual": (torch.float32, torch.bfloat16),
         "bf16": (torch.bfloat16, torch.bfloat16)}


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


def _shifted(t):
    """A copy of t that starts one element past an aligned address."""
    out = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:]
    return out.view(t.shape).copy_(t)


def _state(shape, pair, seed):
    x_dt, d_dt = PAIRS[pair]
    Nd = len(scheme_channels(CFG.scheme, *shape[:2], CFG.reg_z_over_reg,
                             CFG.reg_time)[0])
    rng = np.random.default_rng(seed)
    x0 = torch.tensor(rng.random(shape), dtype=torch.float32)
    x = x0 + 0.1 * torch.tensor(rng.random(shape), dtype=torch.float32)
    y_A = torch.tensor(rng.uniform(-1, 1, shape), dtype=torch.float32)
    y_D = torch.tensor(rng.uniform(-1, 1, shape[:2] + (Nd,) + shape[2:]),
                       dtype=torch.float32)
    return x.to(x_dt), x0.to(x_dt), y_A.to(x_dt), y_D.to(d_dt)


@pytest.mark.parametrize("in_place", [True, False])
@pytest.mark.parametrize("layout", ["aligned", "odd width", "off alignment"])
@pytest.mark.parametrize("pair", list(PAIRS))
def test_cp_primal_kernel_matches_its_plain_version(pair, layout, in_place):
    _need_card()
    shape = (4, 3, 24, 71) if layout == "odd width" else (4, 3, 32, 96)
    x, x0, y_A, y_D = _state(shape, pair, seed=7)
    kw = dict(cfg=CFG, tau=0.1, nonneg=True)
    want_x = x.clone()
    want, want_fid = fused.cp_primal_plain(want_x, x0, y_A, y_D, **kw)
    move = _shifted if layout == "off alignment" else torch.clone
    dx, dx0, dA, dD = (move(t.cuda()) for t in (x, x0, y_A, y_D))
    out = dx if in_place else move(torch.empty_like(dx))
    key = "launch.B2/spec_cp_primal_launch"
    launches = profiling.counters()[key]
    got, fid = fused.cp_primal(dx, dx0, dA, dD, out=out, **kw)
    torch.cuda.synchronize()
    assert got is out
    assert profiling.counters()[key] == launches + 1
    if not in_place:
        assert torch.equal(dx.cpu(), x)  # x left as it was
    got, want = got.float().cpu(), want.float()
    tol = (TOL if pair == "f32"
           else dict(atol=TOL["atol"] + 0.1 * BF16_RTOL, rtol=BF16_RTOL))
    np.testing.assert_allclose(got.numpy(), want.numpy(), **tol)
    assert float(fid.sum()) == pytest.approx(float(want_fid.sum()),
                                             rel=1e-5 if pair == "f32"
                                             else 1e-3)


@pytest.mark.parametrize("pair", list(PAIRS))
def test_cp_primal_equals_its_halo_instance_on_one_shard(pair):
    """x' of the unsharded kernel and of its halo-mode instance on the one
    shard of a 1 x 1 grid (the dual extended by zero planes), from a dual
    that pass A made from zero duals (zero at every slot a channel's gates
    skip, as the solvers keep it): bit for bit."""
    _need_card()
    dev = torch.device("cuda", 0)
    shape = (5, 4, 32, 96)
    x, x0, y_A, _ = (t.to(dev) for t in _state(shape, pair, seed=9))
    chans, _ = scheme_channels(CFG.scheme, *shape[:2], CFG.reg_z_over_reg,
                               CFG.reg_time)
    y_D = torch.zeros(shape[:2] + (len(chans),) + shape[2:],
                      dtype=PAIRS[pair][1], device=dev)
    fused.cp_dual(x, x0, y_A, y_D, cfg=CFG, sigma_D=0.5, sigma_A=1.0,
                  reg=0.5)
    y_ext = fused_halo._extend_dual([[y_D]], chans)[0][0]
    kw = dict(cfg=CFG, tau=0.1)
    want = fused.cp_primal(x, x0, y_A, y_D, out=torch.empty_like(x), **kw)[0]
    got = fused.cp_primal(x, x0, y_A, y_D, out=torch.empty_like(x),
                          halo_mode=True, table_dims=shape[:2], y_ext=y_ext,
                          **kw)[0]
    torch.cuda.synchronize()
    bits = torch.int16 if x.dtype == torch.bfloat16 else torch.int32
    assert torch.equal(got.view(bits), want.view(bits))
