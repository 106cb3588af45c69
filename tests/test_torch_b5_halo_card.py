"""B5's halo mode on the card: the halo instance of ``tv_dual_spec_kernel``
(``csrc/specialised_tv.cu``, per channel table) against its plain version
on the same shard (one shard of 4 z-shards and of a (2 x 2) grid, f32 and a
bf16 dual), at the CP bar, and every shard's y_D' bit for bit the unsharded
kernel's on the gathered volume.  Needs a CUDA device and ``nvcc``, and
skips without them; ``chip_smoke.py`` phase 32 holds the kernel the same
way at the CT cell's shard shape and over every table and storage pair."""

import numpy as np
import pytest
import torch

from pytv4d_tpu_torch.core.config import TVConfig
from pytv4d_tpu_torch.core.schemes import AXIS_T, AXIS_Z, scheme_channels
from pytv4d_tpu_torch.kernels import fused
from pytv4d_tpu_torch.parallel import fused_halo
from pytv4d_tpu_torch.parallel.mesh import (
    gather_volume,
    grid_map,
    make_mesh,
    shard_volume,
)
from pytv4d_tpu_torch.utils import profiling

TOL = dict(atol=2e-6, rtol=1e-5)   # the CP bar
BF16_RTOL = 2.0 ** -7              # one bf16 ulp
SHAPE = (16, 4, 64, 96)


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


@pytest.mark.parametrize("dual", ["float32", "bfloat16"])
@pytest.mark.parametrize("grid_zt", [(4, 1), (2, 2)])
def test_tv_dual_kernel_matches_its_plain_version(grid_zt, dual):
    _need_card()
    shape = SHAPE
    local = (shape[0] // grid_zt[0], shape[1] // grid_zt[1]) + shape[2:]
    cfg = TVConfig(scheme="hybrid", reg_time=0.5)
    Nd = len(scheme_channels("hybrid", *shape[:2], 1.0, 0.5)[0])
    rng = np.random.default_rng(3)
    x_ext = torch.tensor(rng.standard_normal(
        (local[0] + 2, local[1] + 2) + local[2:]), dtype=torch.float32)
    y_D = torch.tensor(rng.uniform(-1, 1, local[:2] + (Nd,) + local[2:]),
                       dtype=torch.float32).to(getattr(torch, dual))
    kw = dict(cfg=cfg, sigma_D=0.4, reg=0.5, halo_mode=True,
              table_dims=shape[:2])
    want, want_parts = fused.tv_dual_plain(x_ext, y_D.clone(), **kw)
    launches = profiling.counters()["launch.B5"]
    got, parts = fused.tv_dual(x_ext.cuda(), y_D.cuda(), **kw)
    torch.cuda.synchronize()
    assert profiling.counters()["launch.B5"] == launches + 1
    got, want = got.float().cpu(), want.float()
    tol = (dict(atol=TOL["atol"], rtol=BF16_RTOL) if dual == "bfloat16"
           else TOL)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **tol)
    assert float(parts.sum()) == pytest.approx(float(want_parts.sum()),
                                               rel=1e-5)


@pytest.mark.parametrize("grid_zt", [(4, 1), (2, 2)])
def test_tv_dual_halo_equals_the_unsharded_kernel(grid_zt):
    """Each shard's y_D', its x_bar extended by its ghost or neighbour planes
    as the sharded CT solve extends it, gathered: bit for bit the unsharded
    kernel's on the whole volume (same arithmetic in the same order)."""
    _need_card()
    dev = torch.device("cuda", 0)
    cfg = TVConfig(scheme="hybrid", reg_time=0.5)
    chans, _ = scheme_channels("hybrid", *SHAPE[:2], 1.0, 0.5)
    rng = np.random.default_rng(5)
    x = torch.tensor(rng.standard_normal(SHAPE), dtype=torch.float32,
                     device=dev)
    y_D = torch.tensor(rng.uniform(-1, 1, SHAPE[:2] + (len(chans),)
                                   + SHAPE[2:]), dtype=torch.float32,
                       device=dev)
    kw = dict(cfg=cfg, sigma_D=0.4, reg=0.5)
    want, _ = fused.tv_dual(x, y_D.clone(), **kw)
    mesh, st = make_mesh(*grid_zt, device=dev), grid_zt[1] > 1
    x_ext = fused_halo._extend_axis(fused_halo._extend_axis(
        shard_volume(x, mesh, st), 0,
        fused_halo._axis_ghost_kind(chans, AXIS_Z)), 1,
        fused_halo._axis_ghost_kind(chans, AXIS_T))
    got = grid_map(lambda xe, y: fused.tv_dual(
        xe, y, halo_mode=True, table_dims=SHAPE[:2], **kw)[0], x_ext,
        shard_volume(y_D.clone(), mesh, st))
    torch.cuda.synchronize()
    assert torch.equal(gather_volume(got).view(torch.int32),
                       want.view(torch.int32))
