"""The benchmark's plain reference against the program's plain CPU path at
small sizes, in float64: the TV operators of every scheme, CP and GD
denoising, the spectral parallel-beam pair and the CT solve.  The
reference imports nothing of the program; only these tests hold the two
side by side."""

import numpy as np
import pytest
import torch

from benchmark.reference import ct as ref_ct
from benchmark.reference import tv as ref_tv
from pytv4d_tpu_torch.core.config import TVConfig
from pytv4d_tpu_torch.models.ct import cp_reconstruct, make_projector
from pytv4d_tpu_torch.ops.operators import D, D_T
from pytv4d_tpu_torch.solvers.cp import chambolle_pock
from pytv4d_tpu_torch.solvers.gd import subgradient_descent

F64 = torch.float64


def _vol(shape, seed=0):
    return torch.as_tensor(np.random.default_rng(seed).random(shape) * 255.0)


@pytest.mark.parametrize("scheme", ["upwind", "downwind", "central", "hybrid"])
@pytest.mark.parametrize("shape,reg_time", [((5, 3, 9, 8), 0.5),
                                            ((2, 2, 7, 7), 0.3),
                                            ((1, 4, 6, 6), 0.0)])
def test_gradient_matches_program(scheme, shape, reg_time):
    v = _vol(shape)
    kw = dict(reg_z_over_reg=0.7, reg_time=reg_time)
    g = ref_tv.Gradient(scheme, shape[0], shape[1], **kw)
    Dv = g.apply(v)
    torch.testing.assert_close(Dv, D(v, scheme, **kw), rtol=0, atol=1e-12)
    y = torch.as_tensor(np.random.default_rng(1).standard_normal(Dv.shape))
    torch.testing.assert_close(g.apply_T(y), D_T(y, scheme, **kw), rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("block", [1, 2, 8])
def test_cp_denoise_matches_program(block):
    x0 = _vol((5, 3, 12, 12), seed=2)
    cfg = TVConfig(scheme="hybrid", reg_time=0.5)
    ref = chambolle_pock(x0, n_iter=12, reg=25.0, cfg=cfg, fused=False)
    x, losses = ref_tv.cp_denoise(
        x0, n_iter=12, reg=25.0,
        grad=ref_tv.Gradient("hybrid", 5, 3, reg_time=0.5), block=block)
    torch.testing.assert_close(x, ref.x, rtol=1e-12, atol=1e-9)
    torch.testing.assert_close(losses, ref.loss, rtol=1e-12, atol=0)


@pytest.mark.parametrize("block", [1, 3, 8])
def test_gd_denoise_matches_program(block):
    x0 = _vol((6, 2, 10, 10), seed=3)
    cfg = TVConfig(scheme="hybrid", reg_time=0.5)
    ref = subgradient_descent(x0, n_iter=15, reg=25.0, step_size=5e-3,
                              cfg=cfg, fused=False)
    x, losses = ref_tv.gd_denoise(
        x0, n_iter=15, reg=25.0, step=5e-3,
        grad=ref_tv.Gradient("hybrid", 6, 2, reg_time=0.5), block=block)
    torch.testing.assert_close(x, ref.x, rtol=1e-11, atol=1e-9)
    torch.testing.assert_close(losses, ref.loss, rtol=1e-12, atol=0)


@pytest.mark.parametrize("n_angles,n_det", [(12, 16), (7, 20), (2, 16)])
def test_parallel_beam_matches_program(n_angles, n_det):
    shape = (2, 2, 16, 16)
    ang = np.linspace(0.0, np.pi, n_angles, endpoint=False)
    A, A_T = make_projector(shape, ang, n_det=n_det, method="spectral",
                            dtype=F64)
    pair = ref_ct.ParallelBeam(16, ang, n_det, "cpu")
    v = _vol(shape, seed=4)
    y = torch.as_tensor(np.random.default_rng(5).standard_normal(
        shape[:2] + (n_angles, n_det)))
    scale = float(torch.max(torch.abs(A(v))))
    torch.testing.assert_close(pair.A(v), A(v), rtol=0, atol=1e-11 * scale)
    back = A_T(y)
    torch.testing.assert_close(pair.A_T(y), back, rtol=0,
                               atol=1e-11 * float(torch.max(torch.abs(back))))
    # adjointness of the reference pair itself
    lhs = torch.sum(pair.A(v) * y)
    rhs = torch.sum(v * pair.A_T(y))
    assert abs(float(lhs - rhs)) <= 1e-11 * abs(float(lhs))


def test_cp_inverse_matches_program():
    shape = (3, 2, 16, 16)
    ang = np.linspace(0.0, np.pi, 10, endpoint=False)
    pair = ref_ct.ParallelBeam(16, ang, 16, "cpu")
    sino = pair.A(_vol(shape, seed=6) / 255.0)
    op_norm = ref_ct.power_norm(pair, shape)
    cfg = TVConfig(scheme="hybrid", reg_time=0.5)
    ref = cp_reconstruct(sino, ang, shape, n_iter=8, reg=0.5, cfg=cfg,
                         op_norm=op_norm, nonneg=True, method="spectral",
                         fused=False)
    x, losses = ref_ct.cp_inverse(
        pair, sino, shape, n_iter=8, reg=0.5, op_norm=op_norm, nonneg=True,
        grad=ref_tv.Gradient("hybrid", 3, 2, reg_time=0.5))
    torch.testing.assert_close(x, ref.x, rtol=1e-9, atol=1e-10)
    torch.testing.assert_close(losses, ref.loss, rtol=1e-10, atol=0)
