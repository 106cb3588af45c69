"""The TGV objective kernel on the card (``csrc/tgv_stream.cu``
``tgv_obj_kernel``, ``kernels.tgv_stream.tgv_stream_objective``) against
its plain version, ``solvers.tgv.tgv_objective``, evaluated in float64 on
the same stored values: every mode and norm, float32 and bfloat16 storage,
planes that are and are not a multiple of a block; one launch a call; and
the default 4d call streaming with its per-iteration loss: one PQ, one XW
and one objective launch an iteration, iterates bit-equal to the solve
without the loss, losses beside the plain loop's.  Needs a CUDA device and
``nvcc``, and skips without them."""

import numpy as np
import pytest
import torch

from pytv4d_tpu_torch.kernels import build, tgv_stream
from pytv4d_tpu_torch.models.denoise import TVDenoiser
from pytv4d_tpu_torch.solvers import tgv
from pytv4d_tpu_torch.utils import profiling

# f32 per-voxel terms summed in float32 per block, then by torch.sum
RTOL = {torch.float32: 2e-6, torch.bfloat16: 2e-6}
A1, A0, DELTA = 25.0, 50.0, 3.0
# planes that are and are not a multiple of a block, few and many frames
SHAPES = {"aligned": (3, 2, 32, 64), "odd": (2, 3, 13, 37),
          "ragged t": (3, 5, 16, 24), "runs": (2, 8, 8, 40)}


def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    try:
        build.find_nvcc()
    except build.BuildError:
        pytest.skip("needs nvcc to build the kernel")


def _state(shape, mode, dtype, seed=5):
    rng = np.random.default_rng(seed)
    n = tgv.TGV_FIELDS[mode]
    x0 = rng.random(shape) * 255.0
    x = x0 + 5.0 * rng.standard_normal(shape)
    w = 3.0 * rng.standard_normal((shape[0], n) + tuple(shape[1:]))
    return tuple(torch.as_tensor(a, device="cuda").to(dtype)
                 for a in (x, w, x0))


@pytest.mark.parametrize("layout", list(SHAPES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("norm", ["iso", "aniso", "huber"])
@pytest.mark.parametrize("mode", ["2d", "3d", "4d"])
def test_objective_kernel_matches_its_plain_version(mode, norm, dtype,
                                                    layout):
    _need_card()
    x, w, x0 = _state(SHAPES[layout], mode, dtype)
    before = profiling.counters()["launch.B6.obj"]
    got = tgv_stream.tgv_stream_objective(x, w, x0, mode, A1, A0, norm,
                                          DELTA)
    assert profiling.counters()["launch.B6.obj"] == before + 1
    assert got.dtype == torch.float32 and got.is_cuda and got.ndim == 0
    want = tgv.tgv_objective(x.double(), w.double(), x0.double(), mode, A1,
                             A0, norm, DELTA)
    rel = abs(float(got) - float(want)) / abs(float(want))
    assert rel <= RTOL[dtype], rel


def test_objective_kernel_refuses_what_it_cannot_take():
    _need_card()
    x, w, x0 = _state(SHAPES["aligned"], "4d", torch.float32)
    with pytest.raises(ValueError, match="w must be"):
        tgv_stream.tgv_stream_objective(x, w[:, :3].contiguous(), x0, "4d",
                                        A1, A0)
    with pytest.raises(ValueError, match="x0 must be"):
        tgv_stream.tgv_stream_objective(x, w, x0.double(), "4d", A1, A0)
    with pytest.raises(ValueError, match="contiguous"):
        tgv_stream.tgv_stream_objective(x.transpose(2, 3), w, x0, "4d", A1,
                                        A0)
    with pytest.raises(ValueError, match="stream_fits"):
        tgv_stream.tgv_stream_objective(x.double(), w.double(), x0.double(),
                                        "4d", A1, A0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_the_default_4d_call_streams_with_its_loss(dtype):
    _need_card()
    n_iter, shape = 12, (8, 4, 64, 64)
    noisy = torch.as_tensor(np.random.default_rng(2).random(shape) * 255.0,
                            device="cuda").to(dtype)
    den = TVDenoiser(reg=A1)
    profiling.clear_counters()
    res = den.tgv(noisy, n_iter=n_iter, axes="4d")
    c = profiling.counters()
    assert (c["launch.B6.pq"], c["launch.B6.xw"], c["launch.B6.obj"]) == \
        (n_iter, n_iter, n_iter)
    assert res.loss.shape == (n_iter,) and res.loss.dtype == torch.float32
    lean = den.tgv(noisy, n_iter=n_iter, axes="4d", compute_loss=False)
    assert torch.equal(res.x, lean.x) and torch.equal(res.w, lean.w)
    profiling.clear_counters()
    sampled = den.tgv(noisy, n_iter=n_iter, axes="4d", loss_every=4)
    assert profiling.counters()["launch.B6.obj"] == 3
    assert torch.equal(sampled.loss, res.loss[3::4])
    # the loss of the same iterates, by the plain objective in float64
    st = res.state
    want = tgv.tgv_objective(st.x.double(), st.w.double(), noisy.double(),
                             "4d", A1, 2 * A1)
    rel = abs(float(res.loss[-1]) - float(want)) / float(want)
    assert rel <= 2e-6, rel
    if dtype == torch.float32:
        plain = den.tgv(noisy, n_iter=n_iter, axes="4d", fused=False)
        torch.testing.assert_close(res.loss, plain.loss, rtol=1e-5, atol=0)
        torch.testing.assert_close(res.x, plain.x, rtol=1e-5, atol=1e-3)
