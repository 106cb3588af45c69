"""The port's 4D TGV-2 denoising against the benchmark's plain reference
(``benchmark/reference/tgv.py``, written from Bredies, Kunisch & Pock and
importing nothing of the program) in float64 on the CPU, on every path a
CPU tensor reaches: the plain loop and ``fused=True`` (the stream kernels'
and the objective kernel's plain versions); the reference's adjoints; the
channel-by-channel objective against the stacked form it replaced; the
dispatch that streams the default call on a card; and the TGV cell run
through the benchmark's harness at a tiny size, ``correct`` only where the
solve is."""

import numpy as np
import pytest
import torch

from benchmark.harness import run_cell
from benchmark.reference import tgv as ref
from benchmark.spec import Spec
from pytv4d_tpu_torch.models.denoise import TVDenoiser
from pytv4d_tpu_torch.solvers import tgv

SHAPE = (5, 3, 9, 11)            # odd, and no two axes alike
N_ITER = 7
A1, A0, DELTA = 25.0, 50.0, 3.0


def _volume(shape=SHAPE, seed=0):
    return torch.as_tensor(np.random.default_rng(seed).random(shape) * 255.0)


@pytest.mark.parametrize("block", [1, 2, 8])
@pytest.mark.parametrize("fused", [False, True], ids=["plain", "fused"])
@pytest.mark.parametrize("norm", ["iso", "aniso", "huber"])
def test_tgv_denoise_4d_matches_the_reference(norm, fused, block):
    """Every iteration's objective, and x and w after 7 iterations, of
    ``tgv_denoise(axes='4d')`` equal the reference's to float64 rounding;
    the reference's blocks of z-planes change nothing."""
    x0 = _volume()
    res = tgv.tgv_denoise(x0, n_iter=N_ITER, alpha1=A1, alpha0=A0, axes="4d",
                          norm=norm, huber_delta=DELTA, fused=fused)
    x, w, losses = ref.tgv_denoise(x0, n_iter=N_ITER, alpha1=A1, alpha0=A0,
                                   norm=norm, huber_delta=DELTA, block=block)
    assert res.loss.shape == (N_ITER,) and res.loss.dtype == torch.float64
    torch.testing.assert_close(res.loss, losses, rtol=1e-12, atol=0)
    torch.testing.assert_close(res.x, x, rtol=1e-12, atol=1e-10)
    torch.testing.assert_close(res.w, w, rtol=1e-12, atol=1e-10)


def test_the_reference_projects_its_duals():
    """The test above is no agreement of two idle loops: the first dual
    step's argument already leaves the iso ball of radius a1 at some
    voxels, so the projection acts."""
    x0 = _volume()
    sigma, _ = ref.steps()
    p = torch.zeros((SHAPE[0], 4) + SHAPE[1:], dtype=x0.dtype)
    xb = x0.clone()
    arg = p + sigma * ref.D(xb)
    assert float(torch.linalg.vector_norm(arg, dim=1).max()) > A1


@pytest.mark.parametrize("shape", [SHAPE, (1, 4, 6, 1), (2, 1, 3, 7)],
                         ids=["odd", "Nz1 Nc1", "M1"])
def test_reference_adjoints(shape):
    """<D x, p> = <x, D^T p> and <E w, q> = <w, E^T q>, size-1 axes
    included."""
    rng = np.random.default_rng(4)
    x = torch.as_tensor(rng.standard_normal(shape))
    p = torch.as_tensor(rng.standard_normal((shape[0], 4) + shape[1:]))
    w = torch.as_tensor(rng.standard_normal((shape[0], 4) + shape[1:]))
    q = torch.as_tensor(rng.standard_normal((shape[0], 10) + shape[1:]))
    lhs, rhs = torch.sum(ref.D(x) * p), torch.sum(x * ref.D_T(p))
    assert abs(float(lhs - rhs)) <= 1e-12 * max(1.0, abs(float(lhs)))
    lhs, rhs = torch.sum(ref.E(w) * q), torch.sum(w * ref.E_T(q))
    assert abs(float(lhs - rhs)) <= 1e-12 * max(1.0, abs(float(lhs)))


def _stacked_objective(x, w, x0, axes, alpha1, alpha0, norm, delta):
    """``tgv_objective`` as it was: every channel of ``D x - w`` and of
    ``E w`` stacked at full size, then reduced."""
    if x.dtype == torch.bfloat16:
        x, w, x0 = x.float(), w.float(), x0.float()
    ax = tgv.MODE_AXES[axes]
    return (0.5 * torch.sum(torch.square(x - x0))
            + alpha1 * tgv._tgv_norm_val(tgv._d_fwd_axes(x, ax) - w, norm,
                                         delta)
            + alpha0 * tgv._tgv_norm_val(tgv._sym_grad_axes(w, ax), norm,
                                         delta))


@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16])
@pytest.mark.parametrize("norm", ["iso", "aniso", "huber"])
@pytest.mark.parametrize("axes", ["2d", "3d", "4d"])
def test_channel_objective_equals_the_stacked_form(axes, norm, dtype):
    n = tgv.TGV_FIELDS[axes]
    rng = np.random.default_rng(7)
    x0 = torch.as_tensor(rng.random(SHAPE) * 255.0).to(dtype)
    x = (x0.double() + torch.as_tensor(
        rng.standard_normal(SHAPE))).to(dtype)
    w = torch.as_tensor(rng.standard_normal(
        (SHAPE[0], n) + SHAPE[1:]) * 20.0).to(dtype)
    got = tgv.tgv_objective(x, w, x0, axes, A1, A0, norm, DELTA)
    want = _stacked_objective(x, w, x0, axes, A1, A0, norm, DELTA)
    assert got.dtype == want.dtype
    rtol = 1e-12 if dtype == torch.float64 else 1e-5
    torch.testing.assert_close(got, want, rtol=rtol, atol=0)


def test_the_default_4d_call_streams_on_a_card():
    """``TVDenoiser(reg=25).tgv(x, axes='4d')`` with its per-iteration
    loss takes the stream kernels on a CUDA tensor the kernels take, at the
    benchmark cell's size too; a CPU tensor and float64 keep the plain
    loop."""
    for shape in ((96, 16, 512, 512), (4, 2, 64, 64)):
        for dtype in (torch.float32, torch.bfloat16):
            assert tgv._select_path(shape, dtype, "4d", 100, True, None, 0,
                                    False, True) == "stream"
        assert tgv._select_path(shape, torch.float64, "4d", 100, True, None,
                                0, False, True) == "plain"
        assert tgv._select_path(shape, torch.float32, "4d", 100, True, None,
                                0, False, False) == "plain"


def test_denoiser_tgv_fused_takes_the_objective_wrapper(monkeypatch):
    """On the stream path each iteration's loss comes from
    ``kernels.tgv_stream.tgv_stream_objective`` (on the CPU,
    ``tgv_objective`` itself), one call an iteration; the plain loop never
    calls it."""
    from pytv4d_tpu_torch.kernels import tgv_stream

    calls = []
    orig = tgv_stream.tgv_stream_objective

    def spy(*args, **kw):
        calls.append(args[3])
        return orig(*args, **kw)

    monkeypatch.setattr(tgv_stream, "tgv_stream_objective", spy)
    x0 = _volume((4, 2, 6, 5)).float()
    fused = TVDenoiser(reg=A1).tgv(x0, n_iter=5, axes="4d", fused=True)
    assert calls == ["4d"] * 5
    plain = TVDenoiser(reg=A1).tgv(x0, n_iter=5, axes="4d", fused=False)
    assert len(calls) == 5
    torch.testing.assert_close(fused.loss, plain.loss, rtol=1e-6, atol=0)
    assert fused.loss.dtype == torch.float32


TINY = {"shape": [6, 3, 11, 11]}


def _fault(monkeypatch, kind):
    """A broken TGV step: the stream step's update undone on half the
    volume, or the answer moved at one voxel."""
    if kind == "half":
        from pytv4d_tpu_torch.kernels import tgv_stream

        orig = tgv_stream.tgv_stream_step

        def step(x, xb, w, wb, p, q, x0, **kw):
            old = x.clone()
            out = orig(x, xb, w, wb, p, q, x0, **kw)
            out[0][x.shape[0] // 2:] = old[x.shape[0] // 2:]
            return out

        monkeypatch.setattr(tgv_stream, "tgv_stream_step", step)
    elif kind == "answer":
        from pytv4d_tpu_torch.models import denoise

        orig = denoise.tgv_denoise

        def solver(*args, **kw):
            res = orig(*args, **kw)
            x = res.x.clone()
            x.view(-1)[x.numel() // 2] += 0.1 * float(x.max() - x.min())
            return res._replace(x=x)

        monkeypatch.setattr(denoise, "tgv_denoise", solver)


@pytest.mark.parametrize("fault", [None, "half", "answer"])
def test_the_tgv_cell_is_correct_only_where_the_solve_is(monkeypatch, fault):
    """The ``tgv4d_f32`` cell through the harness on the CPU at a tiny size
    (the plain loop there; ``fused`` forced through a stand-in for the
    solver's default so that the stream step runs): ``correct`` against the
    reference under its limits, and false under a broken step or answer."""
    orig_select = tgv._select_path
    monkeypatch.setattr(tgv, "_select_path", lambda *a: orig_select(
        *a[:5], True, *a[6:]))
    _fault(monkeypatch, fault)
    r = run_cell(Spec(), "tgv4d_f32", 2 ** 31 + 3, 0.0, False, "cpu", 0.0,
                 TINY)
    assert r["correct"] == (fault is None), r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 1


@pytest.mark.parametrize("seed", [2 ** 31 + 1, 2 ** 31 + 2, 2 ** 31 + 3])
def test_the_traced_tgv_cell_keeps_a_solve_for_every_seed(seed):
    """A traced run of ``tgv4d_f32`` reaches the solve the seed picks to
    compare (``seed % keep_of_first``, here 0, 1 and 2), so that it gives a
    result line, ``correct``, whatever the seed (at 5 iterations a solve,
    which leave the count of solves as it is)."""
    spec = Spec()
    traffic = spec.traffic
    spec.traffic = lambda name: dict(traffic(name), n_iter=5)
    r = run_cell(spec, "tgv4d_f32", seed, 0.0, True, "cpu", 0.0, TINY)
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] >= 1
