"""The plain versions of the TGV kernels (what the wrappers run on the CPU)
against the JAX package's Pallas kernels in interpret mode: the streaming
step pass by pass, the whole-solve kernel, bf16 storage, the fused dispatch
on CPU tensors, and the guards."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytv4d_tpu.kernels.tgv_resident as jres
import pytv4d_tpu.kernels.tgv_stream as jstream
import pytv4d_tpu.solvers.tgv as jtgv
from pytv4d_tpu_torch.kernels import tgv_resident, tgv_stream
from pytv4d_tpu_torch.solvers import tgv
from pytv4d_tpu_torch.utils import profiling

MODES = ["2d", "3d", "4d"]
NORMS = ["iso", "aniso", "huber"]
A1, A0, DELTA = 0.2, 0.4, 0.3
TOL = dict(rtol=1e-12, atol=1e-12)


def _state(shape, mode, seed):
    """A seeded non-zero state in the public layouts, so every channel and
    boundary gate is live: (x, xb, w, wb, p, q, x0) as numpy f64."""
    rng = np.random.default_rng(seed)
    Nz, M, Nr, Nc = shape
    n = tgv.TGV_FIELDS[mode]
    n_q = n * (n + 1) // 2

    def wlike(c):
        return rng.standard_normal((Nz, c, M, Nr, Nc))

    x0 = rng.random(shape)
    return (x0 + 0.1 * rng.standard_normal(shape),
            x0 + 0.1 * rng.standard_normal(shape),
            wlike(n), wlike(n), wlike(n), wlike(n_q), x0)


@pytest.mark.parametrize("shape", [(3, 2, 16, 16), (1, 1, 8, 128),
                                   (2, 2, 8, 2)],
                         ids=["3x2x16x16", "Nz1M1", "N2"])
@pytest.mark.parametrize("norm", NORMS)
@pytest.mark.parametrize("mode", MODES)
def test_stream_passes_match_pallas(mode, norm, shape):
    """``tgv_pq_plain`` and ``tgv_xw_plain`` against the interpreted Pallas
    passes ``step.pq`` / ``step.xw`` (internal layout on the JAX side)."""
    x, xb, w, wb, p, q, x0 = _state(shape, mode, 21)
    step = jstream.make_tgv_stream_step(
        shape, mode, A1, A0, dtype_name="float64", interpret=True, norm=norm,
        huber_delta=DELTA)
    ti, fi = jstream.to_internal, jstream.from_internal
    jp, jq = step.pq(jnp.asarray(xb), ti(jnp.asarray(wb)),
                     ti(jnp.asarray(p)), ti(jnp.asarray(q)))
    T = torch.tensor
    kw = dict(mode=mode, alpha1=A1, alpha0=A0, norm=norm, huber_delta=DELTA)
    tp, tq = T(p), T(q)
    out = tgv_stream.tgv_pq_plain(T(xb), T(wb), tp, tq, **kw)
    assert out[0] is tp and out[1] is tq  # updated in place
    np.testing.assert_allclose(tp.numpy(), np.asarray(fi(jp)), **TOL)
    np.testing.assert_allclose(tq.numpy(), np.asarray(fi(jq)), **TOL)

    jx, jxb, jw, jwb = step.xw(jnp.asarray(x), jnp.asarray(x0), jp,
                               ti(jnp.asarray(w)), jq)
    tx, tw = T(x), T(w)
    ox, oxb, ow, owb = tgv_stream.tgv_xw_plain(tx, T(x0), tp, tw, tq,
                                               mode=mode)
    assert ox is tx and ow is tw
    for got, ref in ((ox, jx), (oxb, jxb), (ow, fi(jw)), (owb, fi(jwb))):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


@pytest.mark.parametrize("norm", NORMS)
def test_resident_matches_pallas(norm):
    """``tgv_resident_plain`` against the interpreted whole-solve Pallas
    kernel at (2, 2, 12, 20), 20 iterations: the state and the losses."""
    shape = (2, 2, 12, 20)
    x0 = np.random.default_rng(7).random(shape)
    solve = jres.make_resident_tgv_solver(
        shape, 20, 2.0, 4.0, dtype_name="float64", interpret=True, norm=norm,
        huber_delta=DELTA)
    ref = solve(jnp.asarray(x0))
    got = tgv_resident.tgv_resident_plain(torch.tensor(x0), 20, 2.0, 4.0,
                                          norm=norm, huber_delta=DELTA)
    assert len(got) == len(ref) == 7
    for name, a, b in zip("x w xb wb p q".split(), got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), err_msg=name,
                                   rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(got[6].numpy(), np.asarray(ref[6]), rtol=1e-10)
    lean = tgv_resident.tgv_resident_solve(torch.tensor(x0), 20, 2.0, 4.0,
                                           compute_loss=False, norm=norm,
                                           huber_delta=DELTA)
    assert lean[6].shape == (0,) and torch.equal(lean[0], got[0])


@pytest.mark.parametrize("mode", ["3d", "4d"])
def test_stream_bf16_storage(mode):
    """bf16 state storage on the streaming path (compute stays f32) against
    the JAX package's bf16 run, at its bar; the outputs keep bf16."""
    x32 = np.random.default_rng(13).random((3, 2, 16, 16)).astype(np.float32)
    kw = dict(n_iter=10, alpha1=0.2, alpha0=0.4, axes=mode,
              compute_loss=False, fused=True)
    ref = jtgv.tgv_denoise(jnp.asarray(x32).astype(jnp.bfloat16), **kw)
    out = tgv.tgv_denoise(torch.tensor(x32).to(torch.bfloat16), **kw)
    assert out.x.dtype == out.w.dtype == torch.bfloat16
    assert all(t.dtype == torch.bfloat16 for t in out.state)
    np.testing.assert_allclose(out.x.float().numpy(),
                               np.asarray(ref.x, np.float32),
                               atol=3e-2, rtol=3e-2)
    f32 = tgv.tgv_denoise(torch.tensor(x32), **kw)
    np.testing.assert_allclose(out.x.float().numpy(), f32.x.numpy(),
                               atol=3e-2, rtol=3e-2)


def _launches():
    got = profiling.counters()
    return got["launch.B6.pq"], got["launch.B6.xw"], got["launch.B7"]


@pytest.mark.parametrize("mode", MODES)
def test_fused_true_on_cpu_goes_through_the_wrappers(mode, monkeypatch):
    """``fused=True`` on CPU tensors runs the wrappers (their plain
    versions; no kernel launch is counted) and equals ``fused=False``."""
    calls = {"pq": 0, "xw": 0, "resident": 0}
    for mod, name, key in ((tgv_stream, "tgv_pq_plain", "pq"),
                           (tgv_stream, "tgv_xw_plain", "xw"),
                           (tgv_resident, "tgv_resident_plain", "resident")):
        def counted(*a, _fn=getattr(mod, name), _key=key, **k):
            calls[_key] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(mod, name, counted)
    x = torch.tensor(np.random.default_rng(11).random((3, 2, 16, 16)))
    before = _launches()
    kw = dict(n_iter=8, alpha1=2.0, alpha0=4.0, axes=mode)
    ref = tgv.tgv_denoise(x, fused=False, compute_loss=False, **kw)
    assert calls == {"pq": 0, "xw": 0, "resident": 0}
    # a sampled loss sends every mode to the streaming pair
    fus = tgv.tgv_denoise(x, fused=True, loss_every=4, **kw)
    assert calls == {"pq": 8, "xw": 8, "resident": 0}
    np.testing.assert_allclose(fus.x.numpy(), ref.x.numpy(), **TOL)
    np.testing.assert_allclose(fus.w.numpy(), ref.w.numpy(), **TOL)
    sampled = tgv.tgv_denoise(x, fused=False, loss_every=4, **kw)
    np.testing.assert_allclose(fus.loss.numpy(), sampled.loss.numpy(),
                               rtol=1e-12)
    # resumed: the streaming pair again, never the whole-solve kernel
    half = tgv.tgv_denoise(x, fused=True, compute_loss=False,
                           **dict(kw, n_iter=4))
    rest = tgv.tgv_denoise(x, fused=True, compute_loss=False,
                           state=half.state, **dict(kw, n_iter=4))
    np.testing.assert_allclose(rest.x.numpy(), ref.x.numpy(), **TOL)
    assert calls == {"pq": 16, "xw": 16, "resident": 0}
    if mode == "2d":
        whole = tgv.tgv_denoise(x, fused=True, **kw)  # with the loss
        assert calls == {"pq": 16, "xw": 16, "resident": 1}
        full = tgv.tgv_denoise(x, fused=False, **kw)
        np.testing.assert_allclose(whole.x.numpy(), full.x.numpy(), **TOL)
        np.testing.assert_allclose(whole.loss.numpy(), full.loss.numpy(),
                                   rtol=1e-12)
    assert _launches() == before  # nothing launched on the CPU


def test_select_path_is_the_port_dispatch():
    """The port's one-device dispatch table: resident for 2d whole solves,
    stream wherever the CUDA kernels take the shape (the per-iteration loss
    by the objective kernel), plain otherwise.  It departs from the JAX
    package's table on purpose where the loss is asked for every
    iteration: there the JAX package runs its plain loop, and raises under
    ``fused=True`` for 3d / 4d."""
    f32, f64, shape = torch.float32, torch.float64, (4, 2, 64, 64)

    def path(axes="2d", compute_loss=True, fused=None, loss_every=0,
             has_state=False, on_cuda=True, dtype=f32):
        return tgv._select_path(shape, dtype, axes, 20, compute_loss, fused,
                                loss_every, has_state, on_cuda)

    assert path(fused=False) == "plain"
    assert path(on_cuda=False) == "plain"            # auto, CPU tensor
    assert path() == "resident"
    assert path(compute_loss=False) == "resident"
    assert path(loss_every=5) == "stream"
    assert path(has_state=True) == "stream"          # per-iteration loss
    assert path(has_state=True, compute_loss=False) == "stream"
    assert path(dtype=f64) == "plain"
    assert path(dtype=f64, compute_loss=False) == "plain"
    assert path(dtype=torch.bfloat16, compute_loss=False) == "stream"
    for axes in ("3d", "4d"):
        assert path(axes) == "stream"
        assert path(axes, compute_loss=False) == "stream"
        assert path(axes, loss_every=4) == "stream"
        assert path(axes, fused=True) == "stream"
    assert path(fused=True, on_cuda=False, dtype=f64) == "resident"
    assert path(fused=True, has_state=True) == "stream"
    assert path(fused=True, has_state=True, compute_loss=False) == "stream"


def test_guards_and_argument_checks():
    assert tgv_stream.stream_fits((32, 8, 256, 256), "4d")
    # no Nc % 128 or Nr % 8 condition: those were VMEM's
    assert tgv_stream.stream_fits((3, 2, 5, 7), "3d", torch.bfloat16)
    assert not tgv_stream.stream_fits((32, 8, 256, 256), "4d", torch.float64)
    assert not tgv_stream.stream_fits((300, 300, 8, 8), "2d")  # Nz*M > grid y
    assert not tgv_stream.stream_fits((8, 256, 256), "2d")
    assert not tgv_stream.stream_fits((2, 2, 8, 8), "5d")
    assert tgv_resident.tgv_resident_fits((1, 1, 256, 256), torch.float32, 300)
    assert tgv_resident.tgv_resident_fits((300, 300, 8, 8))
    assert not tgv_resident.tgv_resident_fits((1, 1, 256, 256),
                                              torch.bfloat16)
    assert not tgv_resident.tgv_resident_fits((1, 1, 2048, 2048))
    # without the loss the streaming kernels take slices above 512 x 512
    assert tgv_resident.tgv_resident_fits((1, 1, 1024, 1024))
    assert not tgv_resident.tgv_resident_fits((1, 1, 1024, 1024),
                                              compute_loss=False)
    assert tgv._select_path((1, 1, 1024, 1024), torch.float32, "2d", 20,
                            False, None, 0, False, True) == "stream"
    x, xb, w, wb, p, q, x0 = (torch.tensor(a) for a in
                              _state((2, 2, 4, 6), "3d", 1))
    kw = dict(mode="3d", alpha1=A1, alpha0=A0)
    with pytest.raises(ValueError, match="q must be"):
        tgv_stream.tgv_pq(xb, wb, p, q[:, :3].contiguous(), **kw)
    with pytest.raises(ValueError, match="wb must be"):
        tgv_stream.tgv_pq(xb, wb.float(), p, q, **kw)
    with pytest.raises(ValueError, match="contiguous"):
        tgv_stream.tgv_xw(x, x0, p.transpose(3, 4), w, q, mode="3d")
    with pytest.raises(ValueError, match="mode must be"):
        tgv_stream.tgv_pq(xb, wb, p, q, **dict(kw, mode="5d"))
    with pytest.raises(ValueError, match="norm must be"):
        tgv_stream.tgv_params((2, 2, 4, 6), "3d", A1, A0, 1.0, "bogus", 1.0)
    with pytest.raises(ValueError, match="Nz, M, Nr, Nc"):
        tgv_resident.tgv_resident_solve(x0[0], 2, A1, A0)
