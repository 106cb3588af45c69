"""The port's parallel-beam CT (``models/ct.py``) against the JAX package's
gather projector on the same seeded numpy inputs: ``radon``, the exact
adjoint, ``fbp``, ``cp_reconstruct``, the projector cache, the paths once
unported (the spectral ones: ``test_torch_ct_spectral*.py``; fan and cone
beams: ``test_torch_ct_fan.py``, ``test_torch_ct_cone.py``), and where a
call computes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytv4d_tpu.models.ct as jct
from pytv4d_tpu.core.config import TVConfig as JConfig
from pytv4d_tpu_torch import interop
from pytv4d_tpu_torch.core.config import TVConfig
from pytv4d_tpu_torch.kernels import fused
from pytv4d_tpu_torch.models import ct

SHAPE = (2, 2, 32, 32)
SHARED = np.linspace(0.0, np.pi, 12, endpoint=False)
PER_FRAME = np.stack([SHARED, SHARED + 0.1])
ANGLES = {"shared": SHARED, "per-frame": PER_FRAME}
# sinogram values are sums of 32 bilinear samples of O(1) pixels.  f64: both
# packages compute the same coordinates and weights to a few ulps (1e-12
# relative, with an absolute floor for rays that graze the image).  f32: a
# coordinate of size 32 carries 2e-6 of round-off, and a sample moves by
# that times the local slope, so 1e-5 of the sinogram's scale
TOL = {np.float64: dict(rtol=1e-12, atol=1e-12),
       np.float32: dict(rtol=1e-5, atol=2e-4)}
TDTYPE = {np.float64: torch.float64, np.float32: torch.float32}


def _volume(dtype, seed=0):
    return np.random.default_rng(seed).random(SHAPE).astype(dtype)


@pytest.mark.parametrize("n_det", (None, 40))
@pytest.mark.parametrize("dtype", (np.float64, np.float32))
@pytest.mark.parametrize("which", list(ANGLES))
def test_radon_matches_jax(which, dtype, n_det):
    vol, angles = _volume(dtype), ANGLES[which]
    want = np.asarray(jct.radon(jnp.asarray(vol), angles, n_det=n_det))
    got = ct.radon(torch.tensor(vol), angles, n_det=n_det)
    assert got.dtype == TDTYPE[dtype]
    assert tuple(got.shape) == (2, 2, 12, n_det or 32) == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL[dtype])
    # angle batches (a ragged last one) give the single sweep's values
    for batch in (5, 1, 12):
        again = ct.radon(torch.tensor(vol), angles, n_det=n_det,
                         angle_batch=batch)
        np.testing.assert_allclose(again.numpy(), got.numpy(), rtol=0,
                                   atol=1e-5 if dtype == np.float32 else 1e-13)


def test_radon_border_samples_keep_their_inside_weight():
    """A sample within one pixel outside the image still gets the weight of
    its inside corner (``map_coordinates(order=1, mode='constant')``): a
    detector wider than the image sees the half-open border."""
    vol = np.ones((1, 1, 8, 8))
    angles = np.array([0.0, np.pi / 2, 0.3])
    want = np.asarray(jct.radon(jnp.asarray(vol), angles, n_det=11))
    got = ct.radon(torch.tensor(vol), angles, n_det=11).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    # at angle 0 the detector cells at +-4.5 sit half a pixel outside
    assert got[0, 0, 0, 1] == pytest.approx(4.0) and got[0, 0, 0, 0] == 0.0


@pytest.mark.parametrize("dtype", (np.float64, np.float32))
@pytest.mark.parametrize("which", list(ANGLES))
def test_projector_adjointness_and_jax_adjoint(which, dtype):
    """``<y, A x> = <A^T y, x>`` to 1e-12 (f64) / 1e-5 (f32) relative, with
    and without angle batches, and A^T equals the JAX package's vjp."""
    angles = ANGLES[which]
    rng = np.random.default_rng(1)
    x = torch.tensor(rng.standard_normal(SHAPE).astype(dtype))
    y = torch.tensor(rng.standard_normal((2, 2, 12, 40)).astype(dtype))
    rel = 1e-12 if dtype == np.float64 else 1e-5
    for batch in (None, 5):
        A, A_T = ct.make_projector(SHAPE, angles, n_det=40,
                                   dtype=TDTYPE[dtype], angle_batch=batch)
        lhs, rhs = float(torch.sum(y * A(x))), float(torch.sum(A_T(y) * x))
        assert lhs == pytest.approx(rhs, rel=rel)
    _, jA_T = jct.make_projector(SHAPE, angles, n_det=40, dtype=dtype,
                                 method="gather")
    back = A_T(y)
    assert tuple(back.shape) == SHAPE and back.is_contiguous()
    np.testing.assert_allclose(back.numpy(), np.asarray(jA_T(jnp.asarray(
        y.numpy()))), **TOL[dtype])


@pytest.mark.parametrize("dtype", (np.float64, np.float32))
@pytest.mark.parametrize("filter_name", ct._FILTER_WINDOWS)
def test_fbp_matches_jax(filter_name, dtype):
    """All five windows, shared and per-frame angles, and ``n_out``: f64 to
    1e-12, f32 to 1e-5 of the image's scale (an FFT pair and 12 linear
    interpolations per pixel)."""
    tol = (dict(rtol=1e-12, atol=1e-12) if dtype == np.float64
           else dict(rtol=1e-5, atol=2e-5))
    sino = np.asarray(jct.radon(jnp.asarray(_volume(dtype)), PER_FRAME))
    for angles, n_out in ((PER_FRAME, None), (SHARED, 30)):
        want = np.asarray(jct.fbp(jnp.asarray(sino), angles, n_out=n_out,
                                  filter_name=filter_name, method="gather"))
        got = ct.fbp(torch.tensor(sino), angles, n_out=n_out,
                     filter_name=filter_name)
        assert got.dtype == TDTYPE[dtype] and tuple(got.shape) == want.shape
        np.testing.assert_allclose(got.numpy(), want, **tol)
    with pytest.raises(ValueError, match="unknown filter"):
        ct.fbp(torch.tensor(sino), SHARED, filter_name="boxcar")


def _phantom_problem(dtype, angles, background=0.0):
    vol = np.full(SHAPE, background)
    vol[:, :, 10:22, 8:20] = 1.0
    vol[:, 1, 14:18, 12:26] += 0.5
    sino = np.asarray(jct.radon(jnp.asarray(vol), angles))
    sino = sino + 0.05 * np.random.default_rng(2).standard_normal(sino.shape)
    return sino.astype(dtype)


@pytest.mark.parametrize("fidelity", ("l2", "kl"))
@pytest.mark.parametrize("which", list(ANGLES))
def test_cp_reconstruct_f64_matches_jax(which, fidelity):
    """Ten iterations in f64 with the power-method step: loss and x to
    1e-9, and every field of the state."""
    angles = ANGLES[which]
    kw = dict(n_iter=10, reg=0.1, nonneg=True)
    if fidelity == "kl":
        # Poisson counts: a positive background and start keep every ray's
        # A x positive, away from the clamp inside the reported KL value
        sino = _phantom_problem(np.float64, angles, background=0.3)
        kw.update(fidelity="kl", fidelity_weight=0.5,
                  x_init=np.full(SHAPE, 0.5))
    else:
        sino = _phantom_problem(np.float64, angles)
    cfg_kw = dict(scheme="hybrid", reg_time=0.5)
    want = jct.cp_reconstruct(jnp.asarray(sino), angles, SHAPE,
                              cfg=JConfig(**cfg_kw), method="gather", **kw)
    got = ct.cp_reconstruct(torch.tensor(sino), angles, SHAPE,
                            cfg=TVConfig(**cfg_kw), **kw)
    assert float(sino.min()) > 0.0 or fidelity == "l2"
    assert isinstance(got, ct.CPReconResult) and got.x.dtype == torch.float64
    np.testing.assert_allclose(got.loss.numpy(), np.asarray(want.loss),
                               rtol=1e-9)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=1e-9,
                               atol=1e-12)
    for a, b in zip(got.state, want.state):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-9,
                                   atol=1e-11)


@pytest.mark.parametrize("variant", ("fused", "plain", "bf16-dual",
                                     "loss_every", "precond", "l1"))
def test_cp_reconstruct_f32_matches_jax(variant, monkeypatch):
    """Ten iterations in f32 against the JAX package (its fused path in the
    interpreter): the loss to 1e-4.  The auto-selected path is the fused
    one: one pass A and one pass B per iteration."""
    kw = {"fused": dict(), "plain": dict(fused=False),
          "bf16-dual": dict(dual_dtype="bfloat16"),
          "loss_every": dict(loss_every=5, x_init="fbp"),
          "precond": dict(precond=True),
          "l1": dict(fidelity="l1", fidelity_weight=0.5)}[variant]
    sino = _phantom_problem(np.float32, SHARED)
    n_dual = [0]
    plain = fused.tv_dual_plain

    def counted(*a, **k):
        n_dual[0] += 1
        return plain(*a, **k)

    monkeypatch.setattr(fused, "tv_dual_plain", counted)
    jkw, tkw = dict(kw), dict(kw)
    if kw.get("x_init") == "fbp":
        jkw["x_init"] = jct.fbp(jnp.asarray(sino), SHARED, method="gather")
        tkw["x_init"] = ct.fbp(torch.tensor(sino), SHARED)
    common = dict(n_iter=10, reg=0.1, nonneg=True)
    cfg_kw = dict(scheme="hybrid", reg_time=0.5)
    want = jct.cp_reconstruct(jnp.asarray(sino), SHARED, SHAPE,
                              cfg=JConfig(**cfg_kw), method="gather",
                              **common, **jkw)
    got = ct.cp_reconstruct(torch.tensor(sino), SHARED, SHAPE,
                            cfg=TVConfig(**cfg_kw), **common, **tkw)
    assert n_dual[0] == (0 if variant in ("plain", "precond") else 10)
    assert got.loss.shape == want.loss.shape
    np.testing.assert_allclose(got.loss.numpy(), np.asarray(want.loss),
                               rtol=1e-3 if variant == "bf16-dual" else 1e-4)
    np.testing.assert_allclose(
        got.x.numpy(), np.asarray(want.x), rtol=1e-3,
        atol=5e-2 if variant == "bf16-dual" else 1e-3)


def test_cp_reconstruct_resumes_a_jax_state():
    sino = _phantom_problem(np.float64, SHARED)
    kw = dict(n_iter=4, reg=0.1, op_norm=20.0)
    first = jct.cp_reconstruct(jnp.asarray(sino), SHARED, SHAPE,
                               method="gather", **kw)
    want = jct.cp_reconstruct(jnp.asarray(sino), SHARED, SHAPE,
                              method="gather", state=first.state, **kw)
    state = interop.inverse_state_from_numpy(
        [np.asarray(a) for a in first.state], device="cpu")
    got = ct.cp_reconstruct(torch.tensor(sino), SHARED, SHAPE, state=state,
                            **kw)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=1e-9,
                               atol=1e-12)


def test_estimate_op_norm_matches_jax():
    """Same seeded start vector, 12 power iterations: 1e-12 in f64."""
    jA, jA_T = jct.make_projector(SHAPE, SHARED, dtype=np.float64,
                                  method="gather")
    A, A_T = ct.make_projector(SHAPE, SHARED, dtype=torch.float64)
    want = float(jct.estimate_op_norm(jA, jA_T, SHAPE, dtype=np.float64))
    got = ct.estimate_op_norm(A, A_T, SHAPE, dtype=torch.float64,
                              device="cpu")
    assert float(got) == pytest.approx(want, rel=1e-12)


def test_projector_cache_is_lru_and_clears():
    ct.clear_projector_cache()
    pair = ct.make_projector(SHAPE, SHARED)
    assert ct.make_projector(SHAPE, SHARED) is pair
    assert ct.make_projector(SHAPE, list(SHARED)) is pair  # same geometry
    assert ct.make_projector(SHAPE, SHARED, n_det=40) is not pair
    assert ct.make_projector(SHAPE, SHARED, dtype=torch.float64) is not pair
    assert ct.make_projector(SHAPE, SHARED, angle_batch=4) is not pair
    for k in range(ct._PROJECTOR_CACHE_MAX - 4):  # fill to the limit
        ct.make_projector(SHAPE, SHARED + 0.01 * (k + 1))
    assert len(ct._PROJECTOR_CACHE) == ct._PROJECTOR_CACHE_MAX
    assert ct.make_projector(SHAPE, SHARED) is pair       # a hit refreshes
    ct.make_projector(SHAPE, SHARED + 1.0)                # evicts the oldest
    assert len(ct._PROJECTOR_CACHE) == ct._PROJECTOR_CACHE_MAX
    assert ct.make_projector(SHAPE, SHARED) is pair       # ... not this one
    assert ct.make_projector(SHAPE, SHARED, n_det=40) is not None
    ct.clear_projector_cache()
    assert len(ct._PROJECTOR_CACHE) == 0
    assert ct.make_projector(SHAPE, SHARED) is not pair


@pytest.mark.parametrize("what", ("spectral-projector", "spectral-recon",
                                  "spectral-fbp", "cone-order-2"))
def test_unported_paths_raise_not_implemented(what):
    """The spectral calls that raised until ROADMAP.md item 15 run and
    match the JAX package in float64, and so does the cone's order 2, which
    raised until item 15b (the name is older than both)."""
    import pytv4d_tpu.models.ct_spectral as jcs
    from pytv4d_tpu_torch.models import ct_spectral

    sino = _phantom_problem(np.float64, SHARED)
    x = _volume(np.float64)
    got, want = {
        "cone-order-2": lambda: (
            ct_spectral.radon_cone_spectral(
                torch.tensor(x), SHARED, ct.ConeBeamGeometry(64.0, 32.0),
                order=2),
            jcs.radon_cone_spectral(
                jnp.asarray(x), SHARED, jct.ConeBeamGeometry(64.0, 32.0),
                order=2)),
        "spectral-projector": lambda: (
            ct.make_projector(SHAPE, SHARED, dtype=torch.float64,
                              method="spectral")[0](torch.tensor(x)),
            jcs.make_spectral_projector(SHAPE, SHARED, dtype=jnp.float64)[0](
                jnp.asarray(x))),
        "spectral-recon": lambda: (
            ct.cp_reconstruct(torch.tensor(sino), SHARED, SHAPE, n_iter=3,
                              method="spectral").x,
            jct.cp_reconstruct(jnp.asarray(sino), SHARED, SHAPE, n_iter=3,
                               method="spectral").x),
        "spectral-fbp": lambda: (
            ct.fbp(torch.tensor(sino), SHARED, method="spectral"),
            jct.fbp(jnp.asarray(sino), SHARED, method="spectral")),
    }[what]()
    want = np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-9,
                               atol=1e-11 * np.abs(want).max())


def test_argument_checks():
    with pytest.raises(ValueError, match="unknown projector method"):
        ct.make_projector(SHAPE, SHARED, method="fourier")
    with pytest.raises(ValueError, match="sinogram shape"):
        ct.cp_reconstruct(torch.zeros((2, 2, 12, 31)), SHARED, SHAPE,
                          n_iter=1)
    with pytest.raises(ValueError, match=r"\(Nz, M, N, N\)"):
        ct.radon(torch.zeros((2, 2, 8, 9)), SHARED)
    with pytest.raises(ValueError, match="angles must be"):
        ct.radon(torch.zeros(SHAPE), np.zeros((3, 12)))
    assert ct._resolve_method("auto") == ct._resolve_method("gather") \
        == "gather"


def test_numpy_goes_to_the_card_or_raises():
    """numpy in without a GPU raises; ``device="cpu"`` computes, and equals
    the CPU tensor's result."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: a numpy input runs there")
    vol = _volume(np.float32)
    sino = ct.radon(vol, SHARED, device="cpu")
    assert sino.device.type == "cpu"
    assert torch.equal(sino, ct.radon(torch.tensor(vol), SHARED))
    kw = dict(n_iter=2, reg=0.1, op_norm=20.0)
    calls = {
        "radon": lambda **d: ct.radon(vol, SHARED, **d),
        "fbp": lambda **d: ct.fbp(sino.numpy(), SHARED, **d),
        "cp_reconstruct": lambda **d: ct.cp_reconstruct(
            sino.numpy(), SHARED, SHAPE, **kw, **d).x,
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="CUDA device"):
            call()
        assert call(device="cpu").device.type == "cpu", name
    with pytest.raises(RuntimeError, match="CUDA device"):
        ct.estimate_op_norm(*ct.make_projector(SHAPE, SHARED), SHAPE)
    ref = ct.cp_reconstruct(sino, SHARED, SHAPE, **kw)
    assert torch.equal(calls["cp_reconstruct"](device="cpu"), ref.x)
