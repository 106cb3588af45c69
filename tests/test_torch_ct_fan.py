"""The port's fan-beam CT (``models/ct.py``: ``FanBeamGeometry``,
``radon_fan``, ``make_fan_projector`` and ``geom=`` in the reconstructions)
against the JAX package's gather projector on the same seeded numpy inputs:
the projection and its exact adjoint, angle batches, the reconstructions,
the projector cache, the layout checks, and where a call computes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytv4d_tpu.models.ct as jct
from pytv4d_tpu.core.config import TVConfig as JConfig
from pytv4d_tpu_torch.core.config import TVConfig
from pytv4d_tpu_torch.kernels import fused
from pytv4d_tpu_torch.models import ct

SHAPE = (2, 2, 24, 24)
SHARED = np.linspace(0.0, 2 * np.pi, 10, endpoint=False)
PER_FRAME = np.stack([SHARED, SHARED + 0.05])
ANGLES = {"shared": SHARED, "per-frame": PER_FRAME}
# a detector 40 px from the isocentre, the source 40 px on the other side
# (magnification 1.5), and one with its own pitch and a finer step
GEOMS = {"default": dict(source_dist=40.0, det_dist=40.0),
         "pitch-step": dict(source_dist=60.0, det_spacing=1.3, step=0.7)}
# sinogram values are sums of ~36 bilinear samples of O(1) pixels.  f64: both
# packages compute the same coordinates and weights to a few ulps (1e-12
# relative, with an absolute floor for rays that graze the image).  f32: the
# parallel beam's bar (tests/test_torch_ct.py)
TOL = {np.float64: dict(rtol=1e-12, atol=1e-12),
       np.float32: dict(rtol=1e-5, atol=2e-4)}
TDTYPE = {np.float64: torch.float64, np.float32: torch.float32}
CFG = dict(scheme="hybrid", reg_time=0.5)


def _volume(dtype, seed=0):
    return np.random.default_rng(seed).random(SHAPE).astype(dtype)


def _geoms(name):
    return jct.FanBeamGeometry(**GEOMS[name]), ct.FanBeamGeometry(**GEOMS[name])


@pytest.mark.parametrize("geom", list(GEOMS))
@pytest.mark.parametrize("n_det", (None, 30))
@pytest.mark.parametrize("dtype", (np.float64, np.float32))
@pytest.mark.parametrize("which", list(ANGLES))
def test_radon_fan_matches_jax(which, dtype, n_det, geom):
    vol, angles = _volume(dtype), ANGLES[which]
    jgeom, tgeom = _geoms(geom)
    want = np.asarray(jct.radon_fan(jnp.asarray(vol), angles, jgeom,
                                    n_det=n_det))
    got = ct.radon_fan(torch.tensor(vol), angles, tgeom, n_det=n_det)
    assert got.dtype == TDTYPE[dtype]
    assert tuple(got.shape) == (2, 2, 10, n_det or 24) == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL[dtype])
    # angle batches (a ragged last one) give the single sweep's values
    for batch in (4, 1, 10):
        again = ct.radon_fan(torch.tensor(vol), angles, tgeom, n_det=n_det,
                             angle_batch=batch)
        np.testing.assert_allclose(again.numpy(), got.numpy(), rtol=0,
                                   atol=1e-5 if dtype == np.float32 else 1e-13)


def test_fan_geometry_matches_jax():
    for kw in GEOMS.values():
        jgeom, tgeom = jct.FanBeamGeometry(**kw), ct.FanBeamGeometry(**kw)
        assert tuple(tgeom) == tuple(jgeom)
        assert tgeom._fields == jgeom._fields
        assert tgeom.magnification == jgeom.magnification
        assert tgeom.spacing() == jgeom.spacing()
    assert ct.FanBeamGeometry(10.0) == (10.0, 0.0, None, 1.0)


@pytest.mark.parametrize("dtype", (np.float64, np.float32))
@pytest.mark.parametrize("which", list(ANGLES))
def test_fan_adjointness_and_jax_adjoint(which, dtype):
    """``<y, A x> = <A^T y, x>`` to 1e-12 (f64) / 1e-5 (f32) relative, with
    and without angle batches, and A^T equals the JAX package's vjp."""
    angles = ANGLES[which]
    jgeom, tgeom = _geoms("default")
    rng = np.random.default_rng(1)
    x = torch.tensor(rng.standard_normal(SHAPE).astype(dtype))
    y = torch.tensor(rng.standard_normal((2, 2, 10, 30)).astype(dtype))
    rel = 1e-12 if dtype == np.float64 else 1e-5
    for batch in (None, 3):
        A, A_T = ct.make_fan_projector(SHAPE, angles, tgeom, n_det=30,
                                       dtype=TDTYPE[dtype],
                                       angle_batch=batch)
        lhs, rhs = float(torch.sum(y * A(x))), float(torch.sum(A_T(y) * x))
        assert lhs == pytest.approx(rhs, rel=rel)
    _, jA_T = jct.make_fan_projector(SHAPE, angles, jgeom, n_det=30,
                                     dtype=dtype)
    back = A_T(y)
    assert tuple(back.shape) == SHAPE and back.is_contiguous()
    assert back.dtype == TDTYPE[dtype]
    np.testing.assert_allclose(back.numpy(), np.asarray(jA_T(jnp.asarray(
        y.numpy()))), **TOL[dtype])


def _phantom_problem(dtype, angles, background=0.0):
    vol = np.full(SHAPE, background)
    vol[:, :, 7:17, 6:15] = 1.0
    vol[:, 1, 10:13, 9:20] += 0.5
    jgeom, _ = _geoms("default")
    sino = np.asarray(jct.radon_fan(jnp.asarray(vol), angles, jgeom))
    sino = sino + 0.05 * np.random.default_rng(2).standard_normal(sino.shape)
    return sino.astype(dtype)


@pytest.mark.parametrize("which", list(ANGLES))
def test_cp_reconstruct_fan_f64_matches_jax(which):
    """Ten iterations in f64 with the power-method step: loss and x to
    1e-9, and every field of the state."""
    angles = ANGLES[which]
    jgeom, tgeom = _geoms("default")
    sino = _phantom_problem(np.float64, angles)
    kw = dict(n_iter=10, reg=0.1, nonneg=True)
    want = jct.cp_reconstruct(jnp.asarray(sino), angles, SHAPE, geom=jgeom,
                              cfg=JConfig(**CFG), method="gather", **kw)
    got = ct.cp_reconstruct(torch.tensor(sino), angles, SHAPE, geom=tgeom,
                            cfg=TVConfig(**CFG), **kw)
    assert isinstance(got, ct.CPReconResult) and got.x.dtype == torch.float64
    np.testing.assert_allclose(got.loss.numpy(), np.asarray(want.loss),
                               rtol=1e-9)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=1e-9,
                               atol=1e-12)
    for a, b in zip(got.state, want.state):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-9,
                                   atol=1e-11)


def test_tgv_reconstruct_fan_f64_matches_jax():
    jgeom, tgeom = _geoms("pitch-step")
    sino = _phantom_problem(np.float64, SHARED)
    kw = dict(n_iter=10, alpha1=0.1, alpha0=0.2, nonneg=True)
    want = jct.tgv_reconstruct(jnp.asarray(sino), SHARED, SHAPE, geom=jgeom,
                               method="gather", **kw)
    got = ct.tgv_reconstruct(torch.tensor(sino), SHARED, SHAPE, geom=tgeom,
                             **kw)
    np.testing.assert_allclose(got.loss.numpy(), np.asarray(want.loss),
                               rtol=1e-9)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=1e-9,
                               atol=1e-12)


def test_cp_reconstruct_fan_f32_takes_the_fused_path(monkeypatch):
    """f32 against the JAX package (its fused path in the interpreter): the
    loss to 1e-4, with one pass A (B5's plain version here) an iteration."""
    jgeom, tgeom = _geoms("default")
    sino = _phantom_problem(np.float32, SHARED)
    n_dual = [0]
    plain = fused.tv_dual_plain

    def counted(*a, **k):
        n_dual[0] += 1
        return plain(*a, **k)

    monkeypatch.setattr(fused, "tv_dual_plain", counted)
    kw = dict(n_iter=10, reg=0.1, nonneg=True)
    want = jct.cp_reconstruct(jnp.asarray(sino), SHARED, SHAPE, geom=jgeom,
                              cfg=JConfig(**CFG), method="gather", **kw)
    got = ct.cp_reconstruct(torch.tensor(sino), SHARED, SHAPE, geom=tgeom,
                            cfg=TVConfig(**CFG), **kw)
    assert n_dual[0] == 10
    np.testing.assert_allclose(got.loss.numpy(), np.asarray(want.loss),
                               rtol=1e-4)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=1e-3,
                               atol=1e-3)


def test_fan_pairs_are_cached_and_cleared():
    """``geom=`` memoizes the fan pair in ``_PROJECTOR_CACHE`` (the JAX
    package's key: geometry, angles, dtype, n_det); ``clear_projector_cache``
    drops it."""
    ct.clear_projector_cache()
    _, tgeom = _geoms("default")
    sino = torch.zeros((2, 2, 10, 24), dtype=torch.float64)
    pair = ct._select_projector(sino, SHARED, SHAPE, None, tgeom)
    assert len(ct._PROJECTOR_CACHE) == 1
    assert ct._select_projector(sino, list(SHARED), SHAPE, None,
                                tgeom) is pair
    assert ct._select_projector(sino, SHARED, SHAPE, None,
                                ct.FanBeamGeometry(41.0, 40.0)) is not pair
    assert ct._select_projector(sino.float(), SHARED, SHAPE, None,
                                tgeom) is not pair
    assert ct._select_projector(torch.zeros((2, 2, 10, 30)), SHARED, SHAPE,
                                30, tgeom) is not pair
    assert len(ct._PROJECTOR_CACHE) == 4
    ct.clear_projector_cache()
    assert len(ct._PROJECTOR_CACHE) == 0
    assert ct._select_projector(sino, SHARED, SHAPE, None,
                                tgeom) is not pair


def _message(call):
    with pytest.raises(ValueError) as err:
        call()
    return str(err.value)


def test_layout_and_geometry_errors_match_jax():
    jgeom, tgeom = _geoms("default")
    bad = np.zeros((2, 2, 10, 23))
    assert _message(lambda: ct.cp_reconstruct(
        torch.tensor(bad), SHARED, SHAPE, n_iter=1, geom=tgeom)) == \
        _message(lambda: jct.cp_reconstruct(
            jnp.asarray(bad), SHARED, SHAPE, n_iter=1, geom=jgeom,
            method="gather"))
    sino = np.zeros((2, 2, 10, 24))
    # an unknown geometry: the JAX package's text (its sart's; its
    # reconstructions take any other geometry for a fan)
    assert _message(lambda: jct.sart(
        jnp.asarray(sino), SHARED, SHAPE, n_subsets=5, geom=object(),
        method="gather")) == _message(lambda: ct.cp_reconstruct(
            torch.tensor(sino), SHARED, SHAPE, n_iter=1, geom=object()))
    assert "unknown geometry tuple" in _message(lambda: ct.tgv_reconstruct(
        torch.tensor(sino), SHARED, SHAPE, n_iter=1,
        geom=(40.0, 40.0, None, 1.0)))
    # the spectral fan (ROADMAP.md item 15) runs on the same layout
    res = ct.cp_reconstruct(torch.tensor(sino), SHARED, SHAPE, n_iter=1,
                            geom=tgeom, method="spectral", op_norm=10.0)
    assert tuple(res.x.shape) == SHAPE and bool(torch.isfinite(res.loss).all())


def test_numpy_goes_to_the_card_or_raises():
    """numpy in without a GPU raises; ``device="cpu"`` computes, and equals
    the CPU tensor's result; ``A`` / ``A_T`` follow their tensor."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: a numpy input runs there")
    _, tgeom = _geoms("default")
    vol = _volume(np.float32)
    sino = ct.radon_fan(vol, SHARED, tgeom, device="cpu")
    assert sino.device.type == "cpu"
    assert torch.equal(sino, ct.radon_fan(torch.tensor(vol), SHARED, tgeom))
    A, A_T = ct.make_fan_projector(SHAPE, SHARED, tgeom)
    assert torch.equal(A(torch.tensor(vol)), sino)
    assert A_T(sino).device.type == "cpu"
    kw = dict(n_iter=2, op_norm=20.0, geom=tgeom)
    calls = {
        "radon_fan": lambda **d: ct.radon_fan(vol, SHARED, tgeom, **d),
        "cp_reconstruct": lambda **d: ct.cp_reconstruct(
            sino.numpy(), SHARED, SHAPE, reg=0.1, **kw, **d).x,
        "tgv_reconstruct": lambda **d: ct.tgv_reconstruct(
            sino.numpy(), SHARED, SHAPE, **kw, **d).x,
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="CUDA device"):
            call()
        assert call(device="cpu").device.type == "cpu", name
    for call in (lambda: A(vol), lambda: A_T(sino.numpy())):
        with pytest.raises(RuntimeError, match="CUDA device"):
            call()
