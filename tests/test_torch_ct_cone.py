"""The port's cone-beam CT (``models/ct.py``: ``ConeBeamGeometry``,
``radon_cone``, ``make_cone_projector`` and ``geom=`` in the
reconstructions) against the JAX package's gather projector on the same
seeded numpy inputs: the trilinear sampler's border, the projection and its
exact adjoint, angle batches, the reconstructions and a resumed JAX state,
the projector cache, the layout checks, and where a call computes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.scipy.ndimage import map_coordinates

import pytv4d_tpu.models.ct as jct
from pytv4d_tpu.core.config import TVConfig as JConfig
from pytv4d_tpu_torch import interop
from pytv4d_tpu_torch.core.config import TVConfig
from pytv4d_tpu_torch.models import ct

SHAPE = (6, 2, 20, 20)
N_DET_V = 10
SHARED = np.linspace(0.0, 2 * np.pi, 8, endpoint=False)
PER_FRAME = np.stack([SHARED, SHARED + 0.05])
ANGLES = {"shared": SHARED, "per-frame": PER_FRAME}
GEOMS = {"default": dict(source_dist=40.0, det_dist=20.0),
         "pitch-step": dict(source_dist=50.0, det_dist=10.0,
                            det_spacing_u=1.2, det_spacing_v=0.9, step=0.8)}
# sums of ~30 trilinear samples of O(1) voxels: the fan's bars
TOL = {np.float64: dict(rtol=1e-12, atol=1e-12),
       np.float32: dict(rtol=1e-5, atol=2e-4)}
TDTYPE = {np.float64: torch.float64, np.float32: torch.float32}
CFG = dict(scheme="hybrid", reg_time=0.5)


def _volume(dtype, shape=SHAPE, seed=0):
    return np.random.default_rng(seed).random(shape).astype(dtype)


def _geoms(name):
    return (jct.ConeBeamGeometry(**GEOMS[name]),
            ct.ConeBeamGeometry(**GEOMS[name]))


def test_trilinear_border_samples_keep_their_inside_weight():
    """The sampler the cone projector calls (``grid_sampler_3d`` with
    ``_SAMPLER``, coordinates by ``_grid``) is
    ``map_coordinates(order=1, mode='constant', cval=0)``: a sample within
    one voxel outside the volume keeps the weight of its inside corners."""
    rng = np.random.default_rng(3)
    vol = rng.random((5, 6, 7))
    pts = rng.uniform(-1.0, (5.0, 6.0, 7.0), size=(4000, 3))
    want = np.asarray(map_coordinates(jnp.asarray(vol), list(pts.T),
                                      order=1, mode="constant", cval=0.0))
    grid = ct._grid(torch.tensor(pts[:, ::-1].copy()).unbind(-1), (7, 6, 5))
    got = torch.ops.aten.grid_sampler_3d(
        torch.tensor(vol)[None, None], grid.reshape(1, 1, 1, -1, 3),
        **ct._SAMPLER).reshape(-1).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-14)
    ones = torch.ones((1, 1, 2, 2, 2), dtype=torch.float64)
    half_out = ct._grid(
        torch.tensor([0.5, 0.5, -0.5], dtype=torch.float64), (2, 2, 2))
    assert float(torch.ops.aten.grid_sampler_3d(
        ones, half_out.reshape(1, 1, 1, 1, 3), **ct._SAMPLER)) == 0.5


@pytest.mark.parametrize("geom", list(GEOMS))
@pytest.mark.parametrize("dtype", (np.float64, np.float32))
@pytest.mark.parametrize("which", list(ANGLES))
def test_radon_cone_matches_jax(which, dtype, geom):
    vol, angles = _volume(dtype), ANGLES[which]
    jgeom, tgeom = _geoms(geom)
    want = np.asarray(jct.radon_cone(jnp.asarray(vol), angles, jgeom,
                                     n_det_v=N_DET_V))
    got = ct.radon_cone(torch.tensor(vol), angles, tgeom, n_det_v=N_DET_V)
    assert got.dtype == TDTYPE[dtype]
    assert tuple(got.shape) == (2, 8, N_DET_V, 20) == want.shape
    np.testing.assert_allclose(got.numpy(), want, **TOL[dtype])
    # angle batches (a ragged last one) give the single sweep's values
    for batch in (3, 1, 8):
        again = ct.radon_cone(torch.tensor(vol), angles, tgeom,
                              n_det_v=N_DET_V, angle_batch=batch)
        np.testing.assert_allclose(again.numpy(), got.numpy(), rtol=0,
                                   atol=1e-5 if dtype == np.float32 else 1e-13)


@pytest.mark.parametrize("shape, dets", [((1, 2, 20, 20), {}),
                                         (SHAPE, dict(n_det_u=26))])
def test_radon_cone_detector_sizes_match_jax(shape, dets):
    """The detector's defaults (``n_det_v = Nz``, ``n_det_u = N``) and a
    wider panel; one slice (Nz = 1), whose z axis the sampler sees padded
    with a zero slice."""
    vol = _volume(np.float64, shape)
    jgeom, tgeom = _geoms("default")
    want = np.asarray(jct.radon_cone(jnp.asarray(vol), SHARED, jgeom, **dets))
    got = ct.radon_cone(torch.tensor(vol), SHARED, tgeom, **dets)
    np.testing.assert_allclose(got.numpy(), want, **TOL[np.float64])
    _, jA_T = jct.make_cone_projector(shape, SHARED, jgeom, dtype=np.float64,
                                      **dets)
    _, A_T = ct.make_cone_projector(shape, SHARED, tgeom,
                                    dtype=torch.float64, **dets)
    y = np.random.default_rng(4).standard_normal(want.shape)
    np.testing.assert_allclose(A_T(torch.tensor(y)).numpy(),
                               np.asarray(jA_T(jnp.asarray(y))),
                               **TOL[np.float64])


def test_cone_geometry_matches_jax():
    for kw in GEOMS.values():
        jgeom, tgeom = jct.ConeBeamGeometry(**kw), ct.ConeBeamGeometry(**kw)
        assert tuple(tgeom) == tuple(jgeom)
        assert tgeom._fields == jgeom._fields
        assert tgeom.magnification == jgeom.magnification
        assert (tgeom.spacing_u(), tgeom.spacing_v()) == \
            (jgeom.spacing_u(), jgeom.spacing_v())


@pytest.mark.parametrize("dtype", (np.float64, np.float32))
@pytest.mark.parametrize("which", list(ANGLES))
def test_cone_adjointness_and_jax_adjoint(which, dtype):
    """``<y, A x> = <A^T y, x>`` to 1e-12 (f64) / 1e-5 (f32) relative, with
    and without angle batches, and A^T equals the JAX package's vjp."""
    angles = ANGLES[which]
    jgeom, tgeom = _geoms("pitch-step")
    rng = np.random.default_rng(1)
    x = torch.tensor(rng.standard_normal(SHAPE).astype(dtype))
    y = torch.tensor(rng.standard_normal((2, 8, N_DET_V, 20)).astype(dtype))
    rel = 1e-12 if dtype == np.float64 else 1e-5
    for batch in (None, 3):
        A, A_T = ct.make_cone_projector(SHAPE, angles, tgeom,
                                        n_det_v=N_DET_V, dtype=TDTYPE[dtype],
                                        angle_batch=batch)
        lhs, rhs = float(torch.sum(y * A(x))), float(torch.sum(A_T(y) * x))
        assert lhs == pytest.approx(rhs, rel=rel)
    _, jA_T = jct.make_cone_projector(SHAPE, angles, jgeom, n_det_v=N_DET_V,
                                      dtype=dtype)
    back = A_T(y)
    assert tuple(back.shape) == SHAPE and back.is_contiguous()
    np.testing.assert_allclose(back.numpy(), np.asarray(jA_T(jnp.asarray(
        y.numpy()))), **TOL[dtype])


def _phantom_problem(angles):
    vol = np.zeros(SHAPE)
    vol[1:5, :, 6:14, 5:12] = 1.0
    vol[2:4, 1, 8:11, 8:16] += 0.5
    jgeom, _ = _geoms("default")
    sino = np.asarray(jct.radon_cone(jnp.asarray(vol), angles, jgeom,
                                     n_det_v=N_DET_V))
    return sino + 0.05 * np.random.default_rng(2).standard_normal(sino.shape)


@pytest.mark.parametrize("which", list(ANGLES))
def test_cp_reconstruct_cone_f64_matches_jax(which):
    """Ten iterations in f64 with the power-method step: loss and x to
    1e-9, and every field of the state."""
    angles = ANGLES[which]
    jgeom, tgeom = _geoms("default")
    sino = _phantom_problem(angles)
    kw = dict(n_iter=10, reg=0.1, nonneg=True)
    want = jct.cp_reconstruct(jnp.asarray(sino), angles, SHAPE, geom=jgeom,
                              cfg=JConfig(**CFG), method="gather", **kw)
    got = ct.cp_reconstruct(torch.tensor(sino), angles, SHAPE, geom=tgeom,
                            cfg=TVConfig(**CFG), **kw)
    np.testing.assert_allclose(got.loss.numpy(), np.asarray(want.loss),
                               rtol=1e-9)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=1e-9,
                               atol=1e-12)
    for a, b in zip(got.state, want.state):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-9,
                                   atol=1e-11)


def test_tgv_reconstruct_cone_f64_matches_jax():
    jgeom, tgeom = _geoms("default")
    sino = _phantom_problem(SHARED)
    kw = dict(n_iter=10, alpha1=0.1, alpha0=0.2, axes="3d")
    want = jct.tgv_reconstruct(jnp.asarray(sino), SHARED, SHAPE, geom=jgeom,
                               method="gather", **kw)
    got = ct.tgv_reconstruct(torch.tensor(sino), SHARED, SHAPE, geom=tgeom,
                             **kw)
    np.testing.assert_allclose(got.loss.numpy(), np.asarray(want.loss),
                               rtol=1e-9)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=1e-9,
                               atol=1e-12)


def test_cp_reconstruct_cone_resumes_a_jax_state():
    jgeom, tgeom = _geoms("default")
    sino = _phantom_problem(SHARED)
    kw = dict(n_iter=4, reg=0.1, op_norm=30.0)
    first = jct.cp_reconstruct(jnp.asarray(sino), SHARED, SHAPE, geom=jgeom,
                               method="gather", **kw)
    want = jct.cp_reconstruct(jnp.asarray(sino), SHARED, SHAPE, geom=jgeom,
                              method="gather", state=first.state, **kw)
    state = interop.inverse_state_from_numpy(
        [np.asarray(a) for a in first.state], device="cpu")
    got = ct.cp_reconstruct(torch.tensor(sino), SHARED, SHAPE, geom=tgeom,
                            state=state, **kw)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_allclose(got.loss.numpy(), np.asarray(want.loss),
                               rtol=1e-9)


def test_cone_pairs_are_cached_and_cleared():
    """``geom=`` memoizes the cone pair in ``_PROJECTOR_CACHE`` (keyed on
    the geometry, the angles, the dtype and the detector's dimensions);
    ``clear_projector_cache`` drops it."""
    ct.clear_projector_cache()
    _, tgeom = _geoms("default")
    sino = torch.zeros((2, 8, N_DET_V, 20), dtype=torch.float64)
    pair = ct._select_projector(sino, SHARED, SHAPE, None, tgeom)
    assert ct._select_projector(sino, list(SHARED), SHAPE, None,
                                tgeom) is pair
    assert ct._select_projector(torch.zeros((2, 8, 12, 20)), SHARED, SHAPE,
                                None, tgeom) is not pair
    assert ct._select_projector(sino, SHARED, SHAPE, None,
                                ct.ConeBeamGeometry(40.0)) is not pair
    fan = ct._select_projector(torch.zeros((6, 2, 8, 20)), SHARED, SHAPE,
                               None, ct.FanBeamGeometry(40.0, 20.0))
    assert fan is not pair and len(ct._PROJECTOR_CACHE) == 4
    ct.clear_projector_cache()
    assert len(ct._PROJECTOR_CACHE) == 0
    assert ct._select_projector(sino, SHARED, SHAPE, None,
                                tgeom) is not pair


def test_layout_errors_match_jax():
    jgeom, tgeom = _geoms("default")
    for bad in (np.zeros((2, 7, N_DET_V, 20)), np.zeros((6, 2, 8, 20))):
        with pytest.raises(ValueError) as want:
            jct.cp_reconstruct(jnp.asarray(bad), SHARED, SHAPE, n_iter=1,
                               geom=jgeom, method="gather")
        with pytest.raises(ValueError) as got:
            ct.cp_reconstruct(torch.tensor(bad), SHARED, SHAPE, n_iter=1,
                              geom=tgeom)
        assert str(got.value) == str(want.value)
        assert "cone-beam sinogram shape" in str(got.value)
    # the spectral cone (ROADMAP.md item 15) runs on the same layout
    res = ct.cp_reconstruct(torch.zeros((2, 8, N_DET_V, 20)), SHARED, SHAPE,
                            n_iter=1, geom=tgeom, method="spectral",
                            op_norm=10.0)
    assert tuple(res.x.shape) == SHAPE and bool(torch.isfinite(res.loss).all())


def test_numpy_goes_to_the_card_or_raises():
    """numpy in without a GPU raises; ``device="cpu"`` computes, and equals
    the CPU tensor's result; ``A`` / ``A_T`` follow their tensor."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: a numpy input runs there")
    _, tgeom = _geoms("default")
    vol = _volume(np.float32)
    sino = ct.radon_cone(vol, SHARED, tgeom, device="cpu")
    assert sino.device.type == "cpu"
    assert torch.equal(sino, ct.radon_cone(torch.tensor(vol), SHARED, tgeom))
    A, A_T = ct.make_cone_projector(SHAPE, SHARED, tgeom)
    assert torch.equal(A(torch.tensor(vol)), sino)
    assert A_T(sino).device.type == "cpu"
    calls = {
        "radon_cone": lambda **d: ct.radon_cone(vol, SHARED, tgeom, **d),
        "cp_reconstruct": lambda **d: ct.cp_reconstruct(
            sino.numpy(), SHARED, SHAPE, n_iter=2, reg=0.1, op_norm=30.0,
            geom=tgeom, **d).x,
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="CUDA device"):
            call()
        assert call(device="cpu").device.type == "cpu", name
    for call in (lambda: A(vol), lambda: A_T(sino.numpy())):
        with pytest.raises(RuntimeError, match="CUDA device"):
            call()
