"""The port's ``fdk`` and ``sart`` (``models/ct.py``) against the JAX
package's gather path on the same seeded numpy inputs: FDK over the filter
windows, angle sets, batches and detector sizes; SART on the parallel, fan
and cone projectors and on a caller's ``project_fn``, with its residual
history, its relative dead-row masking and its argument checks; and where
each computes."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytv4d_tpu.models.ct as jct
from pytv4d_tpu_torch.models import ct

CONE_SHAPE = (6, 2, 20, 20)
N_DET_V = 10
FULL = np.linspace(0.0, 2 * np.pi, 8, endpoint=False)
HALF = np.linspace(0.0, np.pi, 8, endpoint=False)
CONE = dict(source_dist=40.0, det_dist=20.0)
FAN = dict(source_dist=40.0, det_dist=40.0)
# f64: an FFT pair and a few bilinear interpolations per voxel and angle,
# the same coordinates in both packages to a few ulps
F64 = dict(rtol=1e-12, atol=1e-12)


def _cone_sino(angles, dtype=np.float64, shape=CONE_SHAPE, n_det_v=N_DET_V):
    vol = np.random.default_rng(0).random(shape)
    sino = np.asarray(jct.radon_cone(jnp.asarray(vol), angles,
                                     jct.ConeBeamGeometry(**CONE),
                                     n_det_v=n_det_v))
    return sino.astype(dtype)


@pytest.mark.parametrize("filter_name", ct._FILTER_WINDOWS)
def test_fdk_matches_jax(filter_name):
    """All five windows in f64 to 1e-12, on shared and per-frame angles."""
    per_frame = np.stack([FULL, FULL + 0.05])
    for angles in (FULL, per_frame):
        sino = _cone_sino(angles)
        want = np.asarray(jct.fdk(jnp.asarray(sino), angles,
                                  jct.ConeBeamGeometry(**CONE), CONE_SHAPE,
                                  filter_name=filter_name, method="gather"))
        got = ct.fdk(torch.tensor(sino), angles, ct.ConeBeamGeometry(**CONE),
                     CONE_SHAPE, filter_name=filter_name)
        assert got.dtype == torch.float64 and got.is_contiguous()
        assert tuple(got.shape) == CONE_SHAPE == want.shape
        np.testing.assert_allclose(got.numpy(), want, **F64)


@pytest.mark.parametrize("case", ("batches", "one-row", "pitch", "float32"))
def test_fdk_variants_match_jax(case):
    """Angle batches against the single sweep; a one-row detector (a slab of
    one slice, padded with a zero row for the sampler); the detector's own
    pitches, another volume width; float32 to 1e-5 of the image's scale."""
    geom = dict(CONE)
    shape, n_det_v, dtype, kw = CONE_SHAPE, N_DET_V, np.float64, {}
    if case == "one-row":
        shape, n_det_v = (1, 2, 20, 20), 1
    elif case == "pitch":
        geom.update(det_spacing_u=1.2, det_spacing_v=0.9)
        shape = (6, 2, 16, 16)
    elif case == "float32":
        dtype = np.float32
    sino = _cone_sino(FULL, dtype, shape if case == "one-row" else
                      CONE_SHAPE, n_det_v)
    want = np.asarray(jct.fdk(jnp.asarray(sino), FULL,
                              jct.ConeBeamGeometry(**geom), shape,
                              method="gather"))
    got = ct.fdk(torch.tensor(sino), FULL, ct.ConeBeamGeometry(**geom),
                 shape, **kw)
    tol = F64 if dtype == np.float64 else dict(
        rtol=0, atol=1e-5 * float(np.abs(want).max()))
    np.testing.assert_allclose(got.numpy(), want, **tol)
    if case == "batches":
        for batch in (3, 1):
            again = ct.fdk(torch.tensor(sino), FULL,
                           ct.ConeBeamGeometry(**geom), shape,
                           angle_batch=batch)
            np.testing.assert_allclose(again.numpy(), got.numpy(), rtol=0,
                                       atol=1e-13)


def _phantom(shape):
    vol = np.zeros(shape)
    n = shape[-1]
    vol[:, :, n // 4:n // 2 + 2, n // 4:3 * n // 4] = 1.0
    vol[:, -1, n // 2:3 * n // 4, n // 3:n // 2] += 0.5
    return vol


def _sart_case(which):
    """(sinogram, angles, vol_shape, the JAX keywords, the port's)."""
    per_frame = np.stack([HALF, HALF + 0.05])
    if which in ("parallel", "parallel-per-frame", "wide-detector"):
        shape = (2, 2, 24, 24)
        angles = per_frame if which == "parallel-per-frame" else HALF
        n_det = 40 if which == "wide-detector" else None
        sino = np.asarray(jct.radon(jnp.asarray(_phantom(shape)), angles,
                                    n_det=n_det))
        kw = dict(n_det=n_det)
        return sino, angles, shape, kw, kw
    if which in ("fan", "fan-per-frame"):
        shape = (2, 2, 24, 24)
        angles = np.stack([FULL, FULL + 0.05]) if which == "fan-per-frame" \
            else FULL
        sino = np.asarray(jct.radon_fan(jnp.asarray(_phantom(shape)), angles,
                                        jct.FanBeamGeometry(**FAN)))
        return (sino, angles, shape, dict(geom=jct.FanBeamGeometry(**FAN)),
                dict(geom=ct.FanBeamGeometry(**FAN)))
    geom = (jct.ConeBeamGeometry(**CONE), ct.ConeBeamGeometry(**CONE))
    sino = np.asarray(jct.radon_cone(jnp.asarray(_phantom(CONE_SHAPE)), FULL,
                                     geom[0], n_det_v=N_DET_V))
    if which == "cone":
        return sino, FULL, CONE_SHAPE, dict(geom=geom[0]), dict(geom=geom[1])
    # a caller's projector: the JAX package transposes it with jax.vjp, the
    # port with torch.func.vjp
    kw = [dict(angle_axis=1, project_fn=functools.partial(
        mod.radon_cone, geom=g, n_det_v=N_DET_V)) for mod, g in
        ((jct, geom[0]), (ct, geom[1]))]
    return (sino, FULL, CONE_SHAPE) + tuple(kw)


@pytest.mark.parametrize("which", ("parallel", "parallel-per-frame",
                                   "wide-detector", "fan", "fan-per-frame",
                                   "cone", "cone-project_fn"))
def test_sart_matches_jax(which):
    """Three epochs of four subsets in f64: x and the residual history to
    1e-10.  The wide detector's outer rays miss the volume: their rows sum
    to 0 and are masked (relative to the largest row, not by an absolute
    floor)."""
    sino, angles, shape, jkw, tkw = _sart_case(which)
    kw = dict(n_iter=3, n_subsets=4)
    if which in ("parallel", "fan"):
        # an over-relaxed start from a given x, without the clamp
        x0 = np.random.default_rng(5).random(shape)
        kw.update(relax=0.7, nonneg=False, x_init=x0)
    want = jct.sart(jnp.asarray(sino), angles, shape, method="gather",
                    **kw, **jkw)
    got = ct.sart(torch.tensor(sino), angles, shape, **kw, **tkw)
    assert isinstance(got, ct.SARTResult)
    assert got.x.dtype == torch.float64 and tuple(got.x.shape) == shape
    np.testing.assert_allclose(got.residual.numpy(), np.asarray(want.residual),
                               rtol=1e-10)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=1e-10,
                               atol=1e-12)
    r = got.residual.numpy()
    assert r[-1] < r[0]
    if which == "wide-detector":
        P, _ = ct.make_projector(shape, angles[::4], n_det=40,
                                 dtype=torch.float64)
        row = P(torch.ones(shape, dtype=torch.float64))
        assert bool((row == 0).any()) and bool((row > 0).any())


def test_sart_argument_checks_match_jax():
    sino, angles, shape, jkw, tkw = _sart_case("fan")
    for kw in (dict(n_subsets=3), dict(geom=object())):
        with pytest.raises(ValueError) as want:
            jct.sart(jnp.asarray(sino), angles, shape, method="gather", **kw)
        with pytest.raises(ValueError) as got:
            ct.sart(torch.tensor(sino), angles, shape, **kw)
        assert str(got.value) == str(want.value)
    # the spectral SART and FDK (ROADMAP.md item 15) run on the same input
    res = ct.sart(torch.tensor(sino), angles, shape, n_iter=1,
                  method="spectral", **tkw)
    assert res.x.shape == shape and bool(torch.isfinite(res.x).all())
    rec = ct.fdk(torch.tensor(_cone_sino(FULL)), FULL,
                 ct.ConeBeamGeometry(**CONE), CONE_SHAPE, method="spectral")
    assert tuple(rec.shape) == CONE_SHAPE and bool(torch.isfinite(rec).all())
    # a caller's projector is used whatever geom says, as in the JAX package
    res = ct.sart(torch.tensor(sino), angles, shape, n_iter=1, n_subsets=2,
                  geom=object(), project_fn=functools.partial(
                      ct.radon_fan, geom=tkw["geom"]))
    assert tuple(res.residual.shape) == (1,)


def test_numpy_goes_to_the_card_or_raises():
    """numpy in without a GPU raises; ``device="cpu"`` computes, and equals
    the CPU tensor's result."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: a numpy input runs there")
    sino = _cone_sino(FULL, np.float32)
    geom = ct.ConeBeamGeometry(**CONE)
    calls = {
        "fdk": lambda s, **d: ct.fdk(s, FULL, geom, CONE_SHAPE, **d),
        "sart": lambda s, **d: ct.sart(s, FULL, CONE_SHAPE, n_iter=1,
                                       n_subsets=2, geom=geom, **d).x,
    }
    for name, call in calls.items():
        with pytest.raises(RuntimeError, match="CUDA device"):
            call(sino)
        got = call(sino, device="cpu")
        assert got.device.type == "cpu", name
        assert torch.equal(got, call(torch.tensor(sino))), name
