"""The port's spectral FDK (``fdk(method='spectral')``, the rebinning P-FDK
of ``models/ct_spectral.py``) and spectral SART (``sart(method='spectral')``
on the parallel, fan and cone projectors, with the cone's health-gated
normalizers) against the JAX package on the same seeded numpy inputs, and
SART against a plain loop over the spectral pairs.

Tolerances: FDK in float64 within 1e-11 of the output's largest value, in
float32 within 1e-5 of the scale; SART in float64 within 1e-9, in float32
within 1e-5 (the loop against SART: float32 round-off)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytv4d_tpu.models.ct as jct
import pytv4d_tpu.models.ct_spectral as jcs
from pytv4d_tpu_torch.models import ct
from pytv4d_tpu_torch.models import ct_spectral as cs

CONE_SHAPE = (4, 2, 24, 24)
FULL = np.linspace(0.0, 2 * np.pi, 16, endpoint=False)
HALF = np.linspace(0.0, np.pi, 16, endpoint=False)
CONE = dict(source_dist=48.0, det_dist=12.0)
WIDE = dict(source_dist=36.0, det_dist=12.0)   # 1.5 N: signed sums fail
FAN = dict(source_dist=48.0, det_dist=24.0)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _blobs(shape, seed=0):
    """Smooth Gaussian blobs inside the inscribed circle, per frame."""
    rng = np.random.default_rng(seed)
    Nz, M, N = shape[0], shape[1], shape[-1]
    z, r, c = np.mgrid[:Nz, :N, :N]
    vol = np.zeros(shape)
    for m in range(M):
        for _ in range(3):
            z0 = rng.uniform(0.3 * Nz, 0.7 * Nz)
            r0, c0 = rng.uniform(0.35 * N, 0.65 * N, 2)
            vol[:, m] += np.exp(-((z - z0) ** 2 / 4.0 + (r - r0) ** 2 / 12.0
                                  + (c - c0) ** 2 / 12.0))
    return vol


def _cone_sino(angles, geom=CONE, n_det_v=None):
    return np.asarray(jcs.radon_cone_spectral(
        jnp.asarray(_blobs(CONE_SHAPE)), angles, jct.ConeBeamGeometry(**geom),
        n_det_v=n_det_v))


def test_fdk_rebin_consts_match_jax():
    """The host-built rebinning matrices are the JAX package's numpy code:
    equal to the last bit."""
    geom = ct.ConeBeamGeometry(**CONE)
    got = cs._fdk_rebin_consts(FULL, geom, 4, 6, 24, 24)
    want = jcs._fdk_rebin_consts(FULL, jct.ConeBeamGeometry(**CONE), 4, 6,
                                 24, 24)
    for g, w in zip(got[:3], want[:3]):
        np.testing.assert_array_equal(g, w)
    for gs, ws in zip(got[3:], want[3:]):
        for g, w in zip(gs, ws):
            np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("which, dtype, filter_name", (
    ("shared", np.float64, "ramp"), ("per-frame", np.float64, "hann"),
    ("shared", np.float32, "ramp")))
def test_fdk_spectral_matches_jax(which, dtype, filter_name):
    angles = FULL if which == "shared" else np.stack([FULL, FULL + 0.05])
    sino = _cone_sino(angles).astype(dtype)
    want = np.asarray(jct.fdk(jnp.asarray(sino), angles,
                              jct.ConeBeamGeometry(**CONE), CONE_SHAPE,
                              filter_name=filter_name, method="spectral"))
    got = ct.fdk(torch.tensor(sino), angles, ct.ConeBeamGeometry(**CONE),
                 CONE_SHAPE, filter_name=filter_name, method="spectral")
    assert got.dtype == torch.tensor(sino).dtype
    assert tuple(got.shape) == CONE_SHAPE
    assert _rel(got.numpy(), want) < (1e-11 if dtype == np.float64 else 1e-5)
    # the entry point of the module computes the same
    np.testing.assert_array_equal(
        cs.fdk_spectral(torch.tensor(sino), angles,
                        ct.ConeBeamGeometry(**CONE), CONE_SHAPE,
                        filter_name=filter_name).numpy(), got.numpy())


def _sart_case(kind, dtype=np.float64):
    """(sinogram, angles, shape, JAX geometry, port geometry) of a smooth
    phantom on the spectral projector of ``kind``."""
    if kind == "parallel":
        shape = (2, 2, 24, 24)
        sino = np.asarray(jcs.radon_spectral(jnp.asarray(_blobs(shape)),
                                             HALF))
        return sino.astype(dtype), HALF, shape, None, None
    if kind == "fan":
        shape = (2, 2, 24, 24)
        sino = np.asarray(jcs.radon_fan_spectral(
            jnp.asarray(_blobs(shape)), FULL, jct.FanBeamGeometry(**FAN)))
        return (sino.astype(dtype), FULL, shape, jct.FanBeamGeometry(**FAN),
                ct.FanBeamGeometry(**FAN))
    geom = WIDE if kind == "wide cone" else CONE
    n_det_v = 8 if kind == "wide cone" else None
    return (_cone_sino(FULL, geom, n_det_v).astype(dtype), FULL, CONE_SHAPE,
            jct.ConeBeamGeometry(**geom), ct.ConeBeamGeometry(**geom))


@pytest.mark.parametrize("kind, dtype", (
    ("parallel", np.float64), ("fan", np.float64), ("cone", np.float64),
    ("wide cone", np.float64), ("cone", np.float32)))
def test_sart_spectral_matches_jax(kind, dtype):
    """Per-subset pairs from the host angles in float64 (also for a float32
    sinogram), the cone's signed sums where they are healthy and the
    surrogate's where they are not (the wide cone), on the JAX package's
    iterates and residuals."""
    sino, angles, shape, jgeom, tgeom = _sart_case(kind, dtype)
    kw = dict(n_iter=3, n_subsets=4, method="spectral")
    want = jct.sart(jnp.asarray(sino), angles, shape, geom=jgeom, **kw)
    ct.clear_projector_cache()
    got = ct.sart(torch.tensor(sino), angles, shape, geom=tgeom, **kw)
    tol = dict(rtol=1e-9, atol=1e-9) if dtype == np.float64 else dict(
        rtol=1e-5, atol=1e-5 * float(np.abs(np.asarray(want.x)).max()))
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), **tol)
    np.testing.assert_allclose(got.residual.numpy(),
                               np.asarray(want.residual), rtol=tol["rtol"])
    assert bool((got.residual[1:] < got.residual[:-1]).all())
    assert len(ct._SART_SUMS_CACHE) == (kind.endswith("cone"))
    if kind == "wide cone":
        # the gate fell back to the surrogate: its sums are the normalizers
        (sums, pairs), = ct._SART_SUMS_CACHE.values()
        idx = np.arange(16).reshape(-1, 4).T
        for (row, col), k in zip(sums, idx):
            r, c = cs.cone_spectral_precond_sums(
                shape, angles[k], tgeom, n_det_v=8, dtype=torch.float64,
                device="cpu")
            assert torch.equal(row, r) and torch.equal(col, c)
    ct.clear_projector_cache()


@pytest.mark.parametrize("kind", ("parallel", "cone"))
def test_sart_spectral_matches_a_plain_loop(kind):
    """``sart(method='spectral')`` is the SART recursion: a plain loop over
    the spectral subset pairs, with the relative dead-row masking, lands on
    the same iterate in float32."""
    sino, angles, shape, _, tgeom = _sart_case(kind, np.float32)
    res = ct.sart(torch.tensor(sino), angles, shape, n_iter=4, n_subsets=4,
                  method="spectral", geom=tgeom)
    x = torch.zeros(shape)
    axis = 1 if kind == "cone" else 2
    for _ in range(4):
        for k in np.arange(16).reshape(-1, 4).T:
            if kind == "cone":
                Ak, AkT = cs.make_cone_spectral_projector(shape, angles[k],
                                                          tgeom)
            else:
                Ak, AkT = cs.make_spectral_projector(shape, angles[k])
            row = Ak(torch.ones(shape))
            col = AkT(torch.ones_like(row))
            tr, tc = 1e-6 * row.max(), 1e-6 * col.max()
            b = torch.index_select(torch.tensor(sino), axis, torch.tensor(k))
            r = torch.where(row > tr, (b - Ak(x)) / torch.maximum(row, tr),
                            0.0)
            x = torch.clamp_min(x + torch.where(
                col > tc, AkT(r) / torch.maximum(col, tc), 0.0), 0.0)
    assert float(torch.linalg.norm(res.x - x) / torch.linalg.norm(x)) < 1e-5


def test_sart_spectral_precision_and_cache():
    """``precision`` reaches the subset pairs (one memoized pair per subset,
    and the full-angle one), and the cache holds a campaign at once."""
    sino, angles, shape, _, _ = _sart_case("parallel", np.float32)
    ct.clear_projector_cache()
    ct.sart(torch.tensor(sino), angles, shape, n_iter=1, n_subsets=8,
            method="spectral", precision="highest")
    assert ct._PROJECTOR_CACHE_MAX >= 8 + 2
    assert len(ct._PROJECTOR_CACHE) == 9
    assert all(key[-1] == "highest" for key in ct._PROJECTOR_CACHE)
    ct.clear_projector_cache()
