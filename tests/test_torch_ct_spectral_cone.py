"""The port's cone-beam spectral projector (``models/ct_spectral.py``: SSRB
with the first-order slope correction, orders 0 and 1) against the JAX
package's on the same seeded numpy inputs: the projection and its explicit
adjoint, per-frame angles, the parallel limit and the order's accuracy
against the gather cone, the operator protocol, the abs-factor
preconditioner sums and ``cp_reconstruct(geom=cone, method='spectral')``
with and without ``precond``; bad orders and z kernels raise as in JAX
(``order=2`` itself: ``tests/test_torch_ct_zdft.py``).

Tolerances: float64 within 1e-11 of the output's largest value, float32
within 1e-5 of the scale, reconstructions in float64 within 1e-9."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytv4d_tpu.models.ct as jct
import pytv4d_tpu.models.ct_spectral as jcs
from pytv4d_tpu.core.config import TVConfig as JConfig
from pytv4d_tpu_torch.core.config import TVConfig
from pytv4d_tpu_torch.models import ct
from pytv4d_tpu_torch.models import ct_spectral as cs

SHAPE = (4, 2, 24, 24)
SHARED = np.linspace(0.0, 2 * np.pi, 8, endpoint=False) + 0.05
PER_FRAME = np.stack([SHARED, SHARED + 0.1])
ANGLES = {"shared": SHARED, "per-frame": PER_FRAME}
GEOMS = {"default": dict(source_dist=48.0, det_dist=12.0),
         "pitch": dict(source_dist=40.0, det_dist=20.0, det_spacing_u=1.3,
                       det_spacing_v=0.9)}
F64 = 1e-11
F32 = 1e-5


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _geoms(name):
    return (jct.ConeBeamGeometry(**GEOMS[name]),
            ct.ConeBeamGeometry(**GEOMS[name]))


def _thin_slab(Nz, M, N, seed=0, zs=6.0, margin=16):
    rng = np.random.default_rng(seed)
    z, r, c = np.mgrid[:Nz, :N, :N]
    vol = np.zeros((Nz, M, N, N))
    for m in range(M):
        for _ in range(4):
            z0 = rng.uniform(2, Nz - 2)
            r0, c0 = (rng.uniform(margin, N - margin),
                      rng.uniform(margin, N - margin))
            vol[:, m] += np.exp(-((z - z0) ** 2 / zs + (r - r0) ** 2 / 50
                                  + (c - c0) ** 2 / 50))
    return vol


@pytest.mark.parametrize("which, dtype, order", (
    ("shared", np.float64, 0), ("per-frame", np.float64, 1),
    ("shared", np.float32, 1)))
def test_cone_pair_matches_jax(which, dtype, order):
    """Forward and explicit adjoint against the JAX package (its vjp), the
    cone layout, and the dot test (1e-12 relative in float64, 1e-5 in
    float32)."""
    jgeom, tgeom = _geoms("default")
    angles = ANGLES[which]
    rng = np.random.default_rng(5)
    x = rng.random(SHAPE).astype(dtype)
    y = rng.random((2, 8, 4, 24)).astype(dtype)
    tdt = torch.tensor(x).dtype
    A, A_T = cs.make_cone_spectral_projector(SHAPE, angles, tgeom, dtype=tdt,
                                             order=order)
    jA, jA_T = jcs.make_cone_spectral_projector(
        SHAPE, angles, jgeom, dtype=jnp.asarray(x).dtype, order=order)
    tol = F64 if dtype == np.float64 else F32
    got, got_T = A(torch.tensor(x)), A_T(torch.tensor(y))
    assert got.dtype == tdt and tuple(got.shape) == (2, 8, 4, 24)
    assert _rel(got.numpy(), np.asarray(jA(jnp.asarray(x)))) < tol
    assert _rel(got_T.numpy(), np.asarray(jA_T(jnp.asarray(y)))) < tol
    lhs = float(np.vdot(y.astype(np.float64), got.double().numpy()))
    rhs = float(np.vdot(got_T.double().numpy(), x.astype(np.float64)))
    assert abs(lhs - rhs) / abs(lhs) < (1e-12 if dtype == np.float64
                                        else 1e-5)


def test_detector_pitch_and_rows_match_jax():
    jgeom, tgeom = _geoms("pitch")
    x = np.random.default_rng(2).random(SHAPE)
    want = np.asarray(jcs.radon_cone_spectral(jnp.asarray(x), SHARED, jgeom,
                                              n_det_v=6, n_det_u=20))
    got = cs.radon_cone_spectral(torch.tensor(x), SHARED, tgeom, n_det_v=6,
                                 n_det_u=20)
    assert tuple(got.shape) == want.shape == (2, 8, 6, 20)
    assert _rel(got.numpy(), want) < F64
    # linearity
    x2 = np.random.default_rng(3).random(SHAPE)
    np.testing.assert_allclose(
        cs.radon_cone_spectral(torch.tensor(2.0 * x + 0.5 * x2), SHARED,
                               tgeom).numpy(),
        (2.0 * cs.radon_cone_spectral(torch.tensor(x), SHARED, tgeom)
         + 0.5 * cs.radon_cone_spectral(torch.tensor(x2), SHARED, tgeom))
        .numpy(), rtol=1e-11, atol=1e-11)


def test_per_frame_angles_and_protocol():
    _, tgeom = _geoms("default")
    vol = torch.tensor(_thin_slab(4, 2, 24, zs=4.0, margin=8))
    pf = cs.radon_cone_spectral(vol, PER_FRAME, tgeom)
    assert tuple(pf.shape) == (2, 8, 4, 24)
    for m in range(2):
        one = cs.radon_cone_spectral(vol[:, m:m + 1], PER_FRAME[m], tgeom)
        np.testing.assert_allclose(pf[m].numpy(), one[0].numpy(), rtol=0,
                                   atol=1e-12)
    A, A_T = cs.make_cone_spectral_projector(SHAPE, PER_FRAME, tgeom,
                                             dtype=torch.float64)
    consts = A.prepare()
    np.testing.assert_allclose(A.apply(consts, vol).numpy(), pf.numpy(),
                               rtol=1e-12, atol=1e-12)
    assert torch.equal(A.apply_T(consts, pf), A_T(pf))


def test_parallel_limit():
    """A huge source distance closes the cone: detector row v reads slice
    v, so both orders agree with the gather cone to the rebinning's
    interpolation, and order 1 with the parallel spectral projector slice
    by slice."""
    Nz, M, N = 6, 1, 64
    vol = torch.tensor(_thin_slab(Nz, M, N))
    angles = np.linspace(0, 2 * np.pi, 8, endpoint=False) + 0.02
    far = ct.ConeBeamGeometry(source_dist=1e7, det_dist=0.0,
                              det_spacing_u=1.0, det_spacing_v=1.0)
    ref = ct.radon_cone(vol, angles, far).numpy()
    for order in (0, 1):
        got = cs.radon_cone_spectral(vol, angles, far, order=order).numpy()
        assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 3e-3
    par = cs.radon_spectral(vol, angles).numpy()
    np.testing.assert_allclose(
        cs.radon_cone_spectral(vol, angles, far).numpy(),
        np.transpose(par, (1, 2, 0, 3)), rtol=0,
        atol=1e-3 * np.abs(par).max())


def test_order_accuracy_against_the_gather_cone():
    """The JAX package's recorded envelope on a smooth thin slab (its bars
    at D_so = 2N / 4N / 8N): order 0 is O(sigma), halving with each
    doubling of the source distance; order 1 cuts it at every geometry.
    The gather cone is the port's, held to the JAX package's at 1e-12."""
    Nz, M, N = 8, 2, 64
    vol = torch.tensor(_thin_slab(Nz, M, N))
    angles = np.linspace(0, 2 * np.pi, 24, endpoint=False)
    bars = {2.0: (0.08, 0.045), 4.0: (0.04, 0.025), 8.0: (0.025, 0.015)}
    e0s = []
    for mult, (bar0, bar1) in bars.items():
        geom = ct.ConeBeamGeometry(source_dist=mult * N, det_dist=1.0 * N)
        ref = ct.radon_cone(vol, angles, geom).numpy()
        e0, e1 = (np.linalg.norm(cs.radon_cone_spectral(
            vol, angles, geom, order=o).numpy() - ref) / np.linalg.norm(ref)
            for o in (0, 1))
        assert e0 < bar0 and e1 < bar1 and e1 < 0.7 * e0, (mult, e0, e1)
        e0s.append(e0)
    assert e0s[1] < 0.65 * e0s[0] and e0s[2] < 0.65 * e0s[1]


def test_order_2_is_not_ported_and_bad_orders_raise_as_jax():
    """A bad order and, at order 2, a bad z kernel raise the JAX package's
    messages (the name is older than the order-2 tier, which
    ``tests/test_torch_ct_zdft.py`` holds against JAX)."""
    jgeom, tgeom = _geoms("default")
    x = torch.zeros(SHAPE)
    for kw in (dict(order=3), dict(order=2, z_kernel="nope")):
        with pytest.raises(ValueError) as want:
            jcs.radon_cone_spectral(jnp.zeros(SHAPE), SHARED, jgeom, **kw)
        with pytest.raises(ValueError) as got:
            cs.radon_cone_spectral(x, SHARED, tgeom, **kw)
        assert str(got.value) == str(want.value)
    with pytest.raises(ValueError, match="z_kernel"):
        cs.make_cone_spectral_projector(SHAPE, SHARED, tgeom, order=2,
                                        z_kernel="nope")


@pytest.mark.parametrize("which", list(ANGLES))
def test_precond_sums_match_jax(which):
    """The abs-factor surrogate's row and column sums (its explicit
    transpose at ones), floored at 1e-6 of their largest."""
    jgeom, tgeom = _geoms("default")
    want = jcs.cone_spectral_precond_sums(SHAPE, ANGLES[which], jgeom,
                                          dtype=jnp.float64)
    got = cs.cone_spectral_precond_sums(SHAPE, ANGLES[which], tgeom,
                                        dtype=torch.float64, device="cpu")
    for g, w in zip(got, want):
        assert g.dtype == torch.float64 and tuple(g.shape) == w.shape
        assert _rel(g.numpy(), np.asarray(w)) < F64
        assert float(g.min()) > 0.0


@pytest.mark.parametrize("precond", (False, True))
def test_cp_reconstruct_cone_spectral_matches_jax(precond):
    """The plain solve, and the preconditioned one on the surrogate's sums
    with the power-method scale (memoized per projector), on the JAX
    package's trajectory in float64."""
    jgeom, tgeom = _geoms("default")
    vol = _thin_slab(4, 2, 24, zs=4.0, margin=8)
    sino = np.asarray(jcs.radon_cone_spectral(jnp.asarray(vol), SHARED,
                                              jgeom))
    kw = dict(n_iter=6, reg=0.05, method="spectral", precond=precond)
    want = jct.cp_reconstruct(jnp.asarray(sino), SHARED, SHAPE, geom=jgeom,
                              cfg=JConfig(scheme="hybrid"), **kw)
    ct.clear_projector_cache()
    got = ct.cp_reconstruct(torch.tensor(sino), SHARED, SHAPE, geom=tgeom,
                            cfg=TVConfig(scheme="hybrid"), **kw)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=1e-9,
                               atol=1e-9)
    np.testing.assert_allclose(got.loss.numpy(), np.asarray(want.loss),
                               rtol=1e-9)
    assert len(ct._CONE_PRECOND_CACHE) == int(precond)
    again = ct.cp_reconstruct(torch.tensor(sino), SHARED, SHAPE, geom=tgeom,
                              cfg=TVConfig(scheme="hybrid"), **kw)
    assert torch.equal(again.x, got.x)
    assert len(ct._CONE_PRECOND_CACHE) == int(precond)
    ct.clear_projector_cache()
    assert not ct._CONE_PRECOND_CACHE and not cs._GRID_CACHE
