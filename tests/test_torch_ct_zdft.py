"""The port's z-DFT offset-line cone tier (``radon_cone_spectral(order=2)``
in ``models/ct_spectral.py``) against the JAX package's on the same seeded
numpy inputs: the offset-line evaluator against the JAX one and a pixel-sum
NUDFT, its reduction to the real path at zero offset, the order-2 pair
(forward and the written-out transpose against the JAX forward and vjp)
for both z kernels with shared and per-frame angles, the dot test and
linearity, the preconditioner sums at ``order=2``, ``cp_inverse`` on the
pair, and the accuracy claim against exact cone integrals of 3D Gaussians
at a CPU size.

Tolerances: the evaluator 1e-12 (relative, in norm), the pair 1e-11 of the
output's largest value, the dot test 1e-11, the solve 1e-9, all float64."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytv4d_tpu.models.ct as jct
import pytv4d_tpu.models.ct_spectral as jcs
from pytv4d_tpu.core.config import TVConfig as JConfig
from pytv4d_tpu.solvers.inverse import cp_inverse as j_cp_inverse
from pytv4d_tpu_torch.core.config import TVConfig
from pytv4d_tpu_torch.models import ct
from pytv4d_tpu_torch.models import ct_spectral as cs
from pytv4d_tpu_torch.solvers.inverse import cp_inverse

SHAPE = (4, 2, 24, 24)
SHARED = np.linspace(0.0, 2 * np.pi, 5, endpoint=False) + 0.05
ANGLES = {"shared": SHARED, "per-frame": np.stack([SHARED, SHARED + 0.3])}
GEOM = dict(source_dist=48.0, det_dist=12.0)
F64 = 1e-11


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The tier issues thousands of small ops an application; beside the
    other test workers a thread pool per op spins for far longer than the
    op takes, so these tests run the port on one thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _norm_rel(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _complex(planar):
    """``(A, 2B, S)`` planar rows -> complex ``(B, A, S)``."""
    B = planar.shape[1] // 2
    z = planar[:, :B].numpy() + 1j * planar[:, B:].numpy()
    return np.moveaxis(z, 1, 0)


def _pair(which, z_kernel):
    angles = ANGLES[which]
    jA, _ = jcs.make_cone_spectral_projector(
        SHAPE, angles, jct.ConeBeamGeometry(**GEOM), dtype=jnp.float64,
        order=2, z_kernel=z_kernel)
    tA, tA_T = cs.make_cone_spectral_projector(
        SHAPE, angles, ct.ConeBeamGeometry(**GEOM), dtype=torch.float64,
        order=2, z_kernel=z_kernel)
    return jA, tA, tA_T


@pytest.mark.parametrize("vertical, angs", ((True, (1.2, np.pi / 2)),
                                            (False, (0.2, -0.5))))
@pytest.mark.parametrize("delta", (0.13, -0.27))
def test_modulated_bucket_matches_jax_and_a_pixel_sum(vertical, angs, delta):
    """The offset-line evaluator on a complex slab equals the JAX one and
    a direct pixel-sum NUDFT on the same trapezoidal lambda grid."""
    rng = np.random.default_rng(0)
    N, Np, n_det, ds = 16, 32, 20, 0.7
    img = rng.random((2, N, N)) + 1j * rng.random((2, N, N))
    th = np.array(angs)
    Fk = cs._modulated_spectrum(torch.as_tensor(img), vertical)
    got = _complex(cs._modulated_bucket(Fk, th, vertical, n_det, ds, delta))
    want = np.asarray(jcs._modulated_bucket(
        jnp.asarray(img, jnp.complex128), th, vertical, n_det, Np, ds, delta,
        jax.lax.Precision.HIGHEST))
    assert _norm_rel(got, want) < 1e-12
    # the pixel sum (tests/test_ct_spectral.py's brute force)
    c0 = (N - 1) / 2.0
    x = np.arange(N) - c0
    X, Y = np.meshgrid(x, x, indexing="ij")
    s_j = (np.arange(n_det) - (n_det - 1) / 2.0) * ds
    nu = 2 * np.pi * (np.arange(Np + 1) - Np // 2) / Np
    w = np.ones(Np + 1)
    w[0] = w[-1] = 0.5
    bf = np.zeros((2, len(th), n_det), complex)
    for a, t in enumerate(th):
        sin, cos = np.sin(t), np.cos(t)
        lam = (-(nu + delta * cos) / sin if vertical
               else (nu + delta * sin) / cos)
        den = abs(sin) if vertical else abs(cos)
        s_p, t_p = X * cos - Y * sin, X * sin + Y * cos
        for ki in range(Np + 1):
            fh = np.sum(img * np.exp(1j * delta * t_p - 1j * lam[ki] * s_p),
                        axis=(-2, -1))
            bf[:, a, :] += (w[ki] * fh[:, None]
                            * np.exp(1j * lam[ki] * s_j)[None, :]
                            / (Np * den))
    assert _norm_rel(got, bf) < 1e-12


@pytest.mark.parametrize("delta", (0.13, -0.27, 0.0))
def test_modulated_dense_matches_jax_and_the_real_path(delta):
    """Both regimes un-permuted against the JAX function; at zero offset
    the real half-spectrum path with a zero imaginary part."""
    rng = np.random.default_rng(1)
    N, n_det, ds = 16, 20, 0.7
    img = rng.random((2, N, N)) + 1j * rng.random((2, N, N))
    th = np.array([1.2, 1.9, 0.2, -0.5, 1.4])
    spectra = cs._modulated_spectra(torch.as_tensor(img), th)
    got = cs._modulated_dense(spectra, th, n_det, ds, delta)
    want = np.asarray(jcs._modulated_dense(
        jnp.asarray(img, jnp.complex128), th, n_det, ds, delta,
        jax.lax.Precision.HIGHEST))
    assert _norm_rel(_complex(got), want) < 1e-12
    if delta == 0.0:
        re = torch.as_tensor(np.real(img))
        dense = cs._modulated_dense(cs._modulated_spectra(re + 0j, th), th,
                                    n_det, ds, 0.0)
        ref = cs._radon_spectral_shared(re, th, n_det, None, det_spacing=ds)
        z = _complex(dense)
        assert _norm_rel(np.real(z), ref.numpy()) < 1e-12
        assert np.abs(np.imag(z)).max() < 1e-12


@pytest.mark.parametrize("which", list(ANGLES))
@pytest.mark.parametrize("z_kernel", ("hat", "trig"))
def test_zdft_pair_matches_jax(which, z_kernel):
    """The forward against JAX's, the written-out transpose against JAX's
    vjp of it, in the cone layout."""
    rng = np.random.default_rng(5)
    jA, tA, tA_T = _pair(which, z_kernel)
    x = rng.random(SHAPE)
    want = np.asarray(jA(jnp.asarray(x)))
    got = tA(torch.as_tensor(x))
    assert got.dtype == torch.float64 and tuple(got.shape) == want.shape
    assert want.shape == (2, 5, 4, 24)
    assert _rel(got.numpy(), want) < F64
    y = rng.random(want.shape)
    _, vjp = jax.vjp(jA, jnp.asarray(x))
    (want_T,) = vjp(jnp.asarray(y))
    got_T = tA_T(torch.as_tensor(y))
    assert tuple(got_T.shape) == SHAPE
    assert _rel(got_T.numpy(), np.asarray(want_T)) < F64


def test_zdft_dot_test_linearity_and_no_protocol():
    rng = np.random.default_rng(6)
    _, A, A_T = _pair("shared", "hat")
    x = torch.as_tensor(rng.random(SHAPE))
    y = torch.as_tensor(rng.random((2, 5, 4, 24)))
    lhs = float(torch.sum(y * A(x)))
    rhs = float(torch.sum(A_T(y) * x))
    assert abs(lhs - rhs) / abs(lhs) < F64
    x2 = torch.as_tensor(rng.random(SHAPE))
    np.testing.assert_allclose(A(2.0 * x + 0.5 * x2).numpy(),
                               (2.0 * A(x) + 0.5 * A(x2)).numpy(),
                               rtol=1e-10, atol=1e-10)
    # the tier builds its tables per node and application: no protocol
    assert getattr(A, "prepare", None) is None
    # its host constants are memoized, and the projector cache clears them
    assert cs._ZDFT_CACHE
    ct.clear_projector_cache()
    assert not cs._ZDFT_CACHE


def test_precond_sums_at_order_2_match_jax():
    """``order=2`` takes the order-1 abs-factor surrogate, as in JAX."""
    want = jcs.cone_spectral_precond_sums(
        SHAPE, SHARED, jct.ConeBeamGeometry(**GEOM), dtype=jnp.float64,
        order=2)
    got = cs.cone_spectral_precond_sums(
        SHAPE, SHARED, ct.ConeBeamGeometry(**GEOM), dtype=torch.float64,
        order=2, device="cpu")
    o1 = cs.cone_spectral_precond_sums(
        SHAPE, SHARED, ct.ConeBeamGeometry(**GEOM), dtype=torch.float64,
        order=1, device="cpu")
    for g, w, g1 in zip(got, want, o1):
        assert _rel(g.numpy(), np.asarray(w)) < F64
        assert torch.equal(g, g1)


def test_cp_inverse_on_the_zdft_pair_matches_jax():
    """20 iterations of ``cp_inverse`` on the order-2 pair at (4, 1, 24,
    24) x 8 angles: x and the loss trajectory on the JAX package's."""
    shape = (4, 1, 24, 24)
    angles = np.linspace(0.0, 2 * np.pi, 8, endpoint=False) + 0.05
    rng = np.random.default_rng(7)
    truth = rng.random(shape)
    jA, jA_T = jcs.make_cone_spectral_projector(
        shape, angles, jct.ConeBeamGeometry(**GEOM), dtype=jnp.float64,
        order=2)
    tA, tA_T = cs.make_cone_spectral_projector(
        shape, angles, ct.ConeBeamGeometry(**GEOM), dtype=torch.float64,
        order=2)
    b = np.asarray(jA(jnp.asarray(truth)))
    b = b + 0.05 * rng.standard_normal(b.shape)
    kw = dict(n_iter=20, reg=0.05, op_norm=30.0, nonneg=True)
    want = j_cp_inverse(jA, jnp.asarray(b), shape, A_T=jA_T,
                        cfg=JConfig(scheme="hybrid"), **kw)
    got = cp_inverse(tA, torch.as_tensor(b), shape, A_T=tA_T,
                     cfg=TVConfig(scheme="hybrid"), **kw)
    assert _rel(got.x.numpy(), np.asarray(want.x)) < 1e-9
    np.testing.assert_allclose(got.loss.numpy(), np.asarray(want.loss),
                               rtol=1e-9)
    assert float(got.loss[-1]) < float(got.loss[0])


# exact cone integrals of 3D Gaussians (tests/test_ct_spectral.py's oracle)
BLOBS = [(5.5, 0.45, 0.55, 2.0, 1.0), (9.5, 0.60, 0.40, 2.2, 0.7),
         (7.5, 0.40, 0.42, 1.8, 0.5)]


def _gauss_oracle(blobs, ang, geom, Nz, N):
    cz, c0 = (Nz - 1) / 2.0, (N - 1) / 2.0
    pu, pv = geom.spacing_u(), geom.spacing_v()
    u_ax = (np.arange(N) - (N - 1) / 2.0) * pu
    v_ax = (np.arange(Nz) - (Nz - 1) / 2.0) * pv
    orc = np.zeros((1, len(ang), Nz, N))
    for a, b in enumerate(ang):
        sinb, cosb = np.sin(b), np.cos(b)
        Sr, Sc, Sz = (c0 - geom.source_dist * sinb,
                      c0 - geom.source_dist * cosb, cz)
        Dr = c0 + geom.det_dist * sinb + u_ax[None, :] * cosb
        Dc = c0 + geom.det_dist * cosb - u_ax[None, :] * sinb
        Dz = cz + v_ax[:, None] + 0 * Dr
        dr, dc, dz = Dr - Sr, Dc - Sc, Dz - Sz
        inv = 1.0 / np.sqrt(dr ** 2 + dc ** 2 + dz ** 2)
        dr, dc, dz = dr * inv, dc * inv, dz * inv
        for (z0, rr, cc, s, amp) in blobs:
            wr, wc, wz = Sr - rr * N, Sc - cc * N, Sz - z0
            proj = wr * dr + wc * dc + wz * dz
            rho2 = (wr ** 2 + wc ** 2 + wz ** 2) - proj ** 2
            orc[0, a] += amp * np.sqrt(np.pi) * s * np.exp(-rho2 / s ** 2)
    return orc


def _blob_vol(blobs, Nz, N):
    z, r, c = np.mgrid[:Nz, :N, :N].astype(float)
    vol = np.zeros((Nz, 1, N, N))
    for (z0, rr, cc, s, amp) in blobs:
        vol[:, 0] += amp * np.exp(-(((z - z0) ** 2 + (r - rr * N) ** 2
                                     + (c - cc * N) ** 2) / s ** 2))
    return vol


@pytest.mark.parametrize("mult", (2.0, 4.0))
def test_zdft_beats_the_gather_cone_against_exact_integrals(mult):
    """The certification claim at (16, 1, 32, 32) x 8 (the JAX package in
    float64 there: gather 3.04% / 2.61%, order 2 'trig' 1.93% / 1.04%, at
    oversample=8 0.293% / 0.219%, D_so = 2N / 4N): order 2 beats the
    gather cone, and at oversample=8 stays below 0.4% and 0.15x it."""
    Nz, N = 16, 32
    vol = torch.as_tensor(_blob_vol(BLOBS, Nz, N))
    ang = np.linspace(0, 2 * np.pi, 8, endpoint=False) + 0.03
    geom = ct.ConeBeamGeometry(source_dist=mult * N, det_dist=0.5 * N)
    orc = _gauss_oracle(BLOBS, ang, geom, Nz, N)

    def rel(a):
        return _norm_rel(a.numpy(), orc)

    e_gather = rel(ct.radon_cone(vol, ang, geom))
    e_zdft = rel(cs.radon_cone_spectral(vol, ang, geom, order=2,
                                        z_kernel="trig"))
    e_zdft8 = rel(cs.radon_cone_spectral(vol, ang, geom, order=2,
                                         z_kernel="trig", oversample=8.0))
    assert e_zdft < e_gather, (e_zdft, e_gather)
    assert e_zdft8 < 0.004, e_zdft8
    assert e_zdft8 < 0.15 * e_gather, (e_zdft8, e_gather)
