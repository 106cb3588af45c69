"""The port's fan-beam spectral projector (``models/ct_spectral.py``:
rebinning onto a dense parallel grid over [0, pi), the fold and two
rebinning matmuls) against the JAX package's on the same seeded numpy
inputs: the projection and its explicit adjoint, per-frame angles, the
rebinning against a bilinear reference, the parallel limit, the operator
protocol, ``cp_reconstruct`` / ``tgv_reconstruct`` with ``geom=fan`` and
``method='spectral'``, and that no operator gathers, scatters or indexes.

Tolerances: float64 within 1e-11 of the output's largest value, float32
within 1e-5 of the scale, reconstructions in float64 within 1e-9."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import pytv4d_tpu.models.ct as jct
import pytv4d_tpu.models.ct_spectral as jcs
from pytv4d_tpu_torch.models import ct
from pytv4d_tpu_torch.models import ct_spectral as cs

SHAPE = (2, 2, 24, 24)
SHARED = np.linspace(0.0, 2 * np.pi, 10, endpoint=False) + 0.02
PER_FRAME = np.stack([SHARED, SHARED + 0.1])
ANGLES = {"shared": SHARED, "per-frame": PER_FRAME}
GEOMS = {"default": dict(source_dist=60.0, det_dist=20.0),
         "pitch": dict(source_dist=48.0, det_dist=30.0, det_spacing=1.3)}
F64 = 1e-11
F32 = 1e-5


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _geoms(name):
    return (jct.FanBeamGeometry(**GEOMS[name]),
            ct.FanBeamGeometry(**GEOMS[name]))


@pytest.mark.parametrize("geom, which, dtype", (
    ("default", "shared", np.float64), ("default", "per-frame", np.float32),
    ("pitch", "shared", np.float64)))
def test_fan_pair_matches_jax(geom, which, dtype):
    """Forward and explicit adjoint against the JAX package (its vjp), and
    the dot test (1e-12 relative in float64, 1e-5 in float32)."""
    jgeom, tgeom = _geoms(geom)
    angles = ANGLES[which]
    rng = np.random.default_rng(0)
    x = rng.random(SHAPE).astype(dtype)
    y = rng.random((2, 2, 10, 24)).astype(dtype)
    tdt = torch.tensor(x).dtype
    A, A_T = cs.make_fan_spectral_projector(SHAPE, angles, tgeom, dtype=tdt)
    jA, jA_T = jcs.make_fan_spectral_projector(SHAPE, angles, jgeom,
                                               dtype=jnp.asarray(x).dtype)
    tol = F64 if dtype == np.float64 else F32
    got, got_T = A(torch.tensor(x)), A_T(torch.tensor(y))
    assert got.dtype == tdt and tuple(got.shape) == (2, 2, 10, 24)
    assert _rel(got.numpy(), np.asarray(jA(jnp.asarray(x)))) < tol
    assert _rel(got_T.numpy(), np.asarray(jA_T(jnp.asarray(y)))) < tol
    lhs = float(np.vdot(y.astype(np.float64), got.double().numpy()))
    rhs = float(np.vdot(got_T.double().numpy(), x.astype(np.float64)))
    assert abs(lhs - rhs) / abs(lhs) < (1e-12 if dtype == np.float64
                                        else 1e-5)
    # the functional form, with its tables built for the one call
    np.testing.assert_allclose(
        cs.radon_fan_spectral(torch.tensor(x), angles, tgeom).numpy(),
        got.numpy(), rtol=0, atol=1e-12 if dtype == np.float64 else 1e-5)


def test_per_frame_angles_are_frames_of_their_own():
    _, tgeom = _geoms("default")
    vol = torch.tensor(np.random.default_rng(1).random(SHAPE))
    pf = cs.radon_fan_spectral(vol, PER_FRAME, tgeom)
    for m in range(2):
        one = cs.radon_fan_spectral(vol[:, m:m + 1], PER_FRAME[m], tgeom)
        np.testing.assert_allclose(pf[:, m].numpy(), one[:, 0].numpy(),
                                   rtol=0, atol=1e-12)
    with pytest.raises(ValueError, match="per-frame angles"):
        cs.radon_fan_spectral(vol, np.zeros((3, 4)), tgeom)


def _bilinear(img, ti, si):
    """``map_coordinates(order=1, mode='constant', cval=0)`` of a 2-D array
    at points ``(ti, si)``: the 4-term sum, corners outside contributing
    zero."""
    out = np.zeros(ti.shape)
    t0, s0 = np.floor(ti).astype(int), np.floor(si).astype(int)
    for dt in (0, 1):
        for ds in (0, 1):
            t, s = t0 + dt, s0 + ds
            w = (1 - np.abs(ti - t)) * (1 - np.abs(si - s))
            ok = (t >= 0) & (t < img.shape[0]) & (s >= 0) & (s < img.shape[1])
            out += np.where(ok, w * img[np.clip(t, 0, img.shape[0] - 1),
                                         np.clip(s, 0, img.shape[1] - 1)],
                            0.0)
    return out


@pytest.mark.parametrize("full, off", ((True, 0.0), (False, 0.0371)))
def test_rebin_matmuls_match_bilinear_reference(full, off):
    """The rebinning as two matmuls (``_rebin_device`` / ``_rebin_apply``)
    is the bilinear resample at the fan coordinates, both fold parities and
    misaligned grids included; its transpose (and the fold's) is exact."""
    rng = np.random.default_rng(0)
    A, U, N = (16, 24, 24) if full else (17, 20, 24)
    ang = np.linspace(0, (2 if full else 1) * np.pi, A, endpoint=False) + off
    geom = ct.FanBeamGeometry(source_dist=2.0 * N, det_dist=1.0 * N)
    grid = cs._fan_dense_grid(ang, geom, U, N, 2.0)
    assert grid is cs._fan_dense_grid(ang, geom, U, N, 2.0)  # memoized
    dense = torch.tensor(rng.random((3, 2, len(grid.thetas), grid.n_s)))
    dp = cs._fold_pad(dense, grid.pad)
    Ws, Wt = cs._rebin_device(grid, torch.float64, "cpu")
    out = cs._rebin_apply(dp, Ws, Wt)
    ref = np.stack([np.stack([_bilinear(dp[i, j].numpy(), grid.ti, grid.si)
                              for j in range(2)]) for i in range(3)])
    assert float(np.abs(out.numpy() - ref).max()) < 1e-13
    y = torch.tensor(rng.random(tuple(out.shape)))
    lhs = float(torch.vdot(y.ravel(), out.ravel()))
    rhs = float(torch.vdot(cs._fold_pad_T(cs._rebin_apply_T(y, Ws, Wt),
                                          grid.pad).ravel(), dense.ravel()))
    assert abs(lhs - rhs) / abs(lhs) < 1e-13


def test_parallel_limit():
    """A huge source distance closes the fan: the rebinned path approaches
    the parallel spectral projector (the residual is the rebinning's
    bilinear interpolation)."""
    c0 = 11.5
    rr, cc = np.meshgrid(np.arange(24) - c0, np.arange(24) - c0,
                         indexing="ij")
    img = np.exp(-(rr ** 2 + (cc - 1.0) ** 2) / (2 * 4.0 ** 2))[None, None]
    far = ct.FanBeamGeometry(source_dist=1e7, det_dist=0.0, det_spacing=1.0)
    ang = SHARED[:6]
    pfan = cs.radon_fan_spectral(torch.tensor(img), ang, far).numpy()
    ppar = cs.radon_spectral(torch.tensor(img), ang).numpy()
    assert np.linalg.norm(pfan - ppar) / np.linalg.norm(ppar) < 1e-3


def test_operator_protocol():
    _, tgeom = _geoms("default")
    A, A_T = cs.make_fan_spectral_projector(SHAPE, SHARED, tgeom,
                                            dtype=torch.float64)
    x = torch.tensor(np.random.default_rng(7).random(SHAPE))
    consts = A.prepare()
    assert torch.equal(A.apply(consts, x), A(x))
    y = A(x)
    assert torch.equal(A.apply_T(consts, y), A_T(y))


@pytest.mark.parametrize("solver", ("cp", "tgv"))
def test_reconstructions_match_jax(solver):
    """``cp_reconstruct`` and ``tgv_reconstruct`` with ``geom=fan``,
    ``method='spectral'`` on the JAX package's trajectory in float64."""
    jgeom, tgeom = _geoms("default")
    vol = np.random.default_rng(3).random(SHAPE)
    sino = np.asarray(jcs.radon_fan_spectral(jnp.asarray(vol), SHARED,
                                             jgeom))
    kw = dict(n_iter=6, method="spectral")
    if solver == "cp":
        want = jct.cp_reconstruct(jnp.asarray(sino), SHARED, SHAPE,
                                  geom=jgeom, reg=0.05, **kw)
        got = ct.cp_reconstruct(torch.tensor(sino), SHARED, SHAPE,
                                geom=tgeom, reg=0.05, **kw)
    else:
        want = jct.tgv_reconstruct(jnp.asarray(sino), SHARED, SHAPE,
                                   geom=jgeom, **kw)
        got = ct.tgv_reconstruct(torch.tensor(sino), SHARED, SHAPE,
                                 geom=tgeom, **kw)
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=1e-9,
                               atol=1e-9)
    np.testing.assert_allclose(got.loss.numpy(), np.asarray(want.loss),
                               rtol=1e-9)


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.names = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.add(func.__name__.split(".")[0])
        return func(*args, **(kwargs or {}))


def test_no_gather_scatter_or_index_op():
    _, tgeom = _geoms("default")
    A, A_T = cs.make_fan_spectral_projector(SHAPE, PER_FRAME, tgeom)
    x = torch.rand(SHAPE)
    A(x)  # the plan is built outside the recording
    with _Ops() as rec:
        A_T(A(x))
    assert "bmm" in rec.names and "flip" in rec.names
    bad = sorted(n for n in rec.names
                 if n.startswith(("grid_sampler", "gather", "scatter",
                                  "index")))
    assert not bad, bad
