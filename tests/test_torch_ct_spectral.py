"""The port's parallel-beam spectral projector (``models/ct_spectral.py``)
against the JAX package's on the same seeded numpy inputs: the projection
and its explicit adjoint, the analytic oracles, per-frame angles and angle
chunks, precomputed against lazily built tables, the operator protocol, the
two DFT modes, bf16 storage, z chunks, ``precision=``, ``fbp`` and
``cp_reconstruct`` with ``method='spectral'``, ``'auto'``, and that no
operator gathers, scatters or indexes.

Tolerances: float64 projections, adjoints and ``fbp`` within 1e-11 of the
output's largest value (the two packages build the same tables from the
same float64 phases; their products differ in summation order only);
float32 within 1e-5 of the scale; reconstructions in float64 within 1e-9."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import pytv4d_tpu.models.ct as jct
import pytv4d_tpu.models.ct_spectral as jcs
from pytv4d_tpu.core.config import TVConfig as JConfig
from pytv4d_tpu_torch.core.config import TVConfig
from pytv4d_tpu_torch.models import ct
from pytv4d_tpu_torch.models import ct_spectral as cs

SHAPE = (2, 2, 24, 24)
# interleaved regimes, the 45-degree boundary and a ragged run order, so
# that the un-permutation by runs is exercised
SHARED = np.asarray([0.1, 1.3, 0.4, 1.9, 2.8, 1.0, np.pi / 4, 3 * np.pi / 4,
                     2.2, 0.7])
PER_FRAME = np.stack([SHARED, SHARED + 0.11])
ANGLES = {"shared": SHARED, "per-frame": PER_FRAME}
F64 = 1e-11
F32 = 1e-5


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def _gaussians(N, blobs):
    c0 = (N - 1) / 2.0
    rr, cc = np.meshgrid(np.arange(N) - c0, np.arange(N) - c0,
                         indexing="ij")
    img = np.zeros((N, N))
    for (r0, c0b, sig, amp) in blobs:
        img += amp * np.exp(-((rr - r0) ** 2 + (cc - c0b) ** 2)
                            / (2 * sig ** 2))
    return img


def _analytic_radon(N, n_det, angles, blobs):
    """Each Gaussian projects to ``amp sig sqrt(2 pi) exp(-(s - s0)^2 /
    (2 sig^2))`` with ``s0 = r0 cos(t) - c0 sin(t)``."""
    s = np.arange(n_det) - (n_det - 1) / 2.0
    out = np.zeros((len(angles), n_det))
    for i, t in enumerate(angles):
        for (r0, c0b, sig, amp) in blobs:
            s0 = r0 * np.cos(t) - c0b * np.sin(t)
            out[i] += amp * sig * np.sqrt(2 * np.pi) * np.exp(
                -(s - s0) ** 2 / (2 * sig ** 2))
    return out


BLOBS = [(0.0, 0.0, 2.0, 1.0), (3.0, -2.0, 1.8, 0.7), (-3.0, 2.0, 2.0, 0.5)]


@pytest.mark.parametrize("which, dtype, n_det", (
    ("shared", np.float64, None), ("shared", np.float32, 30),
    ("per-frame", np.float64, 30), ("per-frame", np.float32, None)))
def test_radon_spectral_matches_jax(which, dtype, n_det):
    angles = ANGLES[which]
    vol = np.random.default_rng(0).random(SHAPE).astype(dtype)
    want = np.asarray(jcs.radon_spectral(jnp.asarray(vol), angles,
                                         n_det=n_det))
    got = cs.radon_spectral(torch.tensor(vol), angles, n_det=n_det)
    assert got.dtype == torch.tensor(vol).dtype
    assert tuple(got.shape) == want.shape == (2, 2, 10, n_det or 24)
    assert _rel(got.numpy(), want) < (F64 if dtype == np.float64 else F32)


@pytest.mark.parametrize("which, dtype", (
    ("shared", np.float64), ("per-frame", np.float64),
    ("shared", np.float32)))
def test_adjoint_matches_jax_and_is_exact(which, dtype):
    """The explicit adjoint equals the JAX package's vjp, and the pair
    passes the dot test: 1e-12 relative in float64, 1e-5 in float32."""
    angles = ANGLES[which]
    rng = np.random.default_rng(1)
    x = rng.random(SHAPE).astype(dtype)
    y = rng.random((2, 2, 10, 24)).astype(dtype)
    A, A_T = cs.make_spectral_projector(SHAPE, angles,
                                        dtype=torch.tensor(x).dtype)
    jA, jA_T = jcs.make_spectral_projector(SHAPE, angles,
                                           dtype=jnp.asarray(x).dtype)
    got = A_T(torch.tensor(y))
    assert _rel(got.numpy(), np.asarray(jA_T(jnp.asarray(y)))) < (
        F64 if dtype == np.float64 else F32)
    lhs = float(np.vdot(y.astype(np.float64),
                        A(torch.tensor(x)).double().numpy()))
    rhs = float(np.vdot(got.double().numpy(), x.astype(np.float64)))
    assert abs(lhs - rhs) / abs(lhs) < (1e-12 if dtype == np.float64
                                        else 1e-5)
    # linearity
    x2 = rng.random(SHAPE).astype(dtype)
    lin = A(torch.tensor(2.0 * x + 0.5 * x2))
    np.testing.assert_allclose(
        lin.numpy(), (2.0 * A(torch.tensor(x)) + 0.5 * A(torch.tensor(x2)))
        .numpy(), rtol=0, atol=(1e-12 if dtype == np.float64 else 1e-4))


def test_analytic_gaussians_and_mass_in_the_disk():
    """Spectral accuracy against analytic line integrals (both regimes and
    their boundary), equal to the JAX package's; and the detector sum of an
    in-disk object is its mass (the DC term is exact)."""
    N = 32
    img = _gaussians(N, BLOBS)
    angles = np.concatenate([np.linspace(0, np.pi, 12, endpoint=False),
                             [np.pi / 4, 3 * np.pi / 4]])
    ana = _analytic_radon(N, N, angles, BLOBS)
    got = cs.radon_spectral(torch.tensor(img[None, None]), angles)[0, 0]
    want = np.asarray(jcs.radon_spectral(jnp.asarray(img[None, None]),
                                         angles))[0, 0]
    assert np.linalg.norm(got.numpy() - ana) / np.linalg.norm(ana) < 1e-5
    assert _rel(got.numpy(), want) < F64
    p = cs.radon_spectral(torch.tensor(img[None, None]),
                          np.asarray([0.3, 1.2, 2.2]), n_det=2 * N)
    np.testing.assert_allclose(p[0, 0].sum(dim=-1).numpy(), img.sum(),
                               rtol=1e-6)


def test_per_frame_angles_and_chunking():
    rng = np.random.default_rng(1)
    vol = torch.tensor(rng.random(SHAPE))
    pf = cs.radon_spectral(vol, PER_FRAME)
    for m in range(2):
        one = cs.radon_spectral(vol[:, m:m + 1], PER_FRAME[m])
        np.testing.assert_allclose(pf[:, m].numpy(), one[:, 0].numpy(),
                                   rtol=0, atol=1e-12)
    whole = cs.radon_spectral(vol, SHARED)
    for chunk in (1, 3):
        np.testing.assert_allclose(
            cs.radon_spectral(vol, SHARED, angle_chunk=chunk).numpy(),
            whole.numpy(), rtol=0, atol=1e-12)


@pytest.mark.parametrize("which", list(ANGLES))
def test_precomputed_tables_match_lazy_build(which):
    """The tables built once per projector give the lazy per-chunk build's
    values, forward and adjoint; only the precomputed pair carries the
    operator protocol."""
    rng = np.random.default_rng(7)
    x = torch.tensor(rng.random(SHAPE))
    y = torch.tensor(rng.random((2, 2, 10, 24)))
    A_e, AT_e = cs.make_spectral_projector(SHAPE, ANGLES[which],
                                           dtype=torch.float64,
                                           precompute_tables=True)
    A_l, AT_l = cs.make_spectral_projector(SHAPE, ANGLES[which],
                                           dtype=torch.float64,
                                           precompute_tables=False,
                                           angle_chunk=3)
    assert hasattr(A_e, "prepare") and not hasattr(A_l, "prepare")
    np.testing.assert_allclose(A_e(x).numpy(), A_l(x).numpy(), rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(AT_e(y).numpy(), AT_l(y).numpy(), rtol=1e-12,
                               atol=1e-12)


def test_operator_protocol_reconstruction_matches_lazy():
    """``cp_inverse`` through ``prepare()/apply`` and the explicit
    ``apply_T`` follows the lazy pair's trajectory (and the tables are built
    once, on the first application)."""
    from pytv4d_tpu_torch.solvers.inverse import cp_inverse

    rng = np.random.default_rng(11)
    vol = torch.tensor(rng.random(SHAPE), dtype=torch.float32)
    A_e, _ = cs.make_spectral_projector(SHAPE, SHARED)
    A_l, _ = cs.make_spectral_projector(SHAPE, SHARED,
                                        precompute_tables=False)
    sino = A_l(vol)
    res_e = cp_inverse(A_e, sino, SHAPE, n_iter=6, reg=0.1, op_norm=30.0)
    res_l = cp_inverse(A_l, sino, SHAPE, n_iter=6, reg=0.1, op_norm=30.0)
    np.testing.assert_allclose(res_e.x.numpy(), res_l.x.numpy(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(res_e.loss.numpy(), res_l.loss.numpy(),
                               rtol=1e-5)
    plan = A_e.prepare()
    assert len(plan._memo) == 1 and A_e.prepare() is plan


def test_dft_tables_match_rfft():
    """``_dft_tables`` reproduce the rfft in float64, the large ``c*k``
    corner included (the phase is reduced mod Np in integers)."""
    N, Np = 64, 128
    W = cs._dft_tables(N, Np, torch.float64, "cpu").numpy()
    X = np.random.default_rng(1).standard_normal((5, N))
    F = np.fft.rfft(X, n=Np, axis=-1)
    got = X @ W[:, :N + 1] + 1j * (X @ W[:, N + 1:])
    assert np.max(np.abs(got - F)) < 1e-12


@pytest.mark.parametrize("dtype", (np.float64, np.float32))
def test_matmul_dft_matches_fft(monkeypatch, dtype):
    """Both DFT modes give the same projection and adjoint (1e-13 in
    float64, 5e-6 in float32), as the JAX package's matmul mode does: each
    module set to each mode."""
    rng = np.random.default_rng(0)
    x = rng.random(SHAPE).astype(dtype)
    y = rng.random((2, 2, 10, 24)).astype(dtype)
    out = {}
    for mode in ("fft", "matmul"):
        monkeypatch.setattr(cs, "_DFT_MODE", mode)
        monkeypatch.setattr(jcs, "_DFT_MODE", mode)
        A, A_T = cs.make_spectral_projector(SHAPE, SHARED,
                                            dtype=torch.tensor(x).dtype)
        out[mode] = (A(torch.tensor(x)).numpy(), A_T(torch.tensor(y)).numpy())
    want = np.asarray(jcs.radon_spectral(jnp.asarray(x), SHARED))
    assert _rel(out["matmul"][0], want) < (F64 if dtype == np.float64
                                           else F32)
    tol = 1e-13 if dtype == np.float64 else 5e-6
    for i in range(2):
        assert _rel(out["matmul"][i], out["fft"][i]) < tol


def test_dft_mode_auto_is_fft_on_the_cpu():
    assert cs._DFT_MODE == "auto"
    assert cs._dft_mode(torch.device("cpu")) == "fft"
    assert cs._dft_mode(torch.device("cuda")) == cs._DFT_MODE_ON_CUDA


def test_bf16_storage_volume():
    """A bfloat16 volume is projected in float32 and returned in
    bfloat16: the error is the input's quantization, not phase garbage."""
    vol = _gaussians(32, [(0.0, 0.0, 5.0, 1.0)])[None, None]
    angles = np.linspace(0, np.pi, 8, endpoint=False) + 0.04
    ref = cs.radon_spectral(torch.tensor(vol, dtype=torch.float32), angles)
    p16 = cs.radon_spectral(torch.tensor(vol, dtype=torch.bfloat16), angles)
    assert p16.dtype == torch.bfloat16
    assert _rel(p16.float().numpy(), ref.numpy()) < 1e-2
    A, A_T = cs.make_spectral_projector((1, 1, 32, 32), angles,
                                        dtype=torch.bfloat16)
    assert A_T(p16).dtype == torch.bfloat16


def test_z_chunked_projector_identical():
    """``z_chunk`` streams the pair in z pieces: the same values, and the
    protocol survives the wrapper."""
    vs = (4, 2, 24, 24)
    A, A_T = cs.make_spectral_projector(vs, SHARED, dtype=torch.float64)
    Ac, ATc = cs.make_spectral_projector(vs, SHARED, dtype=torch.float64,
                                         z_chunk=2)
    rng = np.random.default_rng(0)
    x = torch.tensor(rng.random(vs))
    y = torch.tensor(rng.random(tuple(A(x).shape)))
    assert float((Ac(x) - A(x)).abs().max()) < 1e-12
    assert float((ATc(y) - A_T(y)).abs().max()) < 1e-12
    consts = Ac.prepare()
    assert float((Ac.apply(consts, x) - A(x)).abs().max()) < 1e-12
    assert float((Ac.apply_T(consts, y) - A_T(y)).abs().max()) < 1e-12
    with pytest.raises(ValueError, match="z_chunk"):
        cs.make_spectral_projector(vs, SHARED, z_chunk=3)


def test_input_validation_matches_jax():
    def message(call):
        with pytest.raises(ValueError) as err:
            call()
        return str(err.value)

    for bad, angles in ((np.zeros((16, 16)), [0.1]),
                        (np.zeros((2, 2, 8, 16)), [0.1]),
                        (np.zeros((2, 2, 16, 16)), np.zeros((3, 4)))):
        assert message(lambda: cs.radon_spectral(
            torch.tensor(bad), np.asarray(angles))) == message(
            lambda: jcs.radon_spectral(jnp.asarray(bad), np.asarray(angles)))
    with pytest.raises(ValueError, match="unknown precision"):
        cs.make_spectral_projector(SHAPE, SHARED, precision="fast")


def test_precision_flags_are_restored():
    """``'default'`` asks cuBLAS for TF32, ``'high'`` and ``'highest'`` for
    IEEE float32, for the one call: the global flag is restored after it,
    also when the call raises; on the CPU nothing is set."""
    flags = torch.backends.cuda.matmul
    before = flags.fp32_precision
    cuda = torch.device("cuda")
    for prec, want in (("default", "tf32"), ("high", "ieee"),
                       ("highest", "ieee")):
        with cs._matmul_precision(prec, cuda):
            assert flags.fp32_precision == want
        assert flags.fp32_precision == before
    with pytest.raises(RuntimeError, match="inside"):
        with cs._matmul_precision("default", cuda):
            raise RuntimeError("inside")
    assert flags.fp32_precision == before
    with cs._matmul_precision("default", torch.device("cpu")):
        assert flags.fp32_precision == before
    vol = torch.rand(SHAPE)
    out = {p: cs.radon_spectral(vol, SHARED, precision=p)
           for p in ("default", "high", "highest")}
    assert flags.fp32_precision == before
    assert torch.equal(out["default"], out["highest"])   # no effect on CPU
    assert torch.equal(out["high"], out["highest"])


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.names = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.add(func.__name__.split(".")[0])
        return func(*args, **(kwargs or {}))


FORBIDDEN = ("grid_sampler", "gather", "scatter", "index")


@pytest.mark.parametrize("mode", ("fft", "matmul"))
def test_no_gather_scatter_or_index_op(monkeypatch, mode):
    """The JAX package's HLO check, here on the aten ops A and A^T run:
    no sampler, gather, scatter, index or index_put, in either DFT mode
    (the regimes are un-permuted by copies of runs)."""
    monkeypatch.setattr(cs, "_DFT_MODE", mode)
    A, A_T = cs.make_spectral_projector(SHAPE, SHARED)
    x = torch.rand(SHAPE)
    A(x)  # the tables are built outside the recording
    with _Ops() as rec:
        y = A(x)
        A_T(y)
    assert "bmm" in rec.names
    bad = sorted(n for n in rec.names if n.startswith(FORBIDDEN))
    assert not bad, bad


@pytest.mark.parametrize("which, dtype", (
    ("shared", np.float64), ("per-frame", np.float32)))
def test_fbp_spectral_matches_jax(which, dtype):
    angles = ANGLES[which]
    sino = np.random.default_rng(2).random((2, 2, 10, 24)).astype(dtype)
    want = np.asarray(jct.fbp(jnp.asarray(sino), angles, method="spectral"))
    got = ct.fbp(torch.tensor(sino), angles, method="spectral")
    assert got.dtype == torch.tensor(sino).dtype
    assert _rel(got.numpy(), want) < (F64 if dtype == np.float64 else F32)
    assert ct.fbp(torch.tensor(sino), angles, n_out=20,
                  method="spectral").shape == (2, 2, 20, 20)


def test_cp_reconstruct_spectral_matches_jax():
    """Through the memoized pair and the fused loop, on the JAX package's
    trajectory in float64 (1e-9), plain and preconditioned, and per-frame
    angles with time coupling."""
    rng = np.random.default_rng(3)
    vol = rng.random(SHAPE)
    for angles, kw in ((SHARED, {}), (SHARED, dict(precond=True)),
                       (PER_FRAME, dict(cfg=dict(scheme="hybrid",
                                                 reg_time=0.5)))):
        sino = np.asarray(jcs.radon_spectral(jnp.asarray(vol), angles))
        cfg = kw.pop("cfg", {})
        want = jct.cp_reconstruct(jnp.asarray(sino), angles, SHAPE,
                                  n_iter=8, reg=0.05, method="spectral",
                                  cfg=JConfig(**cfg), **kw)
        got = ct.cp_reconstruct(torch.tensor(sino), angles, SHAPE, n_iter=8,
                                reg=0.05, method="spectral",
                                cfg=TVConfig(**cfg), **kw)
        np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x),
                                   rtol=1e-9, atol=1e-9)
        np.testing.assert_allclose(got.loss.numpy(), np.asarray(want.loss),
                                   rtol=1e-9)


def test_method_selection_and_precision_cache():
    """'auto' is the gather pair on the CPU and the table's choice on a
    CUDA device; each method and precision gets its own memoized pair;
    the spectral pair is exact in float64."""
    ct.clear_projector_cache()
    assert ct._resolve_method("auto", "parallel", "cpu") == "gather"
    for geom in ("parallel", "fan", "cone"):
        assert ct._resolve_method("auto", geom, "cuda") == \
            ct._AUTO_ON_CUDA[geom]
        assert ct._resolve_method("gather", geom, "cuda") == "gather"
    x = torch.rand((1, 1, 16, 16), dtype=torch.float64)
    angles = np.linspace(0, np.pi, 4, endpoint=False) + 0.1
    if not torch.cuda.is_available():
        A_auto, _ = ct.make_projector(x.shape, angles, dtype=torch.float64)
        A_g, _ = ct.make_projector(x.shape, angles, dtype=torch.float64,
                                   method="gather")
        assert A_auto is A_g
    hi = ct.make_projector(x.shape, angles, method="spectral",
                           precision="highest")
    df = ct.make_projector(x.shape, angles, method="spectral",
                           precision="default")
    assert hi[0] is not df[0] and ct.make_projector(
        x.shape, angles, method="spectral", precision="highest") is hi
    A_s, AT_s = ct.make_projector(x.shape, angles, dtype=torch.float64,
                                  method="spectral")
    y = A_s(x)
    assert tuple(y.shape) == (1, 1, 4, 16)
    lhs, rhs = float(torch.vdot(y.ravel(), y.ravel())), float(
        torch.vdot(AT_s(y).ravel(), x.ravel()))
    assert abs(lhs - rhs) / abs(lhs) < 1e-13
    ct.clear_projector_cache()
