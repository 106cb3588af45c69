"""Gather-free CT projectors: the Fourier-slice theorem on a linogram
frequency grid, evaluated with FFTs and dense matmuls only.  The port of
``pytv4d_tpu/models/ct_spectral.py``.

Math (the JAX package's module docstring has the derivation).  The volume
slice is a sum of point masses at pixel centres; a detector cell at ``s``
integrates it along the line ``(c0 + s cos t + u sin t, c0 - s sin t + u
cos t)``, the parametrization of the gather :func:`..ct.radon`.  Put one
frequency component on the padded DFT grid and evaluate the other by a
non-uniform DFT over the remaining axis:

- near-vertical rays (``|sin t| >= |cos t|``): the column DFT of every row
  once, then ``G[t, k] = sum_r F[r, k] exp(+2i pi k cot(t) x_r / Np)``;
- near-horizontal rays: the row DFT, then the mirrored contraction over
  columns.

Both are exact evaluations of the image transform at the slice
frequencies; the one discretization is the detector synthesis
``p[s_j] = sum_k G[t, k] E[t, k, s_j]``, a second matmul.  The volume is
real, so only the half spectrum ``k = 0 .. Np/2`` is kept (weight 2 on the
interior bins).

Layout of one application (``B`` slices, ``A`` angles of one regime,
``K = N + 1`` bins, ``S`` detector cells):

1. the padded half spectrum ``F`` as planar real and imaginary parts,
   k-major: ``(K, 2B, N)``, from ``torch.fft.rfft`` (``'fft'``) or one
   matmul with an exact-phase DFT table (``'matmul'``, see ``_DFT_MODE``);
2. stage 1, one ``bmm`` over ``k``: ``(K, 2B, N) @ (K, N, 2A)`` gives all
   four products ``{Fr, Fi} x {Pr, Pi}``, combined into ``G``, ``(A, B, 2K)``;
3. stage 2, one ``bmm`` over the angles: ``(A, B, 2K) @ (A, 2K, S)`` is
   ``Re(G E) = [Gr, Gi] . [Er; -Ei]``.

Each adjoint is written stage by stage: the transposed synthesis, the
transposed k-batched product (the same table, transposed in place), then
the transpose of the DFT.  For the rfft that is ``Np irfft(G w)[:N]`` with
``w = 1`` on bins 0 and ``Np/2`` and 1/2 elsewhere (the imaginary parts of
those two bins contribute nothing and are zeroed).  No operator here
gathers, scatters or indexes: a regime's angles are un-permuted by copies
of contiguous runs, the fan rebinning is two matmuls with host-built
bilinear weights, the cone's z interpolation a matmul.

The NUDFT tables are built once per projector, per device and dtype, on
the device of the input they serve, from float64 phases (float32 storage
for every input narrower than float64).  ``precision`` chooses the matmuls'
arithmetic on a CUDA device: ``'default'`` TF32, ``'high'`` and
``'highest'`` IEEE float32; the setting holds for the one call and the
global flag is restored after it.  On the CPU it has no effect.  The cone's
z contractions and the FDK rebinning always run in IEEE arithmetic.

The cone's ``order=2`` is the z-DFT offset-line tier (:func:`_zdft_apply`):
the volume's z-DFT slabs, each slab's full complex spectrum evaluated on
lines offset along the ray (the tables above with the offset folded in,
built per Chebyshev offset node and application and freed), the fold pad
and the rebinning per fold parity, and a Lagrange combination of the nodes
per ray; its slab DFT and Lagrange matmuls run in IEEE arithmetic too.
"""

from __future__ import annotations

import collections
import contextlib
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..utils.device import on_device

_SPECTRAL_TABLE_BUDGET = 256 * 1024 * 1024  # bytes of in-flight phase table
# make_spectral_projector builds the whole NUDFT tables once when they fit
# this budget; above it every application rebuilds them, angle_chunk
# angles at a time
_SPECTRAL_EAGER_TABLE_BUDGET = 512 * 1024 * 1024

_DFT_MODE = "auto"
# how the padded half spectrum F is computed:
#   "fft"    torch.fft.rfft (cuFFT on the card);
#   "matmul" one matmul with the exact-phase table of _dft_tables;
#   "auto"   "fft" on the CPU, _DFT_MODE_ON_CUDA on a CUDA device.
# On an NVIDIA H100 80GB HBM3, 700.00 W, chip_smoke.py phase 28 times both
# at (16, 4, 512, 512) x 96 angles: "fft" is the faster (PERF.md section 6).
_DFT_MODE_ON_CUDA = "fft"

_PRECISIONS = ("default", "high", "highest")
_DEFAULT_PRECISION = "high"


def _concrete_angles(angles):
    """The angles as a float64 numpy array (host values: the regime split
    and the tables are built from them)."""
    if isinstance(angles, torch.Tensor):
        angles = angles.detach().cpu().numpy()
    return np.asarray(angles, dtype=np.float64)


def _dft_mode(device) -> str:
    if _DFT_MODE != "auto":
        return _DFT_MODE
    return "fft" if torch.device(device).type == "cpu" else _DFT_MODE_ON_CUDA


def _check_precision(precision):
    precision = precision or _DEFAULT_PRECISION
    if precision not in _PRECISIONS:
        raise ValueError(
            f"unknown precision {precision!r}; expected one of {_PRECISIONS}")
    return precision


@contextlib.contextmanager
def _matmul_precision(precision, device):
    """Run the block's float32 matmuls on a CUDA device in TF32
    (``'default'``) or IEEE float32 (``'high'``, ``'highest'``), and restore
    the global cuBLAS flag after it.  On any other device nothing is set."""
    precision = _check_precision(precision)
    if torch.device(device).type != "cuda":
        yield
        return
    # the fp32_precision API only: mixing it with allow_tf32 raises
    flags = torch.backends.cuda.matmul
    saved = flags.fp32_precision
    flags.fp32_precision = "tf32" if precision == "default" else "ieee"
    try:
        yield
    finally:
        flags.fp32_precision = saved


def _real_dtype(dtype):
    """The arithmetic's dtype: float64 for float64, else float32 (the
    phases reach ~1e3 radians, where a narrower type is radians wrong)."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def _np_dtype(real_dt):
    return np.float64 if real_dt == torch.float64 else np.float32


# ------------------------------------------------- device-resident constants
_DEVICE_CACHE: "collections.OrderedDict" = collections.OrderedDict()
_DEVICE_CACHE_MAX = 32


def _device_memo(key, build):
    """A small LRU of constants that are pure functions of their key (the
    DFT weights and tables, the FDK rebinning matrices on a device)."""
    hit = _DEVICE_CACHE.get(key)
    if hit is not None:
        _DEVICE_CACHE.move_to_end(key)
        return hit
    val = build()
    if len(_DEVICE_CACHE) >= _DEVICE_CACHE_MAX:
        _DEVICE_CACHE.popitem(last=False)
    _DEVICE_CACHE[key] = val
    return val


class _Plan:
    """A projector's geometry constants, built by ``build(device, dtype)``
    once per device and dtype on first use: the ``consts`` of its
    ``prepare()/apply(consts, x)`` protocol."""

    def __init__(self, build):
        self._build = build
        self._memo = {}

    def get(self, device, dtype):
        key = (torch.device(device), dtype)
        if key not in self._memo:
            self._memo[key] = self._build(key[0], dtype)
        return self._memo[key]


def _attach_protocol(A, plan, apply, apply_T):
    """``A.prepare() -> plan``, ``A.apply(plan, x)`` and the explicit
    transpose ``A.apply_T(plan, y)``, which ``solvers.inverse`` binds."""
    A.prepare = lambda: plan
    A.apply = apply
    A.apply_T = apply_T
    return A


# ------------------------------------------------------------ parallel beam
def _dft_tables(N: int, Np: int, real_dt, device):
    """The rfft as one matmul: ``W = [Wr | Wi]``, ``(N, 2K)`` with
    ``K = Np//2 + 1``: ``F[..., x, k] = sum_c img[..., x, c] W[c, k]``,
    ``W = exp(-2i pi c k / Np)``.  The phase is reduced mod ``Np`` in integer
    arithmetic first, so every entry is exact to one cos/sin rounding."""
    c = torch.arange(N, dtype=torch.int64, device=device)
    k = torch.arange(Np // 2 + 1, dtype=torch.int64, device=device)
    m = (c[:, None] * k[None, :]) % Np
    ph = (-2.0 * np.pi / Np) * m.to(torch.float64)
    return torch.cat([torch.cos(ph), torch.sin(ph)], dim=1).to(real_dt)


def _dft_consts(N: int, mode: str, real_dt, device):
    """What the spectrum and its transpose read: the matmul table, or the
    rfft transpose's bin weights ``(wr, wi)`` with the factor ``Np``."""
    Np, K = 2 * N, N + 1

    def build():
        if mode == "matmul":
            return _dft_tables(N, Np, real_dt, device)
        wr = torch.full((K,), Np / 2.0, dtype=real_dt, device=device)
        wi = wr.clone()
        wr[0] = wr[K - 1] = Np
        wi[0] = wi[K - 1] = 0.0
        return wr, wi

    return _device_memo(("dft", N, mode, real_dt, torch.device(device)),
                        build)


def _spectrum(v, vertical: bool, mode: str, dft):
    """The padded half spectrum of ``v`` ``(B, N, N)`` along the
    contraction axis (columns when ``vertical``, else rows), planar and
    k-major: ``(K, 2B, N)``, rows ``[re of every slice, im of every
    slice]``."""
    B, N = v.shape[0], v.shape[-1]
    K = N + 1
    if mode == "matmul":
        if vertical:   # F[b, r, (i, k)]
            Fk = torch.matmul(v, dft).view(B, N, 2, K).permute(3, 2, 0, 1)
        else:          # F[b, (i, k), c]
            Fk = torch.matmul(dft.t(), v).view(B, 2, K, N).permute(
                2, 1, 0, 3)
    elif vertical:
        F = torch.fft.rfft(v, n=2 * N, dim=-1)             # (B, r, k)
        Fk = torch.view_as_real(F).permute(2, 3, 0, 1)
    else:
        F = torch.fft.rfft(v, n=2 * N, dim=-2)             # (B, k, c)
        Fk = torch.view_as_real(F).permute(1, 3, 0, 2)
    return Fk.reshape(K, 2 * B, N)


def _spectrum_T(Fk_bar, vertical: bool, mode: str, dft):
    """The transpose of :func:`_spectrum`: ``(K, 2B, N) -> (B, N, N)``."""
    K, N = Fk_bar.shape[0], Fk_bar.shape[-1]
    B = Fk_bar.shape[1] // 2
    F4 = Fk_bar.view(K, 2, B, N)
    if mode == "matmul":
        if vertical:
            return torch.matmul(F4.permute(2, 3, 1, 0).reshape(B, N, 2 * K),
                                dft.t())
        return torch.matmul(dft, F4.permute(2, 1, 0, 3).reshape(B, 2 * K, N))
    wr, wi = dft
    Z = torch.complex(F4[:, 0] * wr[:, None, None],
                      F4[:, 1] * wi[:, None, None])          # (K, B, N)
    if vertical:
        return torch.fft.irfft(Z.permute(1, 2, 0), n=2 * (K - 1),
                               dim=-1)[..., :N]
    return torch.fft.irfft(Z.permute(1, 0, 2), n=2 * (K - 1),
                           dim=-2)[..., :N, :]


def _chunk_tables(ang: np.ndarray, vertical: bool, N: int, n_det: int,
                  real_dt, device, det_spacing: float = 1.0):
    """The NUDFT tables of one regime's angle set, from float64 phases:
    ``Pk`` ``(K, N, 2A)``, the slice NUDFT ``[Pr | Pi]`` stored k-major for
    stage 1, and ``Es`` ``(A, 2K, S)``, the detector synthesis ``[Er; -Ei]``
    with the regime scale and the padded DFT's centring phase
    ``e^{+2i pi k c0 / Np}`` folded in (both are k-separable)."""
    Np = 2 * N
    c0 = (N - 1) / 2.0
    f64 = dict(dtype=torch.float64, device=device)
    k = torch.arange(Np // 2 + 1, **f64)
    wk = torch.full_like(k, 2.0)
    wk[0] = wk[Np // 2] = 1.0
    s_j = (torch.arange(n_det, **f64) - (n_det - 1) / 2.0) * det_spacing
    x = torch.arange(N, **f64) - c0
    th = torch.as_tensor(ang, **f64)
    sin, cos = torch.sin(th), torch.cos(th)
    if vertical:
        # the column DFT holds v_k = 2 pi k / Np; u_k = -2 pi k cot(t) / Np
        # by the row NUDFT; w_k = -2 pi k / (Np sin t)
        slope, denom, det_sign = cos / sin, sin, -1.0
    else:
        # u_k on the grid, v_k = -2 pi k tan(t) / Np by the column NUDFT;
        # w_k = +2 pi k / (Np cos t)
        slope, denom, det_sign = sin / cos, cos, 1.0
    # P[k, r, a] = e^{-i u_k x_r} (vertical) / e^{-i v_k y_c} (horizontal)
    phase = ((2.0 * np.pi / Np) * slope)[None, None, :] \
        * x[None, :, None] * k[:, None, None]
    Pk = torch.cat([torch.cos(phase), torch.sin(phase)], dim=-1)
    # the synthesis p[s_j] = 1/(Np |denom|) sum_k G e^{i w_k s_j}, with the
    # centring phase e^{+2i pi k c0 / Np} of the padded DFT
    dphase = ((det_sign * 2.0 * np.pi / Np)
              * (k[None, :, None] / denom[:, None, None])
              * s_j[None, None, :]
              + (2.0 * np.pi * c0 / Np) * k[None, :, None])
    scale = wk[None, :, None] / (Np * torch.abs(denom))[:, None, None]
    Es = torch.cat([torch.cos(dphase) * scale, -(torch.sin(dphase) * scale)],
                   dim=1)
    return Pk.to(real_dt), Es.to(real_dt)


def _planar_apply(Fk, tables):
    """Stage 1 and 2 of one regime on the spectrum ``Fk`` ``(K, 2B, N)``:
    ``(A, B, S)``."""
    Pk, Es = tables
    K, A = Pk.shape[0], Es.shape[0]
    B = Fk.shape[1] // 2
    prod = torch.bmm(Fk, Pk)                               # (K, 2B, 2A)
    G = torch.stack([prod[:, :B, :A] - prod[:, B:, A:],    # Gr
                     prod[:, :B, A:] + prod[:, B:, :A]])   # Gi: (2, K, B, A)
    return torch.bmm(G.permute(3, 2, 0, 1).reshape(A, B, 2 * K), Es)


def _planar_apply_T(yb, tables):
    """The transpose of :func:`_planar_apply`: ``(A, B, S) -> (K, 2B, N)``."""
    Pk, Es = tables
    K, A = Pk.shape[0], Es.shape[0]
    B = yb.shape[1]
    Gb = torch.bmm(yb, Es.transpose(1, 2)).view(A, B, 2, K)
    Gr, Gi = Gb[:, :, 0].permute(2, 1, 0), Gb[:, :, 1].permute(2, 1, 0)
    # Fr' = Gr' Pr^T + Gi' Pi^T, Fi' = Gi' Pr^T - Gr' Pi^T
    return torch.bmm(_complex_rows(Gr, Gi), Pk.transpose(1, 2))


def _auto_chunk(N: int, Np: int, n_det: int, itemsize: int) -> int:
    per_angle = (N * Np + Np * n_det) * itemsize  # P + E tables (half-k)
    return max(1, _SPECTRAL_TABLE_BUDGET // max(per_angle, 1))


def _regime_split(ang: np.ndarray):
    """Static vertical/horizontal regime split of a concrete angle set."""
    vert = np.abs(np.sin(ang)) >= np.abs(np.cos(ang))
    return np.nonzero(vert)[0], np.nonzero(~vert)[0]


def _runs(idx: np.ndarray):
    """``(j0, j1, i0)`` for each run of consecutive values in ``idx``:
    ``idx[j0:j1] == i0 + arange(j1 - j0)``."""
    runs, j0 = [], 0
    for j in range(1, len(idx) + 1):
        if j == len(idx) or idx[j] != idx[j - 1] + 1:
            runs.append((j0, j, int(idx[j0])))
            j0 = j
    return runs


def _spectral_tables_shared(ang: np.ndarray, N: int, n_det: int, real_dt,
                            device, det_spacing: float = 1.0):
    """Both regimes' tables of one concrete angle set, keyed by the regime
    as :func:`_regime_split` splits it."""
    idx_v, idx_h = _regime_split(ang)
    return {vert: (_chunk_tables(ang[idx], vert, N, n_det, real_dt, device,
                                 det_spacing) if idx.size else None)
            for vert, idx in ((True, idx_v), (False, idx_h))}


def _bucket_parts(ang_b, vertical, N, n_det, angle_chunk, det_spacing,
                  tables, real_dt, device):
    """``(start, stop, tables)`` over one regime's angles: the precomputed
    whole, or chunks whose tables are built for this application."""
    if tables is not None:
        yield 0, len(ang_b), tables
        return
    for a in range(0, len(ang_b), angle_chunk):
        b = min(a + angle_chunk, len(ang_b))
        yield a, b, _chunk_tables(ang_b[a:b], vertical, N, n_det, real_dt,
                                  device, det_spacing)


def _radon_spectral_shared(vol, ang: np.ndarray, n_det: int,
                           angle_chunk: Optional[int],
                           det_spacing: float = 1.0, tables=None):
    """Shared-angle path: ``vol`` ``(..., N, N)``, ``ang`` concrete
    ``(A,)``; returns ``(..., A, n_det)`` in ``vol``'s dtype.  ``tables``:
    precomputed per-regime tables (:func:`_spectral_tables_shared`), else
    built per chunk of ``angle_chunk`` angles."""
    N = vol.shape[-1]
    lead = tuple(vol.shape[:-2])
    real_dt = _real_dtype(vol.dtype)
    if angle_chunk is None:
        angle_chunk = _auto_chunk(N, 2 * N, n_det, vol.element_size() * 2)
    v = vol.reshape(-1, N, N).to(real_dt)
    mode = _dft_mode(v.device)
    dft = _dft_consts(N, mode, real_dt, v.device)
    pieces = []
    for vert, idx in zip((True, False), _regime_split(ang)):
        if not idx.size:
            continue
        Fk = _spectrum(v, vert, mode, dft)
        parts = [_planar_apply(Fk, t) for _, _, t in _bucket_parts(
            ang[idx], vert, N, n_det, angle_chunk, det_spacing,
            tables[vert] if tables else None, real_dt, v.device)]
        part = parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)
        pieces += [(i0, part[j0:j1]) for j0, j1, i0 in _runs(idx)]
    # un-permute by concatenating the regimes' runs of consecutive angles
    # in order: the order is static, and an index op would gather
    out = torch.cat([p for _, p in sorted(pieces, key=lambda q: q[0])],
                    dim=0)                                 # (A, B, S)
    return out.transpose(0, 1).reshape(lead + (ang.shape[0], n_det)) \
        .to(vol.dtype)


def _radon_spectral_shared_T(y, ang: np.ndarray, N: int,
                             angle_chunk: Optional[int],
                             det_spacing: float = 1.0, tables=None):
    """The exact transpose of :func:`_radon_spectral_shared`:
    ``(..., A, n_det) -> (..., N, N)`` in ``y``'s dtype."""
    n_det = y.shape[-1]
    lead = tuple(y.shape[:-2])
    real_dt = _real_dtype(y.dtype)
    if angle_chunk is None:
        angle_chunk = _auto_chunk(N, 2 * N, n_det, y.element_size() * 2)
    y3 = y.reshape(-1, ang.shape[0], n_det).to(real_dt)
    mode = _dft_mode(y3.device)
    dft = _dft_consts(N, mode, real_dt, y3.device)
    vol = None
    for vert, idx in zip((True, False), _regime_split(ang)):
        if not idx.size:
            continue
        runs = [y3[:, i0:i0 + j1 - j0] for j0, j1, i0 in _runs(idx)]
        yb = (runs[0] if len(runs) == 1 else torch.cat(runs, dim=1)) \
            .transpose(0, 1)                               # (A_b, B, S)
        Fk_bar = None
        for a, b, t in _bucket_parts(
                ang[idx], vert, N, n_det, angle_chunk, det_spacing,
                tables[vert] if tables else None, real_dt, y3.device):
            part = _planar_apply_T(yb[a:b], t)
            Fk_bar = part if Fk_bar is None else Fk_bar + part
        part = _spectrum_T(Fk_bar, vert, mode, dft)
        vol = part if vol is None else vol + part
    return vol.reshape(lead + (N, N)).to(y.dtype)


def radon_spectral(vol, angles, n_det: Optional[int] = None,
                   angle_chunk: Optional[int] = None, _tables=None,
                   precision: Optional[str] = None, device=None):
    """Gather-free forward projection of a ``(Nz, M, N, N)`` volume.

    Drop-in for :func:`..ct.radon` (same layouts: ``angles`` is
    ``(n_angles,)`` shared or ``(M, n_angles)`` per-frame, returns
    ``(Nz, M, n_angles, n_det)``) with spectral accuracy instead of
    bilinear O(h^2), integrating full lines (the gather radon truncates each
    ray to N samples), and no gather in the computation.  ``angle_chunk``
    bounds the in-flight NUDFT table (default: ~256 MB); ``precision`` as
    in the module docstring.  Low-precision volumes (bfloat16) are
    projected in float32 and returned in their own dtype.  A numpy volume
    goes to the CUDA device unless ``device`` names another."""
    vol = on_device(vol, device)
    if vol.ndim != 4:
        raise ValueError(
            f"radon_spectral expects a rank-4 (Nz, M, N, N) volume, got "
            f"shape {tuple(vol.shape)}")
    N = vol.shape[-1]
    if vol.shape[-2] != N:
        raise ValueError(
            f"radon_spectral supports square in-plane volumes, got "
            f"{vol.shape[-2]} x {N}")
    n_det = n_det or N
    ang = _concrete_angles(angles)
    with _matmul_precision(precision, vol.device):
        if ang.ndim == 1:
            return _radon_spectral_shared(vol, ang, n_det, angle_chunk,
                                          tables=_tables)
        if ang.ndim != 2 or ang.shape[0] != vol.shape[1]:
            raise ValueError(
                f"angles must be (n_angles,) shared or (M={vol.shape[1]}, "
                f"n_angles) per-frame, got shape {ang.shape}")
        return torch.stack([
            _radon_spectral_shared(vol[:, m], ang[m], n_det, angle_chunk,
                                   tables=_tables[m] if _tables else None)
            for m in range(ang.shape[0])], dim=1)


def _radon_spectral_T(y, ang: np.ndarray, N: int, angle_chunk, tables):
    """The transpose of :func:`radon_spectral` (layouts and tables as
    there; the caller sets the precision)."""
    if ang.ndim == 1:
        return _radon_spectral_shared_T(y, ang, N, angle_chunk,
                                        tables=tables)
    return torch.stack([
        _radon_spectral_shared_T(y[:, m], ang[m], N, angle_chunk,
                                 tables=tables[m] if tables else None)
        for m in range(ang.shape[0])], dim=1)


def make_spectral_projector(vol_shape, angles, n_det: Optional[int] = None,
                            dtype=torch.float32,
                            angle_chunk: Optional[int] = None,
                            precompute_tables: Optional[bool] = None,
                            precision: Optional[str] = None,
                            z_chunk: Optional[int] = None):
    """``(A, A_T)`` for a fixed parallel-beam geometry on the spectral
    path; ``A_T`` is the exact transpose, written stage by stage (FFTs and
    matmuls, no scatter): the adjointness contract of
    :func:`..ct.make_projector`.
    Both compute in ``dtype`` on their input's device.

    ``precompute_tables`` (default: when they fit 512 MB): build the NUDFT
    tables once per device and dtype, and attach the ``prepare()/apply(
    consts, x)`` protocol (with ``apply_T``) that the solvers bind once per
    solve; ``False`` rebuilds them per application, ``angle_chunk`` angles
    at a time, and attaches no protocol.

    ``z_chunk``: stream each application in ``z_chunk``-slice pieces (z is
    a pure batch axis: the values are identical), which bounds the peak
    memory of the spectral intermediates (:func:`_chunk_over_z`)."""
    ang = _concrete_angles(angles)
    vol_shape = tuple(int(n) for n in vol_shape)
    N = vol_shape[-1]
    n_det = n_det or N
    real_dt = _real_dtype(dtype)
    K = N + 1
    table_bytes = ang.size * (N * K + K * n_det) * (
        16 if real_dt == torch.float64 else 8)
    if precompute_tables is None:
        precompute_tables = table_bytes <= _SPECTRAL_EAGER_TABLE_BUDGET
    _check_precision(precision)

    def build(device, rdt):
        if ang.ndim == 1:
            return _spectral_tables_shared(ang, N, n_det, rdt, device)
        return [_spectral_tables_shared(ang[m], N, n_det, rdt, device)
                for m in range(ang.shape[0])]

    plan = _Plan(build) if precompute_tables else None

    def apply(consts, x):
        x = on_device(x).to(dtype)
        return radon_spectral(
            x, ang, n_det=n_det, angle_chunk=angle_chunk,
            _tables=consts.get(x.device, real_dt) if consts else None,
            precision=precision)

    def apply_T(consts, y):
        y = on_device(y).to(dtype)
        with _matmul_precision(precision, y.device):
            return _radon_spectral_T(
                y, ang, N, angle_chunk,
                consts.get(y.device, real_dt) if consts else None)

    def A(x):
        return apply(plan, x)

    def A_T(y):
        return apply_T(plan, y)

    if plan is not None:
        _attach_protocol(A, plan, apply, apply_T)
    if z_chunk is not None:
        return _chunk_over_z(A, A_T, vol_shape, z_chunk)
    return A, A_T


def _chunk_over_z(A, A_T, vol_shape, z_chunk: int):
    """Wrap a projector pair so that each application streams the volume
    (or sinogram) in ``z_chunk``-slice pieces along z, a pure batch axis of
    the parallel geometry: the values are identical and only the peak
    memory of the spectral intermediates drops.  The ``prepare()/apply``
    protocol is kept (the tables do not depend on z)."""
    Nz = vol_shape[0]
    if Nz % z_chunk:
        raise ValueError(f"z_chunk={z_chunk} must divide Nz={Nz}")

    def over(fn, arr):
        arr = on_device(arr)
        return torch.cat([fn(arr[z:z + z_chunk])
                          for z in range(0, Nz, z_chunk)], dim=0)

    def A_c(x):
        return over(A, x)

    def A_T_c(y):
        return over(A_T, y)

    if getattr(A, "prepare", None) is not None:
        _attach_protocol(
            A_c, A.prepare(),
            lambda consts, x: over(lambda c: A.apply(consts, c), x),
            lambda consts, y: over(lambda c: A.apply_T(consts, c), y))
    return A_c, A_T_c


# ----------------------------------------------------------------- fan beam
class _FanGrid(NamedTuple):
    """Concrete geometry of the dense parallel grid a fan angle set rebins
    from.  ``thetas`` spans half a turn, [0, pi): line integrals are
    unoriented (``R(theta+pi, s) == R(theta, -s)``), so a full-circle fan or
    cone scan folds onto it exactly.  ``ti``/``si`` are the (A, n_det)
    bilinear resample coordinates into the grid padded with ``pad`` wrap
    columns (column n_theta+k = column k with the s axis reversed; see
    ``_fold_pad``)."""
    thetas: np.ndarray
    ds: float
    n_s: int
    ti: np.ndarray
    si: np.ndarray
    pad: int
    # parity factorization of the s coordinate (si is si0[u] or its s-flip
    # by the theta fold): lets the bilinear resample run as two matmuls
    si0: np.ndarray = None      # (n_det,) parity-0 s coordinate
    parity: np.ndarray = None   # (A, n_det) 0/1 fold parity


_GRID_CACHE: "collections.OrderedDict" = collections.OrderedDict()
_REBIN_CACHE: "collections.OrderedDict" = collections.OrderedDict()
_HOST_CACHE_MAX = 16
# the dense grid and the rebinning matrices are host (numpy) functions of
# the geometry, ~38 MB at production cone scale: memoized per geometry


def _host_memo(cache, key, build):
    hit = cache.get(key)
    if hit is not None:
        cache.move_to_end(key)
        return hit
    val = build()
    if len(cache) >= _HOST_CACHE_MAX:
        cache.popitem(last=False)
    cache[key] = val
    return val


def _fan_dense_grid(ang: np.ndarray, geom, n_det: int, N: int,
                    oversample: float) -> "_FanGrid":
    key = (ang.tobytes(), ang.shape, tuple(geom), n_det, N, oversample)
    return _host_memo(_GRID_CACHE, key, lambda: _fan_dense_grid_uncached(
        ang, geom, n_det, N, oversample))


def _fan_dense_grid_uncached(ang: np.ndarray, geom, n_det: int, N: int,
                             oversample: float) -> "_FanGrid":
    D_so = float(geom.source_dist)
    L = D_so + float(geom.det_dist)
    pitch = float(geom.spacing())
    u = (np.arange(n_det) - (n_det - 1) / 2.0) * pitch
    gamma = np.arctan2(u, L)                      # (n_det,)
    theta_q = ang[:, None] + gamma[None, :]       # (A, n_det)
    s_q = D_so * np.sin(gamma)                    # (n_det,)
    s_q = np.broadcast_to(s_q, theta_q.shape)

    # dense parallel grid: theta at ~the fan's own angular resolution
    # (folded mod pi), s at 1/oversample-pixel pitch over the object
    # support (|s| > 0.75 N projects to zero for in-disk objects).  When
    # the angular step divides pi (every equally spaced full- or
    # half-circle scan), d_theta is an exact divisor of it and the grid is
    # phase-aligned with the source angles: the beta part of every query
    # lands on a grid line, and the central detector column interpolates
    # exactly.
    d_beta = np.pi / ang.shape[0] if ang.shape[0] < 2 else float(
        np.min(np.diff(np.sort(ang))) or np.pi / ang.shape[0])
    d_nom = max(d_beta, 1e-3) / oversample
    m = max(int(np.ceil(d_beta / d_nom)), 1)
    cand = np.pi / (d_beta / m)
    if abs(cand - round(cand)) < 1e-9 and round(cand) >= 4:
        n_half = int(round(cand))
        d_theta = np.pi / n_half
        th_off = float(np.mod(float(ang.ravel()[0]), d_theta))
    else:
        n_half = max(int(np.ceil(np.pi / d_nom)), 4)
        d_theta = np.pi / n_half
        th_off = 0.0
    thetas = th_off + np.arange(n_half) * d_theta
    ds = 1.0 / oversample
    s_max = min(float(np.abs(s_q).max()) + 2.0, 0.75 * N)
    n_s = 2 * int(np.ceil(s_max / ds)) + 1        # odd: s=0 on the grid
    th_f = np.mod(theta_q - th_off, np.pi)
    parity = np.mod(np.floor_divide(theta_q - th_off, np.pi), 2)
    ti = th_f / d_theta                           # in [0, n_half)
    si0 = (np.clip(s_q, -s_max, s_max) + (n_s - 1) / 2.0 * ds) / ds
    si = np.where(parity == 1, (n_s - 1) - si0, si0)
    return _FanGrid(thetas, ds, n_s, ti, si, pad=1,
                    si0=si0[0], parity=parity)


def _fold_pad(dense, pad: int):
    """Append ``pad`` wrap columns to a dense [0, pi) sinogram along the
    theta axis: column ``n_theta + k`` is column ``k`` with the s axis
    reversed (the unoriented-line identity), so bilinear queries that
    straddle theta = pi interpolate exactly across the fold."""
    if not pad:
        return dense
    wrap = torch.flip(dense[..., :pad, :], dims=(-1,))
    return torch.cat([dense, wrap], dim=-2)


def _fold_pad_T(d_bar, pad: int):
    """The transpose of :func:`_fold_pad`."""
    if not pad:
        return d_bar
    n = d_bar.shape[-2] - pad
    return torch.cat([d_bar[..., :pad, :]
                      + torch.flip(d_bar[..., n:, :], dims=(-1,)),
                      d_bar[..., pad:n, :]], dim=-2)


def _rebin_mats(grid: "_FanGrid", np_dt):
    """Host-built weights of the bilinear fan rebinning as two matmuls,
    memoized per (grid, dtype) (grids keep their identity through
    ``_GRID_CACHE``; the cached value pins its grid)."""
    key = (id(grid), np.dtype(np_dt).name)
    hit = _REBIN_CACHE.get(key)
    if hit is not None:
        _REBIN_CACHE.move_to_end(key)
        return hit[1]
    val = _rebin_mats_uncached(grid, np_dt)
    _host_memo(_REBIN_CACHE, key, lambda: (grid, val))
    return val


def _rebin_mats_uncached(grid: "_FanGrid", np_dt):
    """``Ws`` ``(n_s, 2 n_det)`` contracts the dense sinogram's s axis for
    both fold parities at once (the s coordinate takes only two values per
    detector column, ``si0[u]`` or its s-flip), and ``Wt`` ``(A, n_det, T,
    2)`` holds the theta interpolation weights routed to the query's parity
    slot: exactly the 4-term bilinear sum of ``map_coordinates(order=1,
    mode='constant')`` on in-range queries (the grid clips s and keeps
    ti < n_theta)."""
    A, U = grid.ti.shape
    n_s = int(grid.n_s)
    T = len(grid.thetas) + grid.pad
    par = grid.parity.astype(np.int64)
    Ws = np.zeros((n_s, U, 2))
    cols = np.arange(U)
    for p in range(2):
        c = grid.si0 if p == 0 else (n_s - 1) - grid.si0
        k = np.floor(c).astype(np.int64)
        f = c - k
        np.add.at(Ws, (k, cols, np.full(U, p)), 1.0 - f)
        np.add.at(Ws, (np.minimum(k + 1, n_s - 1), cols, np.full(U, p)), f)
    Wt = np.zeros((A, U, T, 2))
    t0 = np.floor(grid.ti).astype(np.int64)
    ft = grid.ti - t0
    aa, uu = np.meshgrid(np.arange(A), cols, indexing="ij")
    np.add.at(Wt, (aa, uu, t0, par), 1.0 - ft)
    np.add.at(Wt, (aa, uu, np.minimum(t0 + 1, T - 1), par), ft)
    return Ws.reshape(n_s, 2 * U).astype(np_dt), Wt.astype(np_dt)


def _rebin_device(grid, real_dt, device):
    """The rebinning weights on a device in the layouts of
    :func:`_rebin_apply`: ``Ws`` ``(n_s, 2U)`` and ``Wt`` ``(U, A, 2T)``."""
    Ws, Wt = _rebin_mats(grid, _np_dtype(real_dt))
    A, U, T = Wt.shape[0], Wt.shape[1], Wt.shape[2]
    Wt_u = np.ascontiguousarray(Wt.transpose(1, 0, 2, 3)).reshape(U, A, 2 * T)
    return (torch.as_tensor(Ws, device=device),
            torch.as_tensor(Wt_u, device=device))


def _rebin_apply(dense, Ws, Wt):
    """Resample a padded dense sinogram ``(..., T, n_s)`` at the fan
    coordinates with the :func:`_rebin_device` weights:
    ``(..., A, n_det)``."""
    lead = tuple(dense.shape[:-2])
    T, n_s = dense.shape[-2], dense.shape[-1]
    U, A = Wt.shape[0], Wt.shape[1]
    d2 = torch.matmul(dense.reshape(-1, T, n_s), Ws)       # (B, T, 2U)
    B = d2.shape[0]
    d2u = d2.view(B, T, U, 2).permute(2, 1, 3, 0).reshape(U, 2 * T, B)
    out = torch.bmm(Wt, d2u)                               # (U, A, B)
    return out.permute(2, 1, 0).reshape(lead + (A, U))


def _rebin_apply_T(y, Ws, Wt):
    """The transpose of :func:`_rebin_apply`: ``(..., A, n_det) ->
    (..., T, n_s)``."""
    lead = tuple(y.shape[:-2])
    U, A = Wt.shape[0], Wt.shape[1]
    T = Wt.shape[2] // 2
    yu = y.reshape(-1, A, U).permute(2, 1, 0)              # (U, A, B)
    B = yu.shape[2]
    d2u = torch.bmm(Wt.transpose(1, 2), yu)                # (U, 2T, B)
    d2 = d2u.view(U, T, 2, B).permute(3, 1, 0, 2).reshape(B, T, 2 * U)
    return torch.matmul(d2, Ws.t()).reshape(lead + (T, Ws.shape[0]))


def _fan_consts(ang: np.ndarray, geom, n_det: int, N: int,
                oversample: float, real_dt, device, precompute: bool):
    """One shared angle set's fan constants on a device: the dense grid,
    its NUDFT tables (``None``: built per application) and the rebinning
    weights."""
    grid = _fan_dense_grid(ang, geom, n_det, N, oversample)
    tables = (_spectral_tables_shared(grid.thetas, N, grid.n_s, real_dt,
                                      device, det_spacing=grid.ds)
              if precompute else None)
    Ws, Wt = _rebin_device(grid, real_dt, device)
    return {"grid": grid, "tables": tables, "Ws": Ws, "Wt": Wt}


def _fan_apply(v, fc, angle_chunk):
    """``v`` ``(..., N, N)`` -> ``(..., A, n_det)``: the dense spectral
    radon, the fold and the rebinning."""
    g = fc["grid"]
    v = v.to(_real_dtype(v.dtype))
    dense = _radon_spectral_shared(v, g.thetas, g.n_s, angle_chunk,
                                   det_spacing=g.ds, tables=fc["tables"])
    return _rebin_apply(_fold_pad(dense, g.pad), fc["Ws"], fc["Wt"])


def _fan_consts_of(ang, geom, n_det, N, oversample, real_dt, device,
                   precompute):
    """:func:`_fan_consts` of a shared angle set, or a list of them, one per
    frame of per-frame angles."""
    if ang.ndim == 1:
        return _fan_consts(ang, geom, n_det, N, oversample, real_dt, device,
                           precompute)
    return [_fan_consts(a, geom, n_det, N, oversample, real_dt, device,
                        precompute) for a in ang]


def _fan_forward(vol, fcs, angle_chunk):
    """:func:`_fan_apply` over a shared angle set or frame by frame."""
    if not isinstance(fcs, list):
        return _fan_apply(vol, fcs, angle_chunk)
    return torch.stack([_fan_apply(vol[:, m:m + 1], fc, angle_chunk)[:, 0]
                        for m, fc in enumerate(fcs)], dim=1)


def _fan_adjoint(y, fcs, N: int, angle_chunk):
    """:func:`_fan_apply_T` over a shared angle set or frame by frame."""
    if not isinstance(fcs, list):
        return _fan_apply_T(y, fcs, N, angle_chunk)
    return torch.stack([_fan_apply_T(y[:, m:m + 1], fc, N, angle_chunk)[:, 0]
                        for m, fc in enumerate(fcs)], dim=1)


def _fan_apply_T(y, fc, N: int, angle_chunk):
    """The transpose of :func:`_fan_apply`."""
    g = fc["grid"]
    y = y.to(_real_dtype(y.dtype))
    d_bar = _fold_pad_T(_rebin_apply_T(y, fc["Ws"], fc["Wt"]), g.pad)
    return _radon_spectral_shared_T(d_bar, g.thetas, N, angle_chunk,
                                    det_spacing=g.ds, tables=fc["tables"])


def radon_fan_spectral(vol, angles, geom, n_det: Optional[int] = None,
                       angle_chunk: Optional[int] = None,
                       oversample: float = 2.0,
                       precision: Optional[str] = None, _tables=None,
                       device=None):
    """Fan-beam forward projection by fan-to-parallel rebinning on the
    spectral projector: a fan ray (source angle ``beta``, flat-detector
    coordinate ``u``) is the parallel ray at ``theta = beta + gamma``,
    ``s = D_so sin(gamma)``, ``gamma = atan(u / (D_so + D_od))``, so a dense
    parallel sinogram over [0, pi) is evaluated spectrally and resampled
    bilinearly at the fan coordinates by two matmuls (Kak & Slaney 1988
    ch. 3.4.2).  Drop-in for :func:`..ct.radon_fan` on the same
    ``FanBeamGeometry`` (``(Nz, M, n_angles, n_det)``; shared or per-frame
    angles); ``oversample`` sets the dense grid's density in theta
    (against the fan's angular step) and s (against unit pitch)."""
    vol = on_device(vol, device)
    if vol.ndim != 4 or vol.shape[-2] != vol.shape[-1]:
        raise ValueError(
            f"radon_fan_spectral expects a square-plane rank-4 volume, got "
            f"{tuple(vol.shape)}")
    N = vol.shape[-1]
    n_det = n_det or N
    ang = _concrete_angles(angles)
    if ang.ndim == 2 and ang.shape[0] != vol.shape[1]:
        raise ValueError(
            f"per-frame angles must be (M={vol.shape[1]}, n_angles), got "
            f"{ang.shape}")
    fcs = _tables or _fan_consts_of(ang, geom, n_det, N, oversample,
                                    _real_dtype(vol.dtype), vol.device,
                                    precompute=False)
    with _matmul_precision(precision, vol.device):
        return _fan_forward(vol, fcs, angle_chunk).to(vol.dtype)


def make_fan_spectral_projector(vol_shape, angles, geom,
                                n_det: Optional[int] = None,
                                dtype=torch.float32,
                                angle_chunk: Optional[int] = None,
                                oversample: float = 2.0,
                                precision: Optional[str] = None):
    """``(A, A_T)`` for a fixed fan-beam geometry on the rebinned spectral
    path; ``A_T`` is the exact transpose (the rebinning's transposed
    matmuls, the fold's transpose, the dense radon's transpose).  Carries
    the ``prepare()/apply`` protocol: the dense grid's tables and the
    rebinning weights, built once per device and dtype."""
    ang = _concrete_angles(angles)
    vol_shape = tuple(int(n) for n in vol_shape)
    N = vol_shape[-1]
    n_det = n_det or N
    real_dt = _real_dtype(dtype)
    _check_precision(precision)

    plan = _Plan(lambda device, rdt: _fan_consts_of(
        ang, geom, n_det, N, oversample, rdt, device, precompute=True))

    def apply(consts, x):
        x = on_device(x).to(dtype)
        return radon_fan_spectral(x, ang, geom, n_det=n_det,
                                  angle_chunk=angle_chunk,
                                  oversample=oversample, precision=precision,
                                  _tables=consts.get(x.device, real_dt))

    def apply_T(consts, y):
        y = on_device(y).to(dtype)
        with _matmul_precision(precision, y.device):
            return _fan_adjoint(y, consts.get(y.device, real_dt), N,
                                angle_chunk).to(dtype)

    def A(x):
        return apply(plan, x)

    def A_T(y):
        return apply_T(plan, y)

    return _attach_protocol(A, plan, apply, apply_T), A_T


# ---------------------------------------------------------------- cone beam
def _fan_of_cone(geom):
    from .ct import FanBeamGeometry

    return FanBeamGeometry(source_dist=float(geom.source_dist),
                           det_dist=float(geom.det_dist),
                           det_spacing=float(geom.spacing_u()))


def _cone_host_consts(geom, ang: np.ndarray, Nz: int, n_det_v: int,
                      n_det_u: int, N: int, oversample: float):
    """All concrete (host, numpy) constants of the spectral cone path for
    one shared angle set: the dense parallel grid, the z interpolation and
    derivative matrices, and the per-cell ray coefficients.  Geometry:
    source at in-plane distance ``D_so`` and height z=0; a cone ray to
    detector cell (v, u) has the in-plane track of the fan ray of column u
    and height ``z(s) = sigma * s`` with ``s`` the in-plane distance from
    the source and ``sigma = v_det*pv / sqrt(L^2 + u_det^2*pu^2)`` (the
    gather cone's normalization)."""
    D_so = float(geom.source_dist)
    L = D_so + float(geom.det_dist)
    pu, pv = float(geom.spacing_u()), float(geom.spacing_v())
    cz = (Nz - 1) / 2.0
    grid = _fan_dense_grid(ang, _fan_of_cone(geom), n_det_u, N, oversample)

    u_det = (np.arange(n_det_u) - (n_det_u - 1) / 2.0) * pu
    v_det = (np.arange(n_det_v) - (n_det_v - 1) / 2.0) * pv
    L_ip = np.sqrt(L ** 2 + u_det ** 2)              # (U,)
    sigma = v_det[:, None] / L_ip[None, :]           # (V, U) dz/ds_ip
    obliq = np.sqrt(1.0 + sigma ** 2)                # ds_3d/ds_ip

    # expansion height: z on the ray at the in-plane isocenter distance
    # (s = D_so); rows expand about their own u=0 height so the hat
    # matmuls stay (V, Nz) and the u-dependence rides the 1st-order term
    z0_vu = cz + sigma * D_so                        # (V, U) exact
    z0_v = z0_vu[:, n_det_u // 2]                    # (V,) central column
    zg = np.arange(Nz, dtype=np.float64)
    Wz = np.maximum(0.0, 1.0 - np.abs(z0_v[:, None] - zg[None]))
    # d/dz0 of the hat interpolation, with virtual zero slices beyond the
    # slab (map_coordinates' cval=0 decay) and a centred stencil where the
    # expansion point sits on a knot
    Wdz = np.zeros_like(Wz)
    for v, z0 in enumerate(z0_v):
        if z0 <= -1.0 or z0 >= Nz:
            continue
        k = int(np.floor(z0))
        if abs(z0 - round(z0)) < 1e-9:      # on a knot: centred difference
            k0 = int(round(z0))
            if 0 <= k0 - 1 < Nz:
                Wdz[v, k0 - 1] -= 0.5
            if 0 <= k0 + 1 < Nz:
                Wdz[v, k0 + 1] += 0.5
        else:                                # in a segment: its slope
            if 0 <= k < Nz:
                Wdz[v, k] -= 1.0
            if 0 <= k + 1 < Nz:
                Wdz[v, k + 1] += 1.0

    # the (beta, u) ray is the parallel line (theta, s_par); its unit
    # direction (away from the source) and the source's coordinate along it
    src_r = -D_so * np.sin(ang)[:, None]             # (A, 1)
    src_c = -D_so * np.cos(ang)[:, None]
    dir_r = (float(geom.det_dist) * np.sin(ang)[:, None]
             + u_det[None, :] * np.cos(ang)[:, None]) - src_r
    dir_c = (float(geom.det_dist) * np.cos(ang)[:, None]
             - u_det[None, :] * np.sin(ang)[:, None]) - src_c
    inv = 1.0 / np.sqrt(dir_r ** 2 + dir_c ** 2)
    dir_r, dir_c = dir_r * inv, dir_c * inv          # (A, U) unit omega
    s_src = src_r * dir_r + src_c * dir_c            # source coord on line
    return {"grid": grid, "Wz": Wz, "Wdz": Wdz, "sigma": sigma,
            "obliq": obliq, "z0_v": z0_v, "D_so": D_so, "dir_r": dir_r,
            "dir_c": dir_c, "s_src": s_src}


def _cone_consts(geom, ang: np.ndarray, Nz: int, n_det_v: int, n_det_u: int,
                 N: int, oversample: float, real_dt, device,
                 precompute: bool, absolute: bool = False):
    """One shared angle set's cone constants on a device, as the one
    operator ``out = obliq (Wz F0 + sig (Wd Mom) + c0 (Wd F0))``, ``Mom =
    dr Fr + dc Fc + ss F0``, ``F* = fan(vol * (1, rw[:, None], rw[None, :]))``.

    Signed (the projector): ``Wd = Wdz``, ``sig = sigma``, ``c0 = -sig0``,
    ``(dr, dc) = dir``, ``ss = -s_src``, ``rw`` the centred coordinate:
    the first-order expansion ``f(cz + sigma s) ~ f(z0_v) + (cz + sigma s -
    z0_v) f'(z0_v)`` with the moment taken about the source.

    ``absolute`` (the abs-factor surrogate of the preconditioner): every
    signed factor by its absolute value, the moment decomposed about the
    isocenter distance ``s = D_so`` (``ss = |s_src + D_so|``, ``c0 =
    |sigma D_so - |sig0||``): the raw moment carries a large cancelling
    ``D_so F0`` pair whose absolute version over-bounds ``|A|`` several
    times.  Where sigma and sig0 differ in sign it under-bounds (kept as the
    JAX package has it; ROADMAP.md queue C)."""
    cc = _cone_host_consts(geom, ang, Nz, n_det_v, n_det_u, N, oversample)
    sig0 = np.broadcast_to(cc["z0_v"][:, None] - (Nz - 1) / 2.0,
                           cc["sigma"].shape)      # sigma_v0 * D_so
    rr = np.arange(N, dtype=np.float64) - (N - 1) / 2.0
    if absolute:
        coef = dict(Wd=np.abs(cc["Wdz"]), sig=np.abs(cc["sigma"]),
                    c0=np.abs(np.abs(cc["sigma"]) * cc["D_so"]
                              - np.abs(sig0)),
                    dr=np.abs(cc["dir_r"]), dc=np.abs(cc["dir_c"]),
                    ss=np.abs(cc["s_src"] + cc["D_so"]), rw=np.abs(rr))
    else:
        coef = dict(Wd=cc["Wdz"], sig=cc["sigma"], c0=-sig0, dr=cc["dir_r"],
                    dc=cc["dir_c"], ss=-cc["s_src"], rw=rr)
    np_dt = _np_dtype(real_dt)
    out = {k: torch.as_tensor(np.ascontiguousarray(a, dtype=np_dt),
                              device=device)
           for k, a in dict(coef, Wz=cc["Wz"], obliq=cc["obliq"]).items()}
    out["fan"] = _fan_consts(ang, _fan_of_cone(geom), n_det_u, N, oversample,
                             real_dt, device, precompute)
    return out


def _z_contract(W, F):
    """``"vz,zmau->mavu"``: ``(V, Nz)`` against ``(Nz, M, A, U)``, in IEEE
    arithmetic whatever ``precision`` says (as the cone's z contractions
    and the FDK rebinning are: the JAX package runs them at
    ``HIGHEST``)."""
    Nz, M, A, U = F.shape
    with _matmul_precision("highest", W.device):
        out = torch.matmul(W, F.reshape(Nz, -1))
    return out.view(W.shape[0], M, A, U).permute(1, 2, 0, 3)


def _z_contract_T(W, y):
    """The transpose of :func:`_z_contract`: ``(M, A, V, U) -> (Nz, M, A,
    U)``."""
    M, A, V, U = y.shape
    with _matmul_precision("highest", W.device):
        out = torch.matmul(W.t(), y.permute(2, 0, 1, 3).reshape(V, -1))
    return out.view(W.shape[1], M, A, U)


def _cone_apply(vol, cc, order: int, angle_chunk):
    """``(Nz, M, N, N) -> (M, A, V, U)`` (:func:`_cone_consts`, or
    :func:`_zdft_consts` at order 2)."""
    M = vol.shape[1]
    vol = vol.to(_real_dtype(vol.dtype))
    if order == 2:
        return _zdft_apply(vol, cc)
    if order >= 1:
        # the moment along the ray, R[<p, w> g], needs two radons of
        # coordinate-weighted volumes beside R[g]: one call at 3x the
        # frame batch shares the tables and the fixed costs
        rw = cc["rw"]
        stacked = torch.cat([vol, vol * rw[:, None], vol * rw[None, :]],
                            dim=1)
        Fall = _fan_apply(stacked, cc["fan"], angle_chunk)   # (Nz, 3M, A, U)
        F0, Fr, Fc = Fall[:, :M], Fall[:, M:2 * M], Fall[:, 2 * M:]
        Mom = cc["dr"] * Fr + cc["dc"] * Fc + cc["ss"] * F0
        out = (_z_contract(cc["Wz"], F0)
               + cc["sig"] * _z_contract(cc["Wd"], Mom)
               + cc["c0"] * _z_contract(cc["Wd"], F0))
    else:
        out = _z_contract(cc["Wz"], _fan_apply(vol, cc["fan"], angle_chunk))
    return out * cc["obliq"]


def _cone_apply_T(y, cc, order: int, N: int, angle_chunk):
    """The transpose of :func:`_cone_apply`: ``(M, A, V, U) -> (Nz, M, N,
    N)``."""
    M = y.shape[0]
    if order == 2:
        return _zdft_apply_T(y.to(_real_dtype(y.dtype)), cc, N)
    yo = y.to(_real_dtype(y.dtype)) * cc["obliq"]
    F0b = _z_contract_T(cc["Wz"], yo)
    if order < 1:
        return _fan_apply_T(F0b, cc["fan"], N, angle_chunk)
    Momb = _z_contract_T(cc["Wd"], cc["sig"] * yo)
    F0b = F0b + _z_contract_T(cc["Wd"], cc["c0"] * yo) + cc["ss"] * Momb
    Fall_b = torch.cat([F0b, cc["dr"] * Momb, cc["dc"] * Momb], dim=1)
    sb = _fan_apply_T(Fall_b, cc["fan"], N, angle_chunk)   # (Nz, 3M, N, N)
    rw = cc["rw"]
    return sb[:, :M] + sb[:, M:2 * M] * rw[:, None] \
        + sb[:, 2 * M:] * rw[None, :]


def _cone_consts_of(geom, ang, Nz, n_det_v, n_det_u, N, oversample, real_dt,
                    device, precompute, absolute=False):
    """:func:`_cone_consts` of a shared angle set, or a list of them, one
    per frame of per-frame angles."""
    sets = [ang] if ang.ndim == 1 else list(ang)
    ccs = [_cone_consts(geom, a, Nz, n_det_v, n_det_u, N, oversample,
                        real_dt, device, precompute, absolute) for a in sets]
    return ccs[0] if ang.ndim == 1 else ccs


def _cone_forward(vol, ccs, order: int, angle_chunk):
    """:func:`_cone_apply` over a shared angle set or frame by frame."""
    if not isinstance(ccs, list):
        return _cone_apply(vol, ccs, order, angle_chunk)
    return torch.stack([_cone_apply(vol[:, m:m + 1], cc, order,
                                    angle_chunk)[0]
                        for m, cc in enumerate(ccs)], dim=0)


def _cone_adjoint(y, ccs, order: int, N: int, angle_chunk):
    """:func:`_cone_apply_T` over a shared angle set or frame by frame."""
    if not isinstance(ccs, list):
        return _cone_apply_T(y, ccs, order, N, angle_chunk)
    return torch.cat([_cone_apply_T(y[m:m + 1], cc, order, N, angle_chunk)
                      for m, cc in enumerate(ccs)], dim=1)


# ------------------------------------------- cone beam: the z-DFT tier (2)
_ZDFT_TABLE_BUDGET = 512 * 1024 * 1024
# bytes of one angle chunk's float64 tables in the order=2 tier: they depend
# on the offset node, so every application builds them, chunk by chunk
_ZDFT_CACHE: "collections.OrderedDict" = collections.OrderedDict()
# the tier's host constants (Lagrange matrices per slab), per geometry
_Z_KERNELS = ("hat", "trig")


def _check_z_kernel(z_kernel):
    if z_kernel not in _Z_KERNELS:
        raise ValueError(
            f"unknown z_kernel {z_kernel!r}; expected 'hat' or 'trig'")


def _natural(F, Np: int, dim: int):
    """An fft-ordered axis in natural order ``k = -Np/2 .. +Np/2`` (Np + 1
    entries): the +Nyquist entry reuses the -Nyquist bin, identical for
    an integer-grid image.  (Its trapezoid half weight and the -Nyquist
    one ride the synthesis table.)"""
    h = Np // 2
    return torch.cat([F.narrow(dim, h, h), F.narrow(dim, 0, h),
                      F.narrow(dim, h, 1)], dim=dim)


def _natural_T(Fn_bar, Np: int, dim: int):
    """The transpose of :func:`_natural`: the duplicated +Nyquist entry
    adds back into its bin."""
    h = Np // 2
    return torch.cat([Fn_bar.narrow(dim, h, h),
                      Fn_bar.narrow(dim, 0, 1) + Fn_bar.narrow(dim, Np, 1),
                      Fn_bar.narrow(dim, 1, h - 1)], dim=dim)


def _modulated_spectrum(img_c, vertical: bool):
    """The full padded spectrum of a complex slab ``(B, N, N)`` (no
    conjugate symmetry, so every bin) along the contraction axis, in
    natural order, planar and k-major as :func:`_spectrum`: ``(Np + 1, 2B,
    N)``."""
    B, N = img_c.shape[0], img_c.shape[-1]
    Np = 2 * N
    if vertical:
        F = _natural(torch.fft.fft(img_c, n=Np, dim=-1), Np, -1)  # (B, r, k)
        Fk = torch.view_as_real(F).permute(2, 3, 0, 1)
    else:
        F = _natural(torch.fft.fft(img_c, n=Np, dim=-2), Np, -2)  # (B, k, c)
        Fk = torch.view_as_real(F).permute(1, 3, 0, 2)
    return Fk.reshape(Np + 1, 2 * B, N)


def _modulated_spectrum_T(Fk_bar, vertical: bool):
    """The transpose of :func:`_modulated_spectrum`: ``(Np + 1, 2B, N) ->
    (B, N, N)`` complex.  The padded DFT's transpose is the unnormalized
    inverse DFT, cut to the slab."""
    K2, N = Fk_bar.shape[0], Fk_bar.shape[-1]
    B, Np = Fk_bar.shape[1] // 2, K2 - 1
    F4 = Fk_bar.view(K2, 2, B, N)
    Z = torch.complex(F4[:, 0], F4[:, 1])                     # (k, B, N)
    if vertical:
        Z = _natural_T(Z.permute(1, 2, 0), Np, -1)
        return torch.fft.ifft(Z, dim=-1, norm="forward")[..., :N]
    Z = _natural_T(Z.permute(1, 0, 2), Np, -2)
    return torch.fft.ifft(Z, dim=-2, norm="forward")[..., :N, :]


def _modulated_tables(ang: np.ndarray, vertical: bool, N: int, n_det: int,
                      det_spacing: float, delta: float, real_dt, device):
    """One angle chunk's tables of the offset line ``xi(lam) = lam
    omega_perp - delta omega``, from float64 phases: one frequency
    component stays on the padded grid (``nu``), ``lam`` is solved per bin.
    ``Pk`` ``(Np + 1, N, 2A)``: the NUDFT ``P = e^{-i xi x}`` as ``[Pr |
    Pi]``, k-major; ``Es`` ``(A, 2(Np + 1), S)``: the synthesis ``E = w
    e^{i (lam s + nu c0)} / (Np |den|)`` as ``[Er; -Ei]``, with the
    trapezoid end weights ``w``."""
    Np = 2 * N
    c0 = (N - 1) / 2.0
    f64 = dict(dtype=torch.float64, device=device)
    nu = (2.0 * np.pi / Np) * (torch.arange(Np + 1, **f64) - Np // 2)
    w = torch.ones(Np + 1, **f64)
    w[0] = w[Np] = 0.5
    s_j = (torch.arange(n_det, **f64) - (n_det - 1) / 2.0) * det_spacing
    x = torch.arange(N, **f64) - c0
    th = torch.as_tensor(ang, **f64)
    sin, cos = torch.sin(th)[:, None], torch.cos(th)[:, None]
    if vertical:
        # the column FFT holds xi_col = nu:  -lam sin - delta cos = nu
        lam = -(nu[None, :] + delta * cos) / sin
        xi = lam * cos - delta * sin                  # the row frequency
        den = torch.abs(sin)
    else:
        # the row FFT holds xi_row = nu:  lam cos - delta sin = nu
        lam = (nu[None, :] + delta * sin) / cos
        xi = -lam * sin - delta * cos                 # the column frequency
        den = torch.abs(cos)
    ph = xi.t()[:, None, :] * x[None, :, None]        # (k, x, A)
    Pk = torch.cat([torch.cos(ph), -torch.sin(ph)], dim=-1)
    del ph
    dph = lam[:, :, None] * s_j[None, None, :] + (nu * c0)[None, :, None]
    scale = w[None, :, None] / (Np * den)[:, :, None]
    Es = torch.cat([torch.cos(dph) * scale, -(torch.sin(dph) * scale)],
                   dim=1)
    return Pk.to(real_dt), Es.to(real_dt)


def _complex_rows(Gr, Gi):
    """``[[Gr, Gi], [Gi, -Gr]]`` over the last two axes: against a planar
    ``[Tr; Ti]`` it gives the real part of a complex product in the first
    rows and the imaginary part in the second (for ``[Tr; -Ti]`` and for
    the transposed products, the signs as the callers say)."""
    return torch.cat([torch.cat([Gr, Gi], dim=-1),
                      torch.cat([Gi, -Gr], dim=-1)], dim=-2)


def _modulated_apply(Fk, tables):
    """Both stages on a planar complex spectrum ``(K, 2B, N)``: ``G = F P``
    (one ``bmm`` over k) and ``G E`` (one over the angles), complex out:
    ``(A, 2B, S)`` as ``[re; im]`` rows."""
    Pk, Es = tables
    A = Es.shape[0]
    B = Fk.shape[1] // 2
    prod = torch.bmm(Fk, Pk)                                   # (K, 2B, 2A)
    Gr = (prod[:, :B, :A] - prod[:, B:, A:]).permute(2, 1, 0)  # (A, B, K)
    Gi = (prod[:, :B, A:] + prod[:, B:, :A]).permute(2, 1, 0)
    # [Gr, Gi] [Er; -Ei] = Re(G E), [Gi, -Gr] [Er; -Ei] = Im(G E)
    return torch.bmm(_complex_rows(Gr, Gi), Es)


def _modulated_apply_T(yb, tables):
    """The transpose of :func:`_modulated_apply`: ``(A, 2B, S) -> (K, 2B,
    N)``."""
    Pk, Es = tables
    K = Pk.shape[0]
    B = yb.shape[1] // 2
    Hb = torch.bmm(yb, Es.transpose(1, 2))                     # (A, 2B, 2K)
    Gr = (Hb[:, :B, :K] - Hb[:, B:, K:]).permute(2, 1, 0)      # (K, B, A)
    Gi = (Hb[:, :B, K:] + Hb[:, B:, :K]).permute(2, 1, 0)
    # Fr' = Gr' Pr^T + Gi' Pi^T, Fi' = Gi' Pr^T - Gr' Pi^T
    return torch.bmm(_complex_rows(Gr, Gi), Pk.transpose(1, 2))


def _zdft_chunk(N: int, n_det: int) -> int:
    """Angles per table chunk: ``_ZDFT_TABLE_BUDGET`` of float64 tables."""
    per_angle = (N + n_det) * (2 * N + 1) * 2 * 8
    return max(1, _ZDFT_TABLE_BUDGET // per_angle)


def _modulated_bucket(Fk, ang_b: np.ndarray, vertical: bool, n_det: int,
                      det_spacing: float, delta: float):
    """The modulated spectral projection of one regime's angles: the slab's
    transform on the offset lines, synthesized at the detector (the Fourier
    transform of ``s -> integral f(s omega_perp + t omega) e^{i delta t}
    dt``).  ``Fk`` is the slab's :func:`_modulated_spectrum`, shared by
    every angle and offset; the offset rides only in the tables.  Returns
    ``(A, 2B, n_det)`` planar complex."""
    N = Fk.shape[-1]
    step = _zdft_chunk(N, n_det)
    parts = [_modulated_apply(Fk, _modulated_tables(
        ang_b[a:a + step], vertical, N, n_det, det_spacing, delta, Fk.dtype,
        Fk.device)) for a in range(0, len(ang_b), step)]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=0)


def _modulated_bucket_T(yb, ang_b: np.ndarray, vertical: bool, N: int,
                        det_spacing: float, delta: float):
    """The transpose of :func:`_modulated_bucket`: ``(A, 2B, S) -> (Np + 1,
    2B, N)``."""
    n_det = yb.shape[-1]
    step = _zdft_chunk(N, n_det)
    out = None
    for a in range(0, len(ang_b), step):
        part = _modulated_apply_T(yb[a:a + step], _modulated_tables(
            ang_b[a:a + step], vertical, N, n_det, det_spacing, delta,
            yb.dtype, yb.device))
        out = part if out is None else out + part
    return out


def _modulated_spectra(img_c, thetas: np.ndarray):
    """:func:`_modulated_spectrum` of a complex slab for each regime that
    ``thetas`` has."""
    return {vert: _modulated_spectrum(img_c, vert)
            for vert, idx in zip((True, False), _regime_split(thetas))
            if idx.size}


def _modulated_dense(spectra, thetas: np.ndarray, n_s: int, ds: float,
                     delta: float):
    """The modulated dense radon over a concrete theta grid, both regimes,
    un-permuted by concatenated runs as :func:`_radon_spectral_shared` is:
    ``(n_theta, 2B, n_s)`` planar complex."""
    pieces = []
    for vert, idx in zip((True, False), _regime_split(thetas)):
        if idx.size:
            part = _modulated_bucket(spectra[vert], thetas[idx], vert, n_s,
                                     ds, delta)
            pieces += [(i0, part[j0:j1]) for j0, j1, i0 in _runs(idx)]
    return torch.cat([p for _, p in sorted(pieces, key=lambda q: q[0])],
                     dim=0)


def _modulated_dense_T(d_bar, thetas: np.ndarray, N: int, ds: float,
                       delta: float):
    """The transpose of :func:`_modulated_dense`, up to the spectra: ``{vert:
    (Np + 1, 2B, N)}``."""
    out = {}
    for vert, idx in zip((True, False), _regime_split(thetas)):
        if idx.size:
            runs = [d_bar[i0:i0 + j1 - j0] for j0, j1, i0 in _runs(idx)]
            yb = runs[0] if len(runs) == 1 else torch.cat(runs, dim=0)
            out[vert] = _modulated_bucket_T(yb, thetas[idx], vert, N, ds,
                                            delta)
    return out


def _lagrange_matrix(nodes: np.ndarray, q: np.ndarray) -> np.ndarray:
    """Lagrange interpolation weights from ``nodes`` (L,) to the query
    points ``q`` (Q,): ``(Q, L)`` with ``f(q) = W @ f(nodes)``, exact for
    polynomials of degree < L."""
    L = len(nodes)
    W = np.ones((len(q), L))
    for l in range(L):
        for j in range(L):
            if j != l:
                W[:, l] *= (q - nodes[j]) / (nodes[l] - nodes[j])
    return W


def _zdft_host_consts(geom, ang: np.ndarray, Nz: int, n_det_v: int,
                      n_det_u: int, N: int, oversample: float,
                      z_kernel: str):
    """Host constants of the z-DFT tier (order=2): the padded z period, the
    slabs' frequencies and kernel weights, and per slab the Chebyshev
    offset nodes with the Lagrange matrices that map node values to every
    ray's exact offset ``nu_k sigma(v, u)`` (one for each fold parity: a
    ray folded by pi runs the other way, at the opposite offset)."""
    _check_z_kernel(z_kernel)
    cc = _cone_host_consts(geom, ang, Nz, n_det_v, n_det_u, N, oversample)
    sigma = cc["sigma"]                                 # (V, U) signed
    t_ext = 0.75 * N + 1.0
    smax = float(np.abs(cc["s_src"]).max())
    sigmax = float(np.abs(sigma).max())
    exc = sigmax * (t_ext + smax)
    # the periodized z model: Nzp > max |z - m| + 1, so that no ray inside
    # the in-plane support reads a periodic replica of the volume
    Nzp = int(np.ceil((Nz - 1) / 2.0 + exc)) + 3
    Nzp = max(Nzp, Nz + 2)
    Nzp += Nzp % 2
    Kz = Nzp // 2
    nus = 2.0 * np.pi * np.arange(Kz + 1) / Nzp
    wsym = np.full(Kz + 1, 2.0)
    wsym[0] = wsym[Kz] = 1.0                            # Nzp is even
    if z_kernel == "hat":
        # the hat's first-replica spectrum: the gather cone's linear z
        # interpolation below the z Nyquist ('trig' keeps the band-limited
        # interpolant)
        kern = np.sinc(nus / (2.0 * np.pi)) ** 2
    else:
        kern = np.ones_like(nus)
    q = sigma.ravel()
    nodes, Wq_pos, Wq_neg = [], [], []
    for nu in nus:
        D = nu * sigmax
        # Chebyshev interpolation of e^{i delta t} on |delta| <= D, |t| <=
        # t_ext: the error ~ (e D t_ext / (2 n))^n decays once n > 1.36 D
        # t_ext
        n = max(1, int(np.ceil(1.45 * D * t_ext)) + 6) if D > 0 else 1
        if n == 1:
            nd = np.zeros(1)
            Wp = Wn = np.ones((q.size, 1))
        else:
            nd = D * np.cos(np.pi * (2 * np.arange(n) + 1) / (2 * n))
            Wp = _lagrange_matrix(nd, nu * q)
            Wn = _lagrange_matrix(nd, -nu * q)
        nodes.append(nd)
        Wq_pos.append(Wp.reshape(n_det_v, n_det_u, n))
        Wq_neg.append(Wn.reshape(n_det_v, n_det_u, n))
    return {"cc": cc, "Nzp": Nzp, "Kz": Kz, "nus": nus, "wsym": wsym,
            "kern": kern, "nodes": nodes, "Wq_pos": Wq_pos,
            "Wq_neg": Wq_neg}


def _zdft_consts(geom, ang: np.ndarray, Nz: int, n_det_v: int, n_det_u: int,
                 N: int, oversample: float, z_kernel: str, real_dt, device):
    """One shared angle set's z-DFT constants on a device, memoized: the
    slab DFT ``[cos; -sin]`` ``(2(Kz+1), Nz)``, the rebinning weights (``Ws``
    ``(n_s, 2U)`` both parities, ``Wt[p]`` ``(U, A, T)`` per parity), and per
    slab the Lagrange matrices ``(U, V, L)`` per parity, the phase ``e^{i
    nu (cz - sigma s_src)}`` as ``(U, V, 1, A)`` real and imaginary parts,
    the weight ``wsym kern / Nzp`` and the offset nodes."""
    key = ("zdft", ang.tobytes(), ang.shape, tuple(geom), Nz, n_det_v,
           n_det_u, N, oversample, z_kernel)
    zc = _host_memo(_ZDFT_CACHE, key, lambda: _zdft_host_consts(
        geom, ang, Nz, n_det_v, n_det_u, N, oversample, z_kernel))

    def build():
        np_dt = _np_dtype(real_dt)

        def dev(a):
            return torch.as_tensor(np.ascontiguousarray(a, dtype=np_dt),
                                   device=device)

        cc = zc["cc"]
        Ws, Wt = _rebin_mats(cc["grid"], np_dt)         # Wt (A, U, T, 2)
        ph = zc["nus"][:, None] * np.arange(Nz)[None, :]
        slabs = []
        for k, nu in enumerate(zc["nus"]):
            p = nu * ((Nz - 1) / 2.0 - cc["sigma"][None] * cc["s_src"][:, None])
            p = p.transpose(2, 1, 0)[:, :, None, :]     # (U, V, 1, A)
            slabs.append(dict(
                phase=(dev(np.cos(p)), dev(np.sin(p))),
                lagrange=[dev(W.transpose(1, 0, 2))
                          for W in (zc["Wq_pos"][k], zc["Wq_neg"][k])],
                coef=float(zc["wsym"][k] * zc["kern"][k] / zc["Nzp"]),
                nodes=[float(d) for d in zc["nodes"][k]]))
        return {"slab": dev(np.concatenate([np.cos(ph), -np.sin(ph)])),
                "Ws": dev(Ws),
                "Wt": [dev(Wt[..., p].transpose(1, 0, 2)) for p in (0, 1)],
                "obliq": dev(cc["obliq"]), "grid": cc["grid"],
                "slabs": slabs}

    return _device_memo(key + (real_dt, torch.device(device)), build)


def _zdft_combine(dense, zd, k: int):
    """Slab ``k``'s dense sinograms at its nodes, fold-padded, ``(L, T, 2M,
    n_s)``, to the offset-interpolated value at every ray: the rebinning
    per fold parity (the call's precision), then the parity's Lagrange
    matrix (IEEE): ``(U, V, 2, M, A)``."""
    L, T, B2 = dense.shape[0], dense.shape[1], dense.shape[2]
    U = zd["Ws"].shape[1] // 2
    d2 = torch.matmul(dense, zd["Ws"]).view(L, T, B2, U, 2)
    val = None
    for p, lagrange in enumerate(zd["slabs"][k]["lagrange"]):
        reb = torch.bmm(zd["Wt"][p], d2[..., p].permute(3, 1, 0, 2)
                        .reshape(U, T, L * B2))                # (U, A, L 2M)
        A = reb.shape[1]
        reb = reb.view(U, A, L, B2).permute(0, 2, 3, 1).reshape(U, L, -1)
        with _matmul_precision("highest", dense.device):
            part = torch.bmm(lagrange, reb)                    # (U, V, 2M A)
        val = part if val is None else val + part
    return val.view(U, -1, 2, B2 // 2, A)


def _zdft_combine_T(val_bar, zd, k: int):
    """The transpose of :func:`_zdft_combine`: ``(U, V, 2, M, A) -> (L, T,
    2M, n_s)``."""
    U, V, _, M, A = val_bar.shape
    B2 = 2 * M
    vb = val_bar.reshape(U, V, B2 * A)
    d2 = []
    for p, lagrange in enumerate(zd["slabs"][k]["lagrange"]):
        with _matmul_precision("highest", vb.device):
            rb = torch.bmm(lagrange.transpose(1, 2), vb)       # (U, L, 2M A)
        L = rb.shape[1]
        rb = rb.view(U, L, B2, A).permute(0, 3, 1, 2).reshape(U, A, L * B2)
        d2.append(torch.bmm(zd["Wt"][p].transpose(1, 2), rb))  # (U, T, L 2M)
    T = d2[0].shape[1]
    d2 = torch.stack(d2, dim=-1).view(U, T, L, B2, 2).permute(2, 1, 3, 0, 4)
    return torch.matmul(d2.reshape(L, T, B2, 2 * U), zd["Ws"].t())


def _zdft_apply(vol, zd):
    """The z-DFT offset-line cone forward of one shared angle set: ``(Nz,
    M, N, N) -> (M, A, V, U)``.  The volume's z-DFT slabs ``(Kz+1, M, N,
    N)`` complex; per slab, its spectra once, then per offset node its
    modulated dense sinogram (the node's tables built, used and freed); the
    fold pad, whose wrap column of node l is node L-1-l's flipped in s
    (``R_delta(theta + pi, s) = R_{-delta}(theta, -s)``, the node sets are
    symmetric); the rebinning and the Lagrange combination per parity; the
    weighted ``Re(phase val)`` summed over slabs; the obliquity."""
    Nz, M, N = vol.shape[0], vol.shape[1], vol.shape[-1]
    g = zd["grid"]
    with _matmul_precision("highest", vol.device):
        sl = torch.matmul(zd["slab"], vol.reshape(Nz, -1)).view(
            2, -1, M, N, N)
    out = None
    for k, s in enumerate(zd["slabs"]):
        spectra = _modulated_spectra(torch.complex(sl[0, k], sl[1, k]),
                                     g.thetas)
        dense = torch.stack([_modulated_dense(spectra, g.thetas, g.n_s, g.ds,
                                              d) for d in s["nodes"]])
        del spectra
        if g.pad:
            wrap = torch.flip(torch.flip(dense, dims=(0,))[:, :g.pad],
                              dims=(-1,))
            dense = torch.cat([dense, wrap], dim=1)
        val = _zdft_combine(dense, zd, k)
        del dense
        phr, phi = s["phase"]
        term = (phr * val[:, :, 0] - phi * val[:, :, 1]) * s["coef"]
        out = term if out is None else out + term             # (U, V, M, A)
    return out.permute(2, 3, 1, 0) * zd["obliq"]


def _zdft_apply_T(y, zd, N: int):
    """The transpose of :func:`_zdft_apply`: ``(M, A, V, U) -> (Nz, M, N,
    N)``, stage by stage; the spectra's cotangents summed over a slab's
    nodes before one inverse DFT per regime."""
    M = y.shape[0]
    g = zd["grid"]
    T = len(g.thetas)
    yo = (y * zd["obliq"]).permute(3, 2, 0, 1)                 # (U, V, M, A)
    slab_bar = []
    for k, s in enumerate(zd["slabs"]):
        yk = yo * s["coef"]
        phr, phi = s["phase"]
        d_bar = _zdft_combine_T(torch.stack([phr * yk, -(phi * yk)], dim=2),
                                zd, k)
        if g.pad:
            d_bar = torch.cat([d_bar[:, :g.pad]
                               + torch.flip(d_bar[:, T:], dims=(0, -1)),
                               d_bar[:, g.pad:T]], dim=1)
        Fk_bar = {}
        for l, d in enumerate(s["nodes"]):
            for vert, part in _modulated_dense_T(d_bar[l], g.thetas, N, g.ds,
                                                 d).items():
                Fk_bar[vert] = part if vert not in Fk_bar \
                    else Fk_bar[vert] + part
        del d_bar
        slab_bar.append(sum(_modulated_spectrum_T(F, vert)
                            for vert, F in Fk_bar.items()))
    zb = torch.stack(slab_bar)                                 # (Kz+1, M, N, N)
    planar = torch.cat([zb.real, zb.imag]).reshape(zd["slab"].shape[0], -1)
    with _matmul_precision("highest", y.device):
        return torch.matmul(zd["slab"].t(), planar).view(-1, M, N, N)


def _zdft_consts_of(geom, ang, Nz, n_det_v, n_det_u, N, oversample,
                    z_kernel, real_dt, device):
    """:func:`_zdft_consts` of a shared angle set, or a list of them, one
    per frame of per-frame angles."""
    sets = [ang] if ang.ndim == 1 else list(ang)
    zds = [_zdft_consts(geom, a, Nz, n_det_v, n_det_u, N, oversample,
                        z_kernel, real_dt, device) for a in sets]
    return zds[0] if ang.ndim == 1 else zds


def _check_order(order):
    if order not in (0, 1, 2):
        raise ValueError(f"order must be 0, 1 or 2, got {order!r}")


def radon_cone_spectral(vol, angles, geom, n_det_v: Optional[int] = None,
                        n_det_u: Optional[int] = None,
                        angle_chunk: Optional[int] = None,
                        oversample: float = 2.0, order: int = 1,
                        precision: Optional[str] = None, _tables=None,
                        device=None, z_kernel: str = "hat"):
    """Gather-free cone-beam forward projection: single-slice rebinning
    (SSRB: detector row ``v`` reads the volume slice at its
    isocenter-plane height, a ``(n_det_v, Nz)`` interpolation matmul, then
    the rebinned spectral fan path of :func:`radon_fan_spectral`) plus, at
    ``order=1`` (default), the first-order term of the expansion in the
    ray's z-slope: the in-plane first-moment fan transform, two more
    spectral radons of coordinate-weighted volumes, times the
    z-derivative stencil.  The per-cell obliquity weight ``ds_3d /
    ds_inplane`` matches :func:`..ct.radon_cone`'s 3D arc length.  Same
    layouts as ``radon_cone``: volume ``(Nz, M, N, N)``, angles shared or
    per-frame, sinogram ``(M, n_angles, n_det_v, n_det_u)``.

    ``order=0`` is classic SSRB, O(sigma); ``order=1`` cancels the linear
    term, leaving O(sigma^2 f'').  Exact in the parallel limit.  The
    operator is linear with an exact transpose at each order.

    ``order=2`` is the z-DFT offset-line tier, the accuracy-certification
    rung: the padded volume's z-DFT slabs, each slab's spectrum evaluated
    on lines offset along the ray by the per-ray frequency ``nu_k sigma(v,
    u)`` (the modulated line integral is the Fourier-slice value at the
    offset line, :func:`_modulated_bucket`), Lagrange-interpolated over
    per-slab Chebyshev offset nodes.  No expansion in the slope, and
    sigma's u-dependence is exact; what remains against the gather cone is
    the z kernel: ``z_kernel='hat'`` (default) weights slab k by the hat
    spectrum ``sinc^2(nu_k / 2)`` (the gather cone's linear z
    interpolation below the z Nyquist), ``'trig'`` keeps the band-limited
    interpolant.  It costs ``sum_k L_k`` complex dense radons (``L_k``
    nodes, growing with the ray's z-wander ``nu_k sigma_max N``), each
    building its own tables; ``angle_chunk`` and ``_tables`` apply to
    orders 0 and 1 only."""
    vol = on_device(vol, device)
    if vol.ndim != 4 or vol.shape[-2] != vol.shape[-1]:
        raise ValueError(
            f"radon_cone_spectral expects a square-plane rank-4 "
            f"(Nz, M, N, N) volume, got {tuple(vol.shape)}")
    Nz, M, N = vol.shape[0], vol.shape[1], vol.shape[-1]
    n_det_v = n_det_v or Nz
    n_det_u = n_det_u or N
    ang = _concrete_angles(angles)
    _check_order(order)
    if ang.ndim == 2 and ang.shape[0] != M:
        raise ValueError(
            f"per-frame angles must be (M={M}, n_angles), got {ang.shape}")
    if order == 2:
        ccs = _zdft_consts_of(geom, ang, Nz, n_det_v, n_det_u, N, oversample,
                              z_kernel, _real_dtype(vol.dtype), vol.device)
    else:
        ccs = _tables or _cone_consts_of(geom, ang, Nz, n_det_v, n_det_u, N,
                                         oversample, _real_dtype(vol.dtype),
                                         vol.device, precompute=False)
    with _matmul_precision(precision, vol.device):
        return _cone_forward(vol, ccs, order, angle_chunk).to(vol.dtype)


def make_cone_spectral_projector(vol_shape, angles, geom,
                                 n_det_v: Optional[int] = None,
                                 n_det_u: Optional[int] = None,
                                 dtype=torch.float32,
                                 angle_chunk: Optional[int] = None,
                                 oversample: float = 2.0, order: int = 1,
                                 precision: Optional[str] = None,
                                 z_kernel: str = "hat"):
    """``(A, A_T)`` for a fixed cone-beam geometry on the SSRB spectral
    path (:func:`radon_cone_spectral`); ``A_T`` is the exact transpose of
    the (approximate but linear) map, so the CP and SART solvers see a
    consistent pair.  Same ``prepare()/apply`` protocol as the parallel
    and fan projectors at orders 0 and 1; the z-DFT tier (``order=2``)
    builds its tables per node and application and attaches none."""
    ang = _concrete_angles(angles)
    vol_shape = tuple(int(n) for n in vol_shape)
    Nz, N = vol_shape[0], vol_shape[-1]
    n_det_v = n_det_v or Nz
    n_det_u = n_det_u or N
    real_dt = _real_dtype(dtype)
    _check_order(order)
    _check_precision(precision)
    if order == 2:
        _check_z_kernel(z_kernel)

        def A(x):
            return radon_cone_spectral(
                on_device(x).to(dtype), ang, geom, n_det_v=n_det_v,
                n_det_u=n_det_u, oversample=oversample, order=2,
                precision=precision, z_kernel=z_kernel)

        def A_T(y):
            y = on_device(y).to(dtype)
            zds = _zdft_consts_of(geom, ang, Nz, n_det_v, n_det_u, N,
                                  oversample, z_kernel, real_dt, y.device)
            with _matmul_precision(precision, y.device):
                return _cone_adjoint(y, zds, 2, N, None).to(dtype)

        return A, A_T

    plan = _Plan(lambda device, rdt: _cone_consts_of(
        geom, ang, Nz, n_det_v, n_det_u, N, oversample, rdt, device,
        precompute=True))

    def apply(consts, x):
        x = on_device(x).to(dtype)
        return radon_cone_spectral(x, ang, geom, n_det_v=n_det_v,
                                   n_det_u=n_det_u, angle_chunk=angle_chunk,
                                   oversample=oversample, order=order,
                                   precision=precision,
                                   _tables=consts.get(x.device, real_dt))

    def apply_T(consts, y):
        y = on_device(y).to(dtype)
        with _matmul_precision(precision, y.device):
            return _cone_adjoint(y, consts.get(y.device, real_dt), order, N,
                                 angle_chunk).to(dtype)

    def A(x):
        return apply(plan, x)

    def A_T(y):
        return apply_T(plan, y)

    return _attach_protocol(A, plan, apply, apply_T), A_T


def cone_spectral_precond_sums(vol_shape, angles, geom,
                               n_det_v: Optional[int] = None,
                               n_det_u: Optional[int] = None,
                               dtype=torch.float32,
                               oversample: float = 2.0, order: int = 1,
                               precision: Optional[str] = None,
                               device=None, floor: bool = True):
    """Pock-Chambolle diagonal inputs for the spectral cone: ``(row_sum
    (M, A, V, U), col_sum (Nz, M, N, N))`` of the abs-factor surrogate
    operator (:func:`_cone_consts` with ``absolute=True``): every signed
    geometry factor by its absolute value, so the sums bound the
    factor-path mass of ``|A|`` (the signed sums underestimate it, and the
    preconditioned solve was measured to diverge on them in the JAX
    package).  The column sums are the surrogate's exact transpose at
    ones; both are floored at 1e-6 of their largest.  The spectral splat's
    ringing tails are not bounded: callers check the preconditioned step
    condition with a power method (``models.ct`` does).  ``order=2``
    gives the order-1 surrogate's sums.  On the CUDA device unless
    ``device`` names another.  ``floor=False`` returns the sums unfloored,
    for a caller that floors them at the scale of a whole grid of shards
    (``models.ct``)."""
    ang = _concrete_angles(angles)
    vol_shape = tuple(int(n) for n in vol_shape)
    Nz, N = vol_shape[0], vol_shape[-1]
    n_det_v = n_det_v or Nz
    n_det_u = n_det_u or N
    _check_order(order)
    # the surrogate is the expansion's: order 2 takes the order-1 sums, as
    # the JAX package's (its surrogate tests order >= 1; ROADMAP.md queue C)
    order = min(order, 1)
    device = on_device(np.zeros(0), device).device
    ccs = _cone_consts_of(geom, ang, Nz, n_det_v, n_det_u, N, oversample,
                          _real_dtype(dtype), device, precompute=False,
                          absolute=True)
    with _matmul_precision(precision, device):
        row = _cone_forward(torch.ones(vol_shape, dtype=dtype, device=device),
                            ccs, order, None)
        col = _cone_adjoint(torch.ones_like(row), ccs, order, N, None)
    row, col = row.to(dtype), col.to(dtype)
    if not floor:
        return row, col
    # the surrogate's ringing can dip epsilon-negative; the preconditioner
    # needs strictly positive diagonals
    eps = 1e-6
    return (torch.maximum(row, eps * torch.max(row)),
            torch.maximum(col, eps * torch.max(col)))


# ---------------------------------------------------------------------- FDK
def _fdk_rebin_consts(ang: np.ndarray, geom, Nz: int, n_det_v: int,
                      n_det_u: int, N: int):
    """Host constants of the rebinning FDK (``fdk(method='spectral')``):
    the cone-to-parallel data rebinning as dense matmuls (P-FDK, the
    rebinning variant of Feldkamp):

    1. the de-obliquity weight ``wob = sqrt(L^2+u^2)/sqrt(L^2+u^2+v^2)``
       turns each 3D arc-length datum into its in-plane fan line integral;
    2. detector row v holds (SSRB) the fan sinogram of the slice at its
       isocenter height;
    3. each parallel line (theta_i, s_j) is the measured fan ray at
       ``gamma = asin(s_j/D_so)``, ``beta = theta_i - gamma``,
       ``u = L tan(gamma)``, or its conjugate ``beta + pi + 2 gamma`` with u
       mirrored, used where the primary beta has no angular coverage;
    4. slices read interpolated detector rows (``Wv``).

    Returns ``(wob (V,U), Wv (Nz,V), thetas (T,), Wu[c] (U,S),
    Wb[c] (T,S,A))`` with conjugate class c in {0,1}; queries without
    angular coverage get zero weights."""
    D_so = float(geom.source_dist)
    L = D_so + float(geom.det_dist)
    pu, pv = float(geom.spacing_u()), float(geom.spacing_v())
    A = ang.shape[0]
    V, U, S = n_det_v, n_det_u, n_det_u

    u_det = (np.arange(U) - (U - 1) / 2.0) * pu
    v_det = (np.arange(V) - (V - 1) / 2.0) * pv
    L_ip = np.sqrt(L ** 2 + u_det[None, :] ** 2)
    wob = L_ip / np.sqrt(L ** 2 + u_det[None, :] ** 2
                         + v_det[:, None] ** 2)        # (V, U) ds_ip/ds_3d

    # rows -> slices: slice z reads the row at its isocenter height
    cz = (Nz - 1) / 2.0
    v_of_z = (np.arange(Nz) - cz) * (L / D_so) / pv + (V - 1) / 2.0
    Wv = np.maximum(0.0, 1.0 - np.abs(v_of_z[:, None]
                                      - np.arange(V)[None, :]))  # (Nz, V)

    # parallel target grid: unit-pitch s, T = A thetas over [0, pi)
    T = A
    thetas = np.arange(T) * (np.pi / T)
    s_j = np.arange(S) - (S - 1) / 2.0
    sin_g = np.clip(s_j / D_so, -0.999, 0.999)
    gamma = np.arcsin(sin_g)                            # (S,)
    u_q = L * np.tan(gamma)                             # (S,) flat-panel u

    def u_mat(sign):
        ui = np.clip(sign * u_q / pu + (U - 1) / 2.0, 0.0, U - 1.0)
        k = np.minimum(np.floor(ui).astype(np.int64), U - 2)
        f = ui - k
        W = np.zeros((U, S))
        np.add.at(W, (k, np.arange(S)), 1.0 - f)
        np.add.at(W, (k + 1, np.arange(S)), f)
        # queries whose |u| exceeds the panel get nothing (no extrapolation)
        W[:, np.abs(sign * u_q) > (U - 1) / 2.0 * pu + pu / 2] = 0.0
        return W

    Wu = [u_mat(+1.0), u_mat(-1.0)]

    # beta interpolation: periodic bilinear on the sorted source angles; a
    # query counts as covered only in a gap <= 2.5x the median
    order = np.argsort(np.mod(ang, 2 * np.pi))
    bs = np.mod(ang, 2 * np.pi)[order]                  # sorted (A,)
    gaps = np.diff(np.concatenate([bs, bs[:1] + 2 * np.pi]))
    max_gap = 2.5 * max(np.median(gaps), 1e-12)

    def beta_weights(bq):                               # (T, S) queries
        Wb = np.zeros((T, S, A))
        b = np.mod(bq, 2 * np.pi)
        k = np.searchsorted(bs, b, side="right") - 1    # in [-1, A-1]
        k = np.mod(k, A)
        k1 = np.mod(k + 1, A)
        b0 = bs[k]
        gap = np.mod(bs[k1] - b0, 2 * np.pi)
        gap = np.where(gap <= 1e-12, 2 * np.pi, gap)
        f = np.mod(b - b0, 2 * np.pi) / gap
        ok = (np.mod(b - b0, 2 * np.pi) <= gaps[k]) & (gaps[k] <= max_gap)
        ii, jj = np.nonzero(ok)
        np.add.at(Wb, (ii, jj, order[k[ok]]), 1.0 - f[ok])
        np.add.at(Wb, (ii, jj, order[k1[ok]]), f[ok])
        return Wb, ok

    bq0 = thetas[:, None] - gamma[None, :]              # primary ray
    bq1 = thetas[:, None] + np.pi + gamma[None, :]      # conjugate, u -> -u
    Wb0, ok0 = beta_weights(bq0)
    Wb1, ok1 = beta_weights(bq1)
    # where both rays are measured, average them
    both = ok0 & ok1
    Wb0[both] *= 0.5
    Wb1[both] *= 0.5
    return wob, Wv, thetas, Wu, [Wb0, Wb1]


def _fdk_device_consts(ang: np.ndarray, geom, Nz: int, V: int, U: int,
                       N: int, real_dt, device):
    """:func:`_fdk_rebin_consts` on a device, memoized per geometry:
    ``wob``, ``Wv``, ``thetas`` (host), ``Wu`` and ``Wb`` laid out for the
    matmuls (``Wb[c]`` as ``(S, T, A)``)."""
    key = ("fdk-rebin", ang.tobytes(), ang.shape, tuple(geom), Nz, V, U, N)
    wob, Wv, thetas, Wu, Wb = _host_memo(
        _GRID_CACHE, key, lambda: _fdk_rebin_consts(ang, geom, Nz, V, U, N))

    def build():
        np_dt = _np_dtype(real_dt)

        def dev(a):
            return torch.as_tensor(np.ascontiguousarray(a, dtype=np_dt),
                                   device=device)

        return (dev(wob), dev(Wv), thetas, [dev(w) for w in Wu],
                [dev(w.transpose(1, 0, 2)) for w in Wb])

    return _device_memo(key + (real_dt, torch.device(device)), build)


def fdk_spectral(sino, angles, geom, vol_shape, filter_name: str = "ramp",
                 device=None):
    """Gather-free Feldkamp reconstruction by rebinning (P-FDK): weight
    the cone data back to in-plane fan integrals, rebin to a parallel
    ``(Nz, M, T, S)`` sinogram with the host-built matmuls of
    :func:`_fdk_rebin_consts`, and run the spectral parallel FBP
    (:func:`..ct.fbp`) per slice.  Same layouts as the gather
    :func:`..ct.fdk` (sinogram ``(M, A, V, U)`` -> volume ``(Nz, M, N,
    N)``); angles shared or per-frame.  Its agreement with the gather FDK is
    bounded by the shared SSRB z model plus the rebinning interpolation;
    both converge to per-slice parallel FBP as ``source_dist -> inf``.  A
    numpy sinogram goes to the CUDA device unless ``device`` names
    another."""
    from .ct import fbp

    sino = on_device(sino, device)
    dt = sino.dtype
    real_dt = _real_dtype(dt)
    M, A, V, U = sino.shape
    Nz, N = vol_shape[0], vol_shape[-1]
    ang = _concrete_angles(angles)
    if ang.ndim == 2:
        if ang.shape[0] != M:
            raise ValueError(
                f"per-frame angles must be (M={M}, n_angles), got "
                f"{ang.shape}")
        return torch.stack([
            fdk_spectral(sino[m:m + 1], ang[m], geom, vol_shape,
                         filter_name=filter_name)[:, 0]
            for m in range(M)], dim=1).to(dt)

    wob, Wv, thetas, Wu, Wb = _fdk_device_consts(ang, geom, Nz, V, U, N,
                                                 real_dt, sino.device)
    d = sino.to(real_dt) * wob
    with _matmul_precision("highest", d.device):
        # rows -> slices first (V is small): (M, A, V, U) -> (Nz, M, A, U)
        dz = torch.matmul(Wv, d.permute(2, 0, 1, 3).reshape(V, -1)) \
            .view(Nz, M, A, U)
        par = None
        for c in range(2):
            du = torch.matmul(dz, Wu[c])                  # (Nz, M, A, S)
            S = du.shape[-1]
            # "tsa,zmas->zmts": batched over s
            p = torch.bmm(Wb[c], du.permute(3, 2, 0, 1).reshape(S, A, -1))
            p = p.view(S, -1, Nz, M).permute(2, 3, 1, 0)  # (Nz, M, T, S)
            par = p if par is None else par + p
    return fbp(par, thetas, n_out=N, filter_name=filter_name,
               method="spectral").to(dt)
