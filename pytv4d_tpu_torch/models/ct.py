"""Tomographic reconstruction: parallel-beam projector + TV-regularized
primal-dual reconstruction.  The port of the parallel-beam part of
``pytv4d_tpu/models/ct.py``.

The reference library exists to regularize iterative CT reconstruction
(Boigne et al. IEEE TCI 2022, doi 10.1109/TCI.2022.3215096) but ships no
projector.  This module completes the workflow:

- :func:`radon` / :func:`make_projector`: parallel-beam forward projector
  over the canonical ``(Nz, M, N, N)`` volume (bilinear sampling, linear in
  the image) with its **exact adjoint**, the transposed bilinear scatter over
  the same sample points; the pair passes the dot-product test to round-off,
  so primal-dual solvers converge as theory says.
- per-frame angle sets: dynamic CT interleaves projection angles across time
  frames (the paper's setting); ``angles`` may be ``(n_angles,)`` shared or
  ``(M, n_angles)`` per-frame.
- :func:`cp_reconstruct`: Chambolle-Pock for
  ``min_x F(A x) + reg * TV(x)`` (``solvers.inverse.cp_inverse`` on the
  projector), step sizes from a power-method estimate of ``||A||``.
- :func:`tgv_reconstruct`: the same with the second-order TGV regularizer
  (``solvers.tgv.tgv_inverse``).
- :func:`fbp`: filtered backprojection, directly or as ``x_init``.

The projector is plain torch ops (``grid_sample`` and its transpose), as it
is XLA ops in the JAX package; the TV half of a reconstruction's iteration
runs on the fused kernels (``kernels.fused``).  Fan and cone beams and the
spectral (Fourier-slice) projector are not ported yet (ROADMAP.md queue A,
items 14 and 15): asking for them raises ``NotImplementedError``.

Where a call computes (``utils.device``): a tensor on its own device; a
numpy sinogram or volume on the CUDA device (``RuntimeError`` where there
is none) unless ``device=`` names another.
"""

from __future__ import annotations

import collections
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..core.config import TVConfig
from ..solvers.inverse import cp_inverse, power_iteration
from ..utils.device import on_device

_RADON_GATHER_BUDGET = 512 * 1024 * 1024  # bytes of in-flight samples


def _as_angles(angles, like):
    """The angles as a tensor of ``like``'s dtype on its device."""
    if isinstance(angles, torch.Tensor):
        return angles.to(device=like.device, dtype=like.dtype)
    return torch.as_tensor(np.asarray(angles), device=like.device).to(
        like.dtype)


def _sample_grid(thetas, N: int, n_det: int):
    """``grid_sample`` coordinates of every sample of every ray.

    ``thetas``: ``(G, B)`` angles.  Detector coordinate s runs across the
    beam, integration coordinate t along it, both centred and in pixels;
    the sample of ray (angle, s) at t sits at image position
    ``rows = c + s cos + t sin``, ``cols = c - s sin + t cos``.  Returns
    ``(G, B * n_det, N, 2)`` in ``grid_sample``'s (x = column, y = row)
    order, normalised for ``align_corners=True``."""
    dtype, device = thetas.dtype, thetas.device
    c = (N - 1) / 2.0
    s = torch.arange(n_det, dtype=dtype, device=device) - (n_det - 1) / 2.0
    t = torch.arange(N, dtype=dtype, device=device) - (N - 1) / 2.0
    cos = torch.cos(thetas)[..., None, None]
    sin = torch.sin(thetas)[..., None, None]
    S, T = s[:, None], t[None, :]
    rows = c + S * cos + T * sin          # (G, B, n_det, N)
    cols = c - S * sin + T * cos
    grid = torch.stack((cols, rows), dim=-1) * (2.0 / max(N - 1, 1)) - 1.0
    return grid.reshape(thetas.shape[0], -1, N, 2)


# bilinear (0), zero outside (0), pixel centres at integers: a sample within
# one pixel outside the image still gets the weight of its one inside corner,
# as scipy's map_coordinates(order=1, mode='constant', cval=0) gives it.
# radon and its adjoint both call the sampler with exactly these arguments.
_SAMPLER = dict(interpolation_mode=0, padding_mode=0, align_corners=True)


def _as_slices(vol, per_frame: bool):
    """The volume as ``grid_sample``'s (batch, channels, N, N): slices that
    share their angles are channels of one batch entry."""
    Nz, M, N = vol.shape[0], vol.shape[1], vol.shape[-1]
    if per_frame:
        return vol.transpose(0, 1)             # (M, Nz, N, N)
    return vol.reshape(1, Nz * M, N, N)


def _angle_chunks(angles, n_det, vol_shape, itemsize, angle_batch):
    """``(start, stop)`` angle ranges whose samples stay within the
    in-flight budget (or hold ``angle_batch`` angles)."""
    Nz, M, N = vol_shape[0], vol_shape[1], vol_shape[-1]
    A = angles.shape[-1]
    if angle_batch is None:
        per_angle = Nz * M * n_det * N * itemsize
        angle_batch = max(1, _RADON_GATHER_BUDGET // max(per_angle, 1))
    B = max(1, min(int(angle_batch), A))
    return [(a, min(a + B, A)) for a in range(0, A, B)]


def _check_geometry(vol_shape, angles):
    if len(vol_shape) != 4 or vol_shape[-1] != vol_shape[-2] \
            or vol_shape[-1] < 2:
        raise ValueError(
            f"expected a (Nz, M, N, N) volume with N >= 2, got shape "
            f"{tuple(vol_shape)}")
    if angles.ndim not in (1, 2) or (
            angles.ndim == 2 and angles.shape[0] != vol_shape[1]):
        raise ValueError(
            f"angles must be (n_angles,) or (M={vol_shape[1]}, n_angles), "
            f"got shape {tuple(angles.shape)}")


def radon(vol, angles, n_det: Optional[int] = None,
          angle_batch: Optional[int] = None, device=None):
    """Forward-project a ``(Nz, M, N, N)`` volume.

    angles: ``(n_angles,)`` shared across frames, or ``(M, n_angles)`` with a
    distinct angle set per time frame (dynamic CT).  Returns a sinogram
    ``(Nz, M, n_angles, n_det)``.

    ``angle_batch`` bounds how many angles one sweep covers: the bilinear
    samples are ``Nz*M*B*n_det*N`` elements before the line-integral
    reduction, far more than the volume at production sizes.  Default:
    chosen so the in-flight samples stay ~512 MB; batches run one after
    another.  Pass a value to override (``angle_batch >= n_angles`` forces
    one sweep)."""
    vol = on_device(vol, device)
    angles = _as_angles(angles, vol)
    _check_geometry(vol.shape, angles)
    Nz, M, N = vol.shape[0], vol.shape[1], vol.shape[-1]
    n_det = n_det or N
    per_frame = angles.ndim == 2
    slices = _as_slices(vol, per_frame)
    thetas = angles if per_frame else angles[None]
    out = []
    for a, b in _angle_chunks(angles, n_det, vol.shape, vol.element_size(),
                              angle_batch):
        grid = _sample_grid(thetas[:, a:b], N, n_det)
        samples = torch.ops.aten.grid_sampler_2d(slices, grid, **_SAMPLER)
        out.append(samples.sum(dim=-1).reshape(
            slices.shape[0], slices.shape[1], b - a, n_det))
    sino = torch.cat(out, dim=2)
    if per_frame:
        return sino.transpose(0, 1)
    return sino.reshape(Nz, M, -1, n_det)


def _radon_adjoint(sino, angles, vol_shape, angle_batch: Optional[int] = None):
    """The exact transpose of :func:`radon` at ``vol_shape``: every sinogram
    value is scattered along its ray with the bilinear weights the forward
    projection sampled with (the sampler's own transpose, computed from the
    same coordinates, without running the forward projection).  On a CUDA
    device the scatter uses atomic adds, so two runs may differ in the last
    bits."""
    vol_shape = tuple(vol_shape)
    angles = _as_angles(angles, sino)
    _check_geometry(vol_shape, angles)
    Nz, M, N = vol_shape[0], vol_shape[1], vol_shape[-1]
    n_det = sino.shape[-1]
    per_frame = angles.ndim == 2
    y = sino.transpose(0, 1) if per_frame else sino.reshape(
        1, Nz * M, -1, n_det)
    thetas = angles if per_frame else angles[None]
    acc = torch.zeros(y.shape[:2] + (N, N), dtype=sino.dtype,
                      device=sino.device)
    for a, b in _angle_chunks(angles, n_det, vol_shape, sino.element_size(),
                              angle_batch):
        grid = _sample_grid(thetas[:, a:b], N, n_det)
        g = y[:, :, a:b].reshape(y.shape[0], y.shape[1], -1, 1).expand(
            -1, -1, -1, N)
        # the sampler's transpose takes its input for the shape (and for
        # the grid's gradient, which is not asked for)
        part, _ = torch.ops.aten.grid_sampler_2d_backward(
            g, acc, grid, output_mask=(True, False), **_SAMPLER)
        acc += part
    if per_frame:
        return acc.transpose(0, 1).contiguous()
    return acc.reshape(vol_shape)


_PROJECTOR_METHODS = ("auto", "gather", "spectral")


def _resolve_method(method: str) -> str:
    """'auto' = 'gather' on every device for now: the spectral projector is
    not ported yet, and the gather projector has no trouble on a GPU."""
    if method not in _PROJECTOR_METHODS:
        raise ValueError(
            f"unknown projector method {method!r}; expected one of "
            f"{_PROJECTOR_METHODS}"
        )
    if method == "spectral":
        raise NotImplementedError(
            "the spectral (Fourier-slice) projector is not ported yet "
            "(ROADMAP.md queue A, item 15: models/ct_spectral.py); use "
            "method='gather'")
    return "gather"


def _require_parallel(geom):
    if geom is not None:
        raise NotImplementedError(
            f"only the parallel beam (geom=None) is ported; fan and cone "
            f"geometries are ROADMAP.md queue A, item 14 (got "
            f"{type(geom).__name__})")


_PROJECTOR_CACHE: "collections.OrderedDict" = collections.OrderedDict()
_PROJECTOR_CACHE_MAX = 24


def clear_projector_cache() -> None:
    """Drop all memoized ``(A, A_T)`` projector pairs."""
    _PROJECTOR_CACHE.clear()


def make_projector(vol_shape, angles, n_det: Optional[int] = None,
                   dtype=torch.float32, angle_batch: Optional[int] = None,
                   method: str = "auto"):
    """Build ``(A, A_T)`` for a fixed geometry.  ``A_T`` is the exact
    transpose of the linear map ``A`` (:func:`_radon_adjoint`), so
    ``<y, A x> == <A_T y, x>`` holds to round-off: the same adjointness
    contract the TV operators satisfy.  ``angle_batch`` as in
    :func:`radon`.  Both compute in ``dtype`` on their input's device.

    ``method``: ``'gather'`` = bilinear-sampling :func:`radon`;
    ``'spectral'`` (the Fourier-slice projector) raises
    ``NotImplementedError`` until it is ported; ``'auto'`` = ``'gather'``.

    Memoized on the full geometry (least recently used of at most
    ``_PROJECTOR_CACHE_MAX`` pairs): repeated calls return the same
    ``(A, A_T)`` function objects."""
    vol_shape = tuple(int(n) for n in vol_shape)
    ang_np = (angles.detach().cpu().numpy()
              if isinstance(angles, torch.Tensor) else np.asarray(angles))
    key = (vol_shape, ang_np.tobytes(), ang_np.shape, n_det, dtype,
           angle_batch, _resolve_method(method))
    hit = _PROJECTOR_CACHE.get(key)
    if hit is not None:
        _PROJECTOR_CACHE.move_to_end(key)   # hits refresh position
        return hit
    n_det = n_det or vol_shape[-1]
    _check_geometry(vol_shape, ang_np)

    def A(x):
        return radon(x.to(dtype), ang_np, n_det=n_det,
                     angle_batch=angle_batch)

    def A_T(y):
        return _radon_adjoint(y.to(dtype), ang_np, vol_shape,
                             angle_batch=angle_batch)

    if len(_PROJECTOR_CACHE) >= _PROJECTOR_CACHE_MAX:
        _PROJECTOR_CACHE.popitem(last=False)
    pair = _PROJECTOR_CACHE[key] = (A, A_T)
    return pair


def estimate_op_norm(A, A_T, vol_shape, n_iter: int = 12, seed: int = 0,
                     dtype=torch.float32, device=None):
    """Power-method estimate of ``||A||_2`` (for primal-dual step sizes), a
    0-d tensor: ``solvers.inverse.power_iteration``."""
    return power_iteration(A, A_T, vol_shape, n_iter=n_iter, seed=seed,
                           dtype=dtype, device=device)


class CPReconResult(NamedTuple):
    x: torch.Tensor       # reconstructed volume (Nz, M, N, N)
    loss: torch.Tensor    # sampled F(Ax) + reg*TV history, on the device
    state: NamedTuple = None  # full solver carry (resume via state=)


def cp_reconstruct(
    sino,
    angles,
    vol_shape,
    n_iter: int = 100,
    reg: float = 1.0,
    cfg: TVConfig = TVConfig(),
    n_det: Optional[int] = None,
    op_norm: Optional[float] = None,
    x_init=None,
    geom=None,
    precond: bool = False,
    fidelity: str = "l2",
    fidelity_weight=1.0,
    nonneg: bool = False,
    state=None,
    method: str = "auto",
    fused: bool = None,
    dual_dtype=None,
    loss_every: int = 1,
    device=None,
):
    """TV-regularized reconstruction ``min_x F(A x) + reg TV(x)`` with the
    Chambolle-Pock algorithm over the joint operator ``K = [A; D]`` (step
    rule ``tau * sigma * (||A||^2 + ||D||^2) <= 1``) from a parallel-beam
    sinogram ``(Nz, M, n_angles, n_det)``.  ``geom`` other than ``None``
    (fan, cone) and ``method='spectral'`` raise ``NotImplementedError``
    until they are ported.  ``fidelity`` / ``fidelity_weight`` / ``nonneg``
    / ``precond`` / ``state`` / ``loss_every`` as in
    :func:`solvers.inverse.cp_inverse` (``fidelity='kl'`` = Poisson counts,
    ``nonneg=True`` = nonnegative attenuation).  ``fused`` / ``dual_dtype``
    as there too: the TV half of each iteration rides the fused kernels by
    default (float32/bfloat16, scalar steps), and ``dual_dtype='bfloat16'``
    halves the Nd-channel dual's memory and traffic.  The solve runs on the
    sinogram's device; a numpy sinogram goes to the CUDA device unless
    ``device`` names another."""
    sino = on_device(sino, device)
    A, A_T = _select_projector(sino, angles, vol_shape, n_det, geom,
                               method=method)
    res = cp_inverse(
        A, sino, vol_shape, A_T=A_T, n_iter=n_iter, reg=reg, cfg=cfg,
        op_norm=op_norm, x_init=x_init, precond=precond, fidelity=fidelity,
        fidelity_weight=fidelity_weight, nonneg=nonneg, state=state,
        fused=fused, dual_dtype=dual_dtype, loss_every=loss_every,
    )
    return CPReconResult(x=res.x, loss=res.loss, state=res.state)


def tgv_reconstruct(
    sino,
    angles,
    vol_shape,
    n_iter: int = 100,
    alpha1: float = 1.0,
    alpha0: float = 2.0,
    axes: str = "2d",
    n_det: Optional[int] = None,
    op_norm: Optional[float] = None,
    x_init=None,
    geom=None,
    precond: bool = False,
    norm: str = "iso",
    huber_delta: float = 1.0,
    fidelity: str = "l2",
    fidelity_weight=1.0,
    nonneg: bool = False,
    state=None,
    method: str = "auto",
    fused: bool = None,
    dual_dtype=None,
    loss_every: int = 1,
    device=None,
):
    """TGV-2-regularized reconstruction: :func:`cp_reconstruct` with the
    second-order regularizer ``a1 ||D x - w|| + a0 ||E w||`` instead of TV
    (``solvers.tgv.tgv_inverse``): staircasing-free reconstructions of
    piecewise-linear objects (classic TGV-CT).  Same sinogram layout,
    ``geom`` and ``method`` as :func:`cp_reconstruct`; ``axes`` picks
    in-plane ('2d', per (z, t) slice), volumetric ('3d') or space-time
    ('4d') TGV coupling.

    ``fused`` / ``dual_dtype`` / ``loss_every`` are accepted for signature
    symmetry with :func:`cp_reconstruct` but not implemented by
    ``tgv_inverse`` (the TGV kernels serve denoising only): setting them
    raises rather than being silently ignored."""
    if fused is not None or dual_dtype is not None or loss_every != 1:
        raise NotImplementedError(
            "tgv_reconstruct does not support fused/dual_dtype/loss_every "
            "— tgv_inverse runs the plain loop with a full loss series; "
            "leave these at their defaults (fused=None, dual_dtype=None, "
            "loss_every=1)"
        )
    from ..solvers.tgv import tgv_inverse

    sino = on_device(sino, device)
    A, A_T = _select_projector(sino, angles, vol_shape, n_det, geom,
                               method=method)
    res = tgv_inverse(
        A, sino, vol_shape, A_T=A_T, n_iter=n_iter, alpha1=alpha1,
        alpha0=alpha0, axes=axes, op_norm=op_norm, x_init=x_init,
        precond=precond, norm=norm, huber_delta=huber_delta,
        fidelity=fidelity, fidelity_weight=fidelity_weight, nonneg=nonneg,
        state=state,
    )
    return CPReconResult(x=res.x, loss=res.loss, state=res.state)


def _select_projector(sino, angles, vol_shape, n_det, geom, method="auto"):
    """Validate the sinogram layout for the requested beam geometry and
    build the matching (A, A_T) projector pair (memoized,
    :func:`make_projector`)."""
    _require_parallel(geom)
    n_angles = np.shape(angles)[-1]
    want = (vol_shape[0], vol_shape[1], n_angles, n_det or vol_shape[-1])
    if tuple(sino.shape) != want:
        raise ValueError(
            f"sinogram shape {tuple(sino.shape)} does not match "
            f"vol_shape {tuple(vol_shape)} with {n_angles} angles — "
            f"expected {want} (layout (Nz, M, n_angles, n_det))"
        )
    return make_projector(vol_shape, angles, n_det=n_det, dtype=sino.dtype,
                          method=method)


def _backproject(sino, angles, N: int, angle_batch: Optional[int] = None):
    """Direct (unfiltered) backprojection of ``(P, n_angles, n_det)``
    sinograms that share ``angles`` onto ``(P, N, N)`` grids: every pixel
    interpolates each projection linearly at its detector coordinate (zero
    outside).  NOT the exact adjoint of :func:`radon` (inside primal-dual
    solvers use make_projector's A_T; this feeds :func:`fbp`).
    ``angle_batch`` bounds the in-flight samples like :func:`radon`'s."""
    P, A, n_det = sino.shape
    dtype, device = sino.dtype, sino.device
    c = (N - 1) / 2.0
    r = torch.arange(N, dtype=dtype, device=device) - c
    R, C2 = r[:, None], r[None, :]
    B = min(int(angle_batch), A) if angle_batch else A
    out = torch.zeros((P, N, N), dtype=dtype, device=device)
    for a in range(0, A, B):
        th = angles[a:a + B, None, None]
        s = R * torch.cos(th) - C2 * torch.sin(th) + (n_det - 1) / 2.0
        lo = torch.floor(s)
        w_hi = s - lo
        lo = lo.long()
        p = sino[:, a:a + B]
        for idx, w in ((lo, 1.0 - w_hi), (lo + 1, w_hi)):
            valid = (idx >= 0) & (idx < n_det)
            flat = idx.clamp(0, n_det - 1).reshape(1, idx.shape[0], -1)
            vals = torch.gather(p, 2, flat.expand(P, -1, -1))
            w = torch.where(valid, w, 0.0).reshape(1, idx.shape[0], -1)
            out += (vals * w).sum(dim=1).reshape(P, N, N)
    return out


_FILTER_WINDOWS = ("ramp", "shepp-logan", "cosine", "hann", "hamming")


def _fourier_ramp(n_det: int, filter_name: str, dtype, device):
    """Frequency response of the BANDLIMITED ramp filter on a zero-padded
    grid, from the exact real-space taps ``h[0] = 1/4``,
    ``h[odd n] = -1/(pi n)^2``, ``h[even n] = 0`` (Kak & Slaney 1988,
    ch. 3 eq. 61): unlike sampling ``|f|`` directly this has the correct
    DC response, so reconstructions come out at the right absolute scale
    with no low-frequency bias.  The pad to ``>= 2 n_det`` makes the
    convolution linear instead of circular.  ``filter_name`` applies a
    standard apodization window (noise/ringing vs resolution trade)."""
    if filter_name not in _FILTER_WINDOWS:
        raise ValueError(
            f"unknown filter {filter_name!r}; expected one of "
            f"{_FILTER_WINDOWS}"
        )
    size = max(64, 2 ** int(np.ceil(np.log2(2 * n_det))))
    h = np.zeros(size)
    h[0] = 0.25
    odd = np.arange(1, size // 2, 2)
    h[odd] = -1.0 / (np.pi * odd) ** 2
    h[-odd] = h[odd]
    H = 2.0 * np.real(np.fft.fft(h))
    f = np.fft.fftfreq(size)                   # cycles/sample, |f| <= 0.5
    if filter_name == "shepp-logan":
        nz = f != 0
        H[nz] *= np.sin(np.pi * f[nz]) / (np.pi * f[nz])
    elif filter_name == "cosine":
        H *= np.cos(np.pi * f)
    elif filter_name == "hann":
        H *= 0.5 * (1.0 + np.cos(2.0 * np.pi * f))
    elif filter_name == "hamming":
        H *= 0.54 + 0.46 * np.cos(2.0 * np.pi * f)
    return torch.as_tensor(H, device=device).to(dtype), size


def _filter_projections(p, H, size: int, n_det: int):
    """Zero-pad the detector axis to ``size``, apply the ramp response, and
    crop back: linear convolution with the bandlimited kernel."""
    fp = torch.fft.fft(F.pad(p, (0, size - n_det)), dim=-1)
    return torch.real(torch.fft.ifft(fp * H, dim=-1)).to(p.dtype)[..., :n_det]


def fbp(sino, angles, n_out: Optional[int] = None,
        filter_name: str = "ramp", method: str = "auto", device=None):
    """Filtered backprojection of a ``(Nz, M, n_angles, n_det)`` sinogram:
    the classical analytic reconstruction (bandlimited Ram-Lak filter +
    backprojection), over z and time at once.

    Use directly for well-sampled static data, or as ``x_init`` for
    :func:`cp_reconstruct` to cut the iteration count of the TV-regularized
    solve.  ``angles`` may be shared ``(n_angles,)`` or per-frame
    ``(M, n_angles)``.  ``filter_name``: 'ramp' (sharpest), 'shepp-logan',
    'cosine', 'hann' or 'hamming' (progressively smoother: trade noise
    and ringing for resolution on real data).  ``method``: ``'gather'``
    interpolates each pixel's detector coordinate; ``'spectral'`` raises
    ``NotImplementedError`` until that projector is ported; ``'auto'`` =
    ``'gather'``."""
    _resolve_method(method)
    sino = on_device(sino, device)
    angles = _as_angles(angles, sino)
    Nz, M, n_angles, n_det = sino.shape
    N = n_out or n_det
    angle_batch = max(1, _RADON_GATHER_BUDGET
                      // max(Nz * M * N * N * sino.element_size(), 1))
    H, size = _fourier_ramp(n_det, filter_name, sino.dtype, sino.device)
    filtered = _filter_projections(sino, H, size, n_det)
    scale = np.pi / (2 * n_angles)
    if angles.ndim == 2:
        frames = [_backproject(filtered[:, m], angles[m], N, angle_batch)
                  for m in range(M)]
        return torch.stack(frames, dim=1) * scale
    bp = _backproject(filtered.reshape(Nz * M, n_angles, n_det), angles, N,
                      angle_batch)
    return bp.reshape(Nz, M, N, N) * scale
