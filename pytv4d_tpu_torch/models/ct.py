"""Tomographic reconstruction: parallel-, fan- and cone-beam projectors,
TV- and TGV-regularized primal-dual reconstruction, FBP, FDK and SART.  The
port of ``pytv4d_tpu/models/ct.py``.

The reference library exists to regularize iterative CT reconstruction
(Boigne et al. IEEE TCI 2022, doi 10.1109/TCI.2022.3215096) but ships no
projector.  This module completes the workflow:

- :func:`radon` / :func:`make_projector`: parallel-beam forward projector
  over the canonical ``(Nz, M, N, N)`` volume (bilinear sampling, linear in
  the image) with its **exact adjoint**, the transposed bilinear scatter over
  the same sample points; the pair passes the dot-product test to round-off,
  so primal-dual solvers converge as theory says.
- :func:`radon_fan` / :func:`make_fan_projector` (:class:`FanBeamGeometry`,
  a flat detector, the beam fanning in-plane: sinogram ``(Nz, M, n_angles,
  n_det)``) and :func:`radon_cone` / :func:`make_cone_projector`
  (:class:`ConeBeamGeometry`, a circular orbit and a flat panel, trilinear
  sampling: sinogram ``(M, n_angles, n_det_v, n_det_u)``), each with its
  exact adjoint in the same way.
- per-frame angle sets: dynamic CT interleaves projection angles across time
  frames (the paper's setting); ``angles`` may be ``(n_angles,)`` shared or
  ``(M, n_angles)`` per-frame.
- :func:`cp_reconstruct`: Chambolle-Pock for
  ``min_x F(A x) + reg * TV(x)`` (``solvers.inverse.cp_inverse`` on the
  projector of ``geom``), step sizes from a power-method estimate of
  ``||A||``.
- :func:`tgv_reconstruct`: the same with the second-order TGV regularizer
  (``solvers.tgv.tgv_inverse``).
- :func:`fbp`, :func:`fdk` and :func:`sart`: filtered backprojection,
  Feldkamp-Davis-Kress and ordered-subsets SART, directly or as ``x_init``.

The gather projectors are plain torch ops (``grid_sample`` and its
transpose), as they are XLA ops in the JAX package; ``method='spectral'``
takes the gather-free Fourier-slice projectors of :mod:`.ct_spectral`
(FFTs and matmuls); the TV half of a reconstruction's iteration runs on the
fused kernels (``kernels.fused``) either way.  ``method='auto'`` is
``'gather'`` on the CPU and, on a CUDA device, the faster of the two per
geometry as measured on the card (``_AUTO_ON_CUDA``).

Where a call computes (``utils.device``): a tensor on its own device; a
numpy sinogram or volume on the CUDA device (``RuntimeError`` where there
is none) unless ``device=`` names another.
"""

from __future__ import annotations

import collections
import functools
from typing import NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..core.config import TVConfig
from ..solvers.inverse import _LinearTranspose, cp_inverse, power_iteration
from ..utils.device import on_device
from ..utils.profiling import solve_span
from . import ct_spectral

_RADON_GATHER_BUDGET = 512 * 1024 * 1024  # bytes of in-flight samples


def _as_angles(angles, like):
    """The angles as a tensor of ``like``'s dtype on its device."""
    if isinstance(angles, torch.Tensor):
        return angles.to(device=like.device, dtype=like.dtype)
    return torch.as_tensor(np.asarray(angles), device=like.device).to(
        like.dtype)


def _grid(coords, sizes):
    """Pixel coordinates, one tensor each in the sampler's (x, y[, z])
    order, stacked as ``grid_sample``'s grid, normalised for
    ``align_corners=True`` on an input of ``sizes`` (in the same order; each
    at least 2, see :func:`_two_at_least`).  Python scalars scale them: a
    scale tensor made on the device would copy from the host, and such a
    copy waits for the device."""
    return torch.stack([c * (2.0 / (n - 1)) - 1.0
                        for c, n in zip(coords, sizes)], dim=-1)


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
    return _grid((cols, rows), (N, N)).reshape(thetas.shape[0], -1, N, 2)


# bilinear / trilinear (0), zero outside (0), pixel centres at integers: a
# sample within one pixel outside the image still gets the weight of its
# inside corners, as scipy's map_coordinates(order=1, mode='constant',
# cval=0) gives it.  Every projector and its adjoint call the samplers with
# exactly these arguments.
_SAMPLER = dict(interpolation_mode=0, padding_mode=0, align_corners=True)


def _two_at_least(t, n_dims: int):
    """``t`` with each of its last ``n_dims`` axes of length 1 padded to 2
    with zeros.  With ``align_corners=True`` the samplers map every
    coordinate of a length-1 axis to its one pixel; on the padded axis a
    coordinate keeps its weights, and the zero pixel adds nothing."""
    pad = []
    for n in reversed(t.shape[t.ndim - n_dims:]):
        pad += [0, 1 if n == 1 else 0]
    return F.pad(t, pad) if any(pad) else t


def _as_slices(vol, per_frame: bool):
    """The volume as ``grid_sample``'s (batch, channels, N, N): slices that
    share their angles are channels of one batch entry."""
    Nz, M, N = vol.shape[0], vol.shape[1], vol.shape[-1]
    if per_frame:
        return vol.transpose(0, 1)             # (M, Nz, N, N)
    return vol.reshape(1, Nz * M, N, N)


def _angle_chunks(n_angles: int, per_angle: int, angle_batch):
    """``(start, stop)`` angle ranges whose samples (``per_angle`` bytes an
    angle) stay within the in-flight budget, or that hold ``angle_batch``
    angles."""
    if angle_batch is None:
        angle_batch = max(1, _RADON_GATHER_BUDGET // max(per_angle, 1))
    B = max(1, min(int(angle_batch), n_angles))
    return [(a, min(a + B, n_angles)) for a in range(0, n_angles, B)]


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


def _sweep(vol, angles, grid_of, n_det: int, per_angle: int, angle_batch):
    """Ray sums of a ``(Nz, M, N, N)`` volume, ``(Nz, M, n_angles,
    n_det)``: per angle chunk, bilinear samples at ``grid_of(thetas)``
    (``(G, B * n_det, S, 2)`` for ``(G, B)`` angles), summed along each
    ray's S samples."""
    Nz, M = vol.shape[0], vol.shape[1]
    per_frame = angles.ndim == 2
    slices = _as_slices(vol, per_frame)
    thetas = angles if per_frame else angles[None]
    out = []
    for a, b in _angle_chunks(angles.shape[-1], per_angle, angle_batch):
        samples = torch.ops.aten.grid_sampler_2d(
            slices, grid_of(thetas[:, a:b]), **_SAMPLER)
        out.append(samples.sum(dim=-1).reshape(
            slices.shape[0], slices.shape[1], b - a, n_det))
    sino = torch.cat(out, dim=2)
    if per_frame:
        return sino.transpose(0, 1)
    return sino.reshape(Nz, M, -1, n_det)


def _sweep_adjoint(sino, angles, vol_shape, grid_of, n_samples: int,
                   per_angle: int, angle_batch):
    """The exact transpose of :func:`_sweep` at ``vol_shape``: every
    sinogram value is scattered along its ray with the bilinear weights the
    forward sweep sampled with (the sampler's own transpose, computed from
    the same coordinates, without running the forward sweep).  On a CUDA
    device the scatter uses atomic adds, so two runs may differ in the last
    bits."""
    Nz, M, N = vol_shape[0], vol_shape[1], vol_shape[-1]
    n_det = sino.shape[-1]
    per_frame = angles.ndim == 2
    y = sino.transpose(0, 1) if per_frame else sino.reshape(
        1, Nz * M, -1, n_det)
    thetas = angles if per_frame else angles[None]
    acc = torch.zeros(y.shape[:2] + (N, N), dtype=sino.dtype,
                      device=sino.device)
    for a, b in _angle_chunks(angles.shape[-1], per_angle, angle_batch):
        g = y[:, :, a:b].reshape(y.shape[0], y.shape[1], -1, 1).expand(
            -1, -1, -1, n_samples)
        # the sampler's transpose takes its input for the shape (and for
        # the grid's gradient, which is not asked for)
        part, _ = torch.ops.aten.grid_sampler_2d_backward(
            g, acc, grid_of(thetas[:, a:b]), output_mask=(True, False),
            **_SAMPLER)
        acc += part
    if per_frame:
        return acc.transpose(0, 1).contiguous()
    return acc.reshape(vol_shape)


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
    return _sweep(vol, angles, lambda th: _sample_grid(th, N, n_det), n_det,
                  Nz * M * n_det * N * vol.element_size(), angle_batch)


def _radon_adjoint(sino, angles, vol_shape, angle_batch: Optional[int] = None):
    """The exact transpose of :func:`radon` at ``vol_shape``
    (:func:`_sweep_adjoint`)."""
    vol_shape = tuple(vol_shape)
    angles = _as_angles(angles, sino)
    _check_geometry(vol_shape, angles)
    Nz, M, N = vol_shape[0], vol_shape[1], vol_shape[-1]
    n_det = sino.shape[-1]
    return _sweep_adjoint(sino, angles, vol_shape,
                          lambda th: _sample_grid(th, N, n_det), N,
                          Nz * M * n_det * N * sino.element_size(),
                          angle_batch)


_PROJECTOR_METHODS = ("auto", "gather", "spectral")
# 'auto' on a CUDA device, per geometry: the pair chip_smoke.py phase 28
# measures faster at (16, 4, 512, 512) x 96 angles on an NVIDIA H100 (the
# phase fails if this table names the slower one; PERF.md section 6).  The
# JAX package takes 'spectral' off the CPU for every geometry.
_AUTO_ON_CUDA = {"parallel": "spectral", "fan": "spectral",
                 "cone": "spectral"}


def _resolve_method(method: str, geometry: str = "parallel",
                    device=None) -> str:
    """``'auto'`` = ``'gather'`` on the CPU (where the golden parity
    lives) and ``_AUTO_ON_CUDA[geometry]`` on a CUDA device.  ``device``:
    where the call computes (default: the CUDA device when there is one)."""
    if method not in _PROJECTOR_METHODS:
        raise ValueError(
            f"unknown projector method {method!r}; expected one of "
            f"{_PROJECTOR_METHODS}"
        )
    if method != "auto":
        return method
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    if torch.device(device).type != "cuda":
        return "gather"
    return _AUTO_ON_CUDA[geometry]


def _geometry_name(geom) -> str:
    if geom is None:
        return "parallel"
    if isinstance(geom, ConeBeamGeometry):
        return "cone"
    if isinstance(geom, FanBeamGeometry):
        return "fan"
    raise _unknown_geometry(geom)


_PROJECTOR_CACHE: "collections.OrderedDict" = collections.OrderedDict()
_PROJECTOR_CACHE_MAX = 24
# >= n_subsets + 2, so that one spectral SART campaign (8 subset pairs and
# the full-angle pair) and a reconstruction geometry stay memoized together


def clear_projector_cache() -> None:
    """Drop all memoized ``(A, A_T)`` projector pairs (the parallel, fan and
    cone ones, gather and spectral, with the tables they hold on a device)
    and the caches derived from them: the spectral cone's preconditioner
    sums and scales, the spectral cone SART's normalizers, and
    :mod:`.ct_spectral`'s grid, rebinning, z-DFT tier and device memos.
    (The JAX package leaves the last four populated.)"""
    _PROJECTOR_CACHE.clear()
    _CONE_PRECOND_CACHE.clear()
    _SART_SUMS_CACHE.clear()
    ct_spectral._GRID_CACHE.clear()
    ct_spectral._REBIN_CACHE.clear()
    ct_spectral._ZDFT_CACHE.clear()
    ct_spectral._DEVICE_CACHE.clear()


def _cached_pair(key, builder):
    """The pair memoized under ``key`` in ``_PROJECTOR_CACHE`` (least
    recently used of at most ``_PROJECTOR_CACHE_MAX``), built by
    ``builder()`` on a miss: repeated solves get the same function
    objects."""
    hit = _PROJECTOR_CACHE.get(key)
    if hit is not None:
        _PROJECTOR_CACHE.move_to_end(key)   # hits refresh position
        return hit
    pair = builder()
    if len(_PROJECTOR_CACHE) >= _PROJECTOR_CACHE_MAX:
        _PROJECTOR_CACHE.popitem(last=False)
    _PROJECTOR_CACHE[key] = pair
    return pair


def _host_angles(angles):
    """The angles as a numpy array (the cache keys' form)."""
    if isinstance(angles, torch.Tensor):
        return angles.detach().cpu().numpy()
    return np.asarray(angles)


def _differentiable_pair(A, A_T):
    """``(A, A_T)`` with ``A_T`` differentiable in its input: a ``y`` that
    requires grad, under grad mode, runs it as
    ``solvers.inverse._LinearTranspose``, whose backward is ``A`` itself.
    Autograd then records neither the scatter's in-place accumulation nor
    the sampler's transpose, which has no derivative on a CUDA device.
    Any other ``y`` takes ``A_T`` as it is."""
    def A_T_(y):
        if (isinstance(y, torch.Tensor) and y.requires_grad
                and torch.is_grad_enabled()):
            return _LinearTranspose.apply(y, A, A_T)
        return A_T(y)

    return A, A_T_


def _parallel_pair(vol_shape, angles, n_det, dtype, angle_batch=None):
    """``(A, A_T)`` of :func:`radon` at a fixed geometry, unmemoized."""
    vol_shape = tuple(int(n) for n in vol_shape)
    _check_geometry(vol_shape, angles)
    n_det = n_det or vol_shape[-1]

    def A(x):
        return radon(on_device(x).to(dtype), angles, n_det=n_det,
                     angle_batch=angle_batch)

    def A_T(y):
        return _radon_adjoint(on_device(y).to(dtype), angles, vol_shape,
                              angle_batch=angle_batch)

    return _differentiable_pair(A, A_T)


def make_projector(vol_shape, angles, n_det: Optional[int] = None,
                   dtype=torch.float32, angle_batch: Optional[int] = None,
                   method: str = "auto", precision: Optional[str] = None):
    """Build ``(A, A_T)`` for a fixed geometry.  ``A_T`` is the exact
    transpose of the linear map ``A``, so ``<y, A x> == <A_T y, x>`` holds
    to round-off: the same adjointness contract the TV operators satisfy.
    ``angle_batch`` as in :func:`radon` (the spectral projector's
    ``angle_chunk``).  Both compute in ``dtype`` on their input's device.

    ``method``: ``'gather'`` = bilinear-sampling :func:`radon` with its
    transposed scatter (:func:`_radon_adjoint`); ``'spectral'`` = the
    gather-free Fourier-slice projector
    (:func:`.ct_spectral.make_spectral_projector`: spectrally accurate, FFTs
    and matmuls both ways); ``'auto'`` as :func:`_resolve_method` says on
    the default device.  ``precision`` (spectral only): ``'high'`` (default)
    and ``'highest'`` run its matmuls in IEEE float32 on a CUDA device,
    ``'default'`` in TF32.

    Memoized on the full geometry (least recently used of at most
    ``_PROJECTOR_CACHE_MAX`` pairs): repeated calls return the same
    ``(A, A_T)`` function objects."""
    vol_shape = tuple(int(n) for n in vol_shape)
    ang_np = _host_angles(angles)
    method = _resolve_method(method)
    key = (vol_shape, ang_np.tobytes(), ang_np.shape, n_det, dtype,
           angle_batch, method, precision)
    if method == "spectral":
        return _cached_pair(key, lambda: ct_spectral.make_spectral_projector(
            vol_shape, ang_np, n_det=n_det, dtype=dtype,
            angle_chunk=angle_batch, precision=precision))
    return _cached_pair(key, lambda: _parallel_pair(
        vol_shape, ang_np, n_det, dtype, angle_batch))


def estimate_op_norm(A, A_T, vol_shape, n_iter: int = 12, seed: int = 0,
                     dtype=torch.float32, device=None):
    """Power-method estimate of ``||A||_2`` (for primal-dual step sizes), a
    0-d tensor: ``solvers.inverse.power_iteration``."""
    return power_iteration(A, A_T, vol_shape, n_iter=n_iter, seed=seed,
                           dtype=dtype, device=device)


def sinogram_sharding(mesh, shard_time: bool = True):
    """Where a ``(Nz, M, n_angles, n_det)`` sinogram lives on the (z, t)
    mesh (``parallel.mesh.Sharding``; place it with
    ``parallel.mesh.shard``).  Parallel- and fan-beam CT decompose exactly
    along z and t (the reason the reference chose the (Nz, M, N, N)
    layout, ``README.md:235``): on such a grid :func:`cp_reconstruct`,
    :func:`tgv_reconstruct`, :func:`sart` and :func:`fbp` run the projector
    shard by shard with no exchange (a caller's ``project_fn`` in
    :func:`sart` too, with the angles of the shard's column), and only the
    TV stencil's one-plane halos and the sums cross shards."""
    from ..parallel.mesh import T_AXIS, Z_AXIS, Sharding

    t_spec = T_AXIS if (shard_time and mesh.shape[T_AXIS] > 1) else None
    return Sharding(mesh, (Z_AXIS if mesh.shape[Z_AXIS] > 1 else None,
                           t_spec, None, None))


def cone_sinogram_sharding(mesh):
    """Where a cone-beam ``(M, n_angles, n_det_v, n_det_u)`` sinogram lives
    on a mesh with a sharded 't' axis.  The cone couples z (one frame's
    projection reads the whole z extent), so z stays whole; time is a pure
    batch axis of :func:`radon_cone`, so a t-cut sinogram reconstructs with
    no exchange in the projector (the TV stencil's t halos, when
    ``reg_time > 0``, come from ``parallel.halo``)."""
    from ..parallel.mesh import T_AXIS, Sharding

    if mesh.shape[T_AXIS] == 1:
        raise ValueError(
            "cone_sinogram_sharding needs a mesh with a sharded 't' axis — "
            "the cone projector couples z, so time is the only "
            "zero-communication direction (parallel.mesh.make_mesh(z=1, "
            "t=...))"
        )
    return Sharding(mesh, (T_AXIS, None, None, None))


class CPReconResult(NamedTuple):
    x: torch.Tensor       # reconstructed volume (Nz, M, N, N)
    loss: torch.Tensor    # sampled F(Ax) + reg*TV history, on the device
    state: NamedTuple = None  # full solver carry (resume via state=)


@solve_span
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
    precision: Optional[str] = None,
    device=None,
):
    """TV-regularized reconstruction ``min_x F(A x) + reg TV(x)`` with the
    Chambolle-Pock algorithm over the joint operator ``K = [A; D]`` (step
    rule ``tau * sigma * (||A||^2 + ||D||^2) <= 1``).  ``geom`` selects the
    beam geometry: ``None`` = parallel, :class:`FanBeamGeometry` = fan
    (sinogram ``(Nz, M, n_angles, n_det)``), :class:`ConeBeamGeometry` =
    cone (sinogram ``(M, n_angles, n_det_v, n_det_u)``; ``n_det`` ignored:
    the detector's dimensions come from the sinogram).  ``method`` picks the
    projector for any geometry (:func:`_resolve_method`): the gather path,
    or the spectral one (parallel: Fourier-slice NUDFT; fan: rebinning;
    cone: SSRB with the first-order slope correction, approximate).
    ``precision`` as in :func:`make_projector`.  ``precond=True`` on the
    spectral cone takes the abs-factor surrogate sums and a power-method
    check of the preconditioned step (:func:`_spectral_cone_precond_setup`).
    ``fidelity`` / ``fidelity_weight`` / ``nonneg`` / ``precond`` /
    ``state`` / ``loss_every`` as in :func:`solvers.inverse.cp_inverse`
    (``fidelity='kl'`` = Poisson counts, ``nonneg=True`` = nonnegative
    attenuation).  ``fused`` / ``dual_dtype`` as there too: the TV half of
    each iteration rides the fused kernels by default (float32/bfloat16,
    scalar steps), and ``dual_dtype='bfloat16'`` halves the Nd-channel
    dual's memory and traffic.  The solve runs on the sinogram's device; a
    numpy sinogram goes to the CUDA device unless ``device`` names
    another.

    A sinogram placed on a mesh (a grid of shards from
    ``parallel.mesh.shard`` with :func:`sinogram_sharding` or, for the
    cone, :func:`cone_sinogram_sharding`) is solved shard by shard
    (``solvers.inverse.cp_inverse_grid``): the projector and its adjoint
    per shard with no exchange, the TV half on ``parallel.halo``'s
    exchanged stencils or, on the fused path (chosen as for a volume), on
    the kernels in their halo mode (B5, B2 and B3 a shard), the loss and
    every scale a relative floor is taken from over the whole grid; ``x``
    and the state come back as grids of the volume's layout.  Every option
    serves a grid: ``precond`` (on the spectral cone the surrogate sums
    per column of shards and the power method on the grid), ``state`` (of
    grids or of whole arrays, which are cut onto the grid), an array
    ``fidelity_weight`` (the sinogram's shape, cut like it, or a grid),
    ``x_init``, ``fused``, ``dual_dtype`` and ``loss_every``."""
    from ..parallel.mesh import is_grid

    if is_grid(sino):
        return _cp_reconstruct_grid(
            sino, angles, vol_shape, n_iter=n_iter, reg=reg, cfg=cfg,
            n_det=n_det, op_norm=op_norm, x_init=x_init, geom=geom,
            precond=precond, fidelity=fidelity,
            fidelity_weight=fidelity_weight, nonneg=nonneg, state=state,
            method=method, fused=fused, dual_dtype=dual_dtype,
            loss_every=loss_every, precision=precision)
    sino = on_device(sino, device)
    A, A_T = _select_projector(sino, angles, vol_shape, n_det, geom,
                               method=method, precision=precision)
    precond_kw = {}
    if precond and isinstance(geom, ConeBeamGeometry) and _resolve_method(
            method, "cone", sino.device) == "spectral":
        # the slope correction has signed entries, so A(1) / A^T(1)
        # underestimate |A|: the surrogate's sums, and all steps rescaled
        # by the measured norm of the preconditioned operator
        sums, scale = _spectral_cone_precond_setup(
            A, A_T, tuple(sino.shape), tuple(vol_shape),
            _host_angles(angles), geom, cfg, sino.dtype, precision,
            sino.device)
        precond_kw = dict(precond_sums=sums, precond_scale=scale)
    res = cp_inverse(
        A, sino, vol_shape, A_T=A_T, n_iter=n_iter, reg=reg, cfg=cfg,
        op_norm=op_norm, x_init=x_init, precond=precond, fidelity=fidelity,
        fidelity_weight=fidelity_weight, nonneg=nonneg, state=state,
        fused=fused, dual_dtype=dual_dtype, loss_every=loss_every,
        **precond_kw,
    )
    return CPReconResult(x=res.x, loss=res.loss, state=res.state)


def _column_angles(ang_np, it, m_local):
    """The angles of column ``it`` of a grid whose shards hold ``m_local``
    frames: per-frame angle sets are cut along t with the volume."""
    return (ang_np[it * m_local:(it + 1) * m_local] if ang_np.ndim == 2
            else ang_np)


def _grid_layout(grid, vol_shape, geom):
    """``(mesh, sinogram sharding, local volume shape)`` of a sinogram
    grid; a cone sinogram is cut along t only."""
    from ..parallel.mesh import (
        T_AXIS,
        Sharding,
        check_divisible,
        grid_mesh,
        grid_size,
    )

    nz, nt = len(grid), grid_size(grid, 1)
    if isinstance(geom, ConeBeamGeometry) and nz != 1:
        raise ValueError(
            "a cone-beam sinogram is cut along t only "
            "(cone_sinogram_sharding): the cone couples z")
    check_divisible(vol_shape, nz, nt)
    mesh = grid_mesh(grid).mesh
    sharding = (Sharding(mesh, (T_AXIS, None, None, None))
                if isinstance(geom, ConeBeamGeometry)
                else sinogram_sharding(mesh, nt > 1))
    return mesh, sharding, (vol_shape[0] // nz,
                            vol_shape[1] // nt) + tuple(vol_shape[2:])


def _grid_pairs(grid, angles, vol_shape, geom, n_det, method,
                precision=None):
    """``(sinogram sharding, local volume shape, first shard, host angles,
    pairs)`` of a sinogram grid: one projector pair per column of shards
    (per-frame angle sets are cut along t with the volume)."""
    from ..parallel.mesh import first_shard

    mesh, sharding, local = _grid_layout(grid, vol_shape, geom)
    first = first_shard(grid)
    ang_np = _host_angles(angles)
    pairs = [_select_projector(first, _column_angles(ang_np, it, local[1]),
                               local, n_det, geom, method=method,
                               precision=precision)
             for it in range(mesh.shape["t"])]
    return sharding, local, first, ang_np, pairs


def _cp_reconstruct_grid(grid, angles, vol_shape, *, geom, n_det, method,
                         precision, cfg, **kw):
    """:func:`cp_reconstruct` of a sinogram grid:
    ``solvers.inverse.cp_inverse_grid`` with one projector pair per column
    of shards, on the spectral cone with ``precond`` its surrogate's sums
    and step scale (:func:`_spectral_cone_precond_grid`)."""
    from ..solvers.inverse import cp_inverse_grid

    vol_shape = tuple(int(n) for n in vol_shape)
    sharding, local, first, ang_np, pairs = _grid_pairs(
        grid, angles, vol_shape, geom, n_det, method, precision)
    setup = None
    if kw["precond"] and isinstance(geom, ConeBeamGeometry) and \
            _resolve_method(method, "cone", first.device) == "spectral":
        setup = functools.partial(
            _spectral_cone_precond_grid, pairs, first=first, local=local,
            ang_np=ang_np, geom=geom, cfg=cfg, precision=precision)
    res = cp_inverse_grid(lambda it: pairs[it], grid, vol_shape,
                          data_sharding=sharding, cfg=cfg,
                          precond_setup=setup, **kw)
    return CPReconResult(x=res.x, loss=res.loss, state=res.state)


_CONE_PRECOND_CACHE: dict = {}


def _spectral_cone_precond_setup(A, A_T, sino_shape, vol_shape, ang_np,
                                 geom, cfg, dtype, precision, device):
    """Preconditioner inputs for the signed spectral cone:
    ``((row_sum, col_sum), scale)``.

    1. :func:`.ct_spectral.cone_spectral_precond_sums`, the abs-factor
       surrogate's exact row and column sums;
    2. a 20-step power method for ``rho = ||Sigma^{1/2} K T^{1/2}||`` of the
       joint ``K = [A; D]`` with the resulting diagonals
       (:func:`_cone_precond_scale`): the step condition is ``rho <= 1``
       (Pock-Chambolle, Lemma 2), so ``scale = 1.05 rho`` puts the scaled
       norm at 0.95 on whichever side of 1 the surrogate landed.

    Memoized per (projector, cfg, shapes, dtype, device), at most 8."""
    key = (id(A), cfg, tuple(vol_shape), tuple(sino_shape), dtype,
           torch.device(device))
    hit = _CONE_PRECOND_CACHE.get(key)
    if hit is not None:
        # the entry pins A, so its id cannot name another projector
        return hit[1]
    from ..ops.operators import precond_maps
    from ..ops.space import tensor_space
    from ..solvers.inverse import _bind_operator

    row, col = ct_spectral.cone_spectral_precond_sums(
        vol_shape, ang_np, geom, n_det_v=sino_shape[2],
        n_det_u=sino_shape[3], dtype=dtype, precision=precision,
        device=device)
    A_, A_T_ = _bind_operator(A, A_T, vol_shape, dtype)

    def maps(col):
        return precond_maps(
            vol_shape, cfg.scheme, cfg.reg_z_over_reg, cfg.reg_time,
            fidelity_colsum=col, grouped=cfg.norm != "aniso", dtype=dtype,
            device=device)

    v = on_device(np.random.default_rng(0).standard_normal(vol_shape),
                  device, dtype)
    out = ((row, col), _cone_precond_scale(
        A_, A_T_, row, col, tensor_space(cfg, shape=vol_shape), maps, v))
    return _remember_cone_precond(key, A, out)


def _remember_cone_precond(key, pins, out):
    if len(_CONE_PRECOND_CACHE) >= 8:
        _CONE_PRECOND_CACHE.pop(next(iter(_CONE_PRECOND_CACHE)))
    _CONE_PRECOND_CACHE[key] = (pins, out)
    return out


def _cone_precond_scale(A, A_T, row, col, space, maps, v):
    """``1.05 rho``: the 20-step power method of
    :func:`_spectral_cone_precond_setup` on ``space``'s fields, from the
    start field ``v``, the row floor from the whole field's largest."""
    from ..solvers.inverse import _power_norm

    sig_D, tau = maps(col)
    floor = 1e-6 * torch.clamp_min(space.max(torch.max, row), 1e-30)
    sig_A = space.map(lambda r: 1.0 / torch.maximum(r, floor), row)
    sqt = space.map(torch.sqrt, tau)

    def B(v):
        w = space.map(torch.mul, sqt, v)
        d = space.D_T(space.map(torch.mul, sig_D, space.D(w)))
        return space.map(lambda s, a, dd: s * (a + dd), sqt,
                         A_T(space.map(torch.mul, sig_A, A(w))), d)

    return 1.05 * float(_power_norm(B, lambda y: y, v, space, 20))


def _floored(space, field, eps=1e-6):
    """``field`` floored at ``eps`` of its largest value over the whole
    field (on a grid: the whole grid's, never one shard's), as
    :func:`.ct_spectral.cone_spectral_precond_sums` floors its sums."""
    top = space.max(torch.max, field)
    return space.map(lambda a: torch.maximum(a, eps * top), field)


def _spectral_cone_precond_grid(pairs, fields, *, first, local, ang_np,
                                geom, cfg, precision):
    """:func:`_spectral_cone_precond_setup` on a t-cut grid of ``fields``
    (``first``: its first sinogram shard), ``cp_inverse_grid``'s
    ``precond_setup``: the surrogate sums per column of shards (each
    column's projector and angles), floored at 1e-6 of the whole grid's
    largest, and the power method on the grid from the whole volume's
    seeded start vector cut onto it, its norms summed over shards.
    Memoized per column's projector."""
    space = fields.space
    key = (tuple(id(A) for A, _ in pairs), cfg, space.shape,
           tuple(first.shape), local, first.dtype, first.device)
    hit = _CONE_PRECOND_CACHE.get(key)
    if hit is not None:
        return hit[1]
    raw = [ct_spectral.cone_spectral_precond_sums(
        local, _column_angles(ang_np, it, local[1]), geom,
        n_det_v=first.shape[2], n_det_u=first.shape[3], dtype=first.dtype,
        precision=precision, floor=False, device=first.device)
        for it in range(len(pairs))]
    row, col = (_floored(space, [[r[k] for r in raw]]) for k in range(2))
    out = ((row, col), _cone_precond_scale(
        fields.A, fields.A_T, row, col, space, fields.precond_maps,
        fields.start(0)))
    return _remember_cone_precond(key, pairs, out)


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
    piecewise-linear objects (classic TGV-CT).  Same sinogram layouts,
    ``geom`` and ``method`` as :func:`cp_reconstruct`; ``axes`` picks
    in-plane ('2d', per (z, t) slice), volumetric ('3d') or space-time
    ('4d') TGV coupling.

    ``fused`` / ``dual_dtype`` / ``loss_every`` are accepted for signature
    symmetry with :func:`cp_reconstruct` but not implemented by
    ``tgv_inverse`` (the TGV kernels serve denoising only): setting them
    raises rather than being silently ignored.

    A sinogram grid (as :func:`cp_reconstruct` takes) runs the same loop
    shard by shard (``solvers.tgv.tgv_inverse_on`` on
    ``solvers.inverse.grid_fields``): the projector per shard, the TGV
    stencils exchanged, the loss, the norms and the preconditioners'
    floors over the whole grid; ``x``, ``w`` and the state come back as
    grids."""
    from ..parallel.mesh import is_grid

    if fused is not None or dual_dtype is not None or loss_every != 1:
        raise NotImplementedError(
            "tgv_reconstruct does not support fused/dual_dtype/loss_every "
            "— tgv_inverse runs the plain loop with a full loss series; "
            "leave these at their defaults (fused=None, dual_dtype=None, "
            "loss_every=1)"
        )
    from ..solvers.tgv import tgv_inverse, tgv_inverse_on

    kw = dict(n_iter=n_iter, alpha1=alpha1, alpha0=alpha0, axes=axes,
              op_norm=op_norm, x_init=x_init, precond=precond, norm=norm,
              huber_delta=huber_delta, fidelity=fidelity,
              fidelity_weight=fidelity_weight, nonneg=nonneg, state=state)
    if is_grid(sino):
        from ..solvers.inverse import check_grid_fidelity, grid_fields

        vol_shape = tuple(int(n) for n in vol_shape)
        sharding, _, _, _, pairs = _grid_pairs(sino, angles, vol_shape,
                                               geom, n_det, method)
        check_grid_fidelity(fidelity, sino, fidelity_weight)
        res = tgv_inverse_on(grid_fields(lambda it: pairs[it], sino,
                                         vol_shape, None, sharding),
                             sino, **kw)
        return CPReconResult(x=res.x, loss=res.loss, state=res.state)
    sino = on_device(sino, device)
    A, A_T = _select_projector(sino, angles, vol_shape, n_det, geom,
                               method=method)
    res = tgv_inverse(A, sino, vol_shape, A_T=A_T, **kw)
    return CPReconResult(x=res.x, loss=res.loss, state=res.state)


def _unknown_geometry(geom):
    return ValueError(
        f"unknown geometry {type(geom).__name__}; expected None "
        f"(parallel), FanBeamGeometry or ConeBeamGeometry"
    )


def _geometry_pair(geom, vol_shape, ang_np, dtype, method, precision,
                   det):
    """The memoized ``(A, A_T)`` of a fan (``det = (n_det,)``) or cone
    (``det = (n_det_v, n_det_u)``) geometry by ``method``."""
    vol_shape = tuple(int(n) for n in vol_shape)
    cone = isinstance(geom, ConeBeamGeometry)
    key = ("cone" if cone else "fan", method, vol_shape, ang_np.tobytes(),
           ang_np.shape, dtype, precision, tuple(geom)) + tuple(det)
    if method == "spectral":
        if cone:
            return _cached_pair(
                key, lambda: ct_spectral.make_cone_spectral_projector(
                    vol_shape, ang_np, geom, n_det_v=det[0], n_det_u=det[1],
                    dtype=dtype, precision=precision))
        return _cached_pair(
            key, lambda: ct_spectral.make_fan_spectral_projector(
                vol_shape, ang_np, geom, n_det=det[0], dtype=dtype,
                precision=precision))
    if cone:
        return _cached_pair(key, lambda: make_cone_projector(
            vol_shape, ang_np, geom, n_det_v=det[0], n_det_u=det[1],
            dtype=dtype))
    return _cached_pair(key, lambda: make_fan_projector(
        vol_shape, ang_np, geom, n_det=det[0], dtype=dtype))


def _select_projector(sino, angles, vol_shape, n_det, geom, method="auto",
                      precision=None):
    """Validate the sinogram layout for the requested beam geometry and
    build the matching (A, A_T) projector pair.  Every geometry goes
    through ``_PROJECTOR_CACHE``: repeated solves with the same geometry
    get the same function objects."""
    method = _resolve_method(method, _geometry_name(geom), sino.device)
    dtype = sino.dtype
    ang_np = _host_angles(angles)
    n_angles = ang_np.shape[-1]

    if isinstance(geom, ConeBeamGeometry):
        want = (vol_shape[1], n_angles)
        if tuple(sino.shape[:2]) != want:
            raise ValueError(
                f"cone-beam sinogram shape {tuple(sino.shape)} does not "
                f"match vol_shape {tuple(vol_shape)} with {n_angles} angles "
                f"— expected (M={vol_shape[1]}, {n_angles}, n_det_v, "
                f"n_det_u)"
            )
        return _geometry_pair(geom, vol_shape, ang_np, dtype, method,
                              precision, tuple(sino.shape[2:]))
    want = (vol_shape[0], vol_shape[1], n_angles, n_det or vol_shape[-1])
    if tuple(sino.shape) != want:
        raise ValueError(
            f"sinogram shape {tuple(sino.shape)} does not match "
            f"vol_shape {tuple(vol_shape)} with {n_angles} angles — "
            f"expected {want} (layout (Nz, M, n_angles, n_det))"
        )
    if geom is None:
        return make_projector(vol_shape, ang_np, n_det=n_det, dtype=dtype,
                              method=method, precision=precision)
    return _geometry_pair(geom, vol_shape, ang_np, dtype, method, precision,
                          (n_det or vol_shape[-1],))


def _ray_spacing(half: float, step: float):
    """``(n_samples, ds)`` of a divergent ray: ``n_samples`` points ``ds``
    apart covering ``[-half, half]`` around its closest approach to the
    isocentre."""
    n_samples = max(int(np.ceil(2.0 * half / step)), 2)
    return n_samples, 2.0 * half / n_samples


def _ray_axis(half: float, step: float, dtype, device):
    """The samples' positions along a ray, ``(k + 0.5) ds - half``."""
    n_samples, ds = _ray_spacing(half, step)
    return (torch.arange(n_samples, dtype=dtype, device=device) + 0.5) \
        * ds - half


class FanBeamGeometry(NamedTuple):
    """Flat-detector (equidistant) fan-beam geometry, in pixel units.

    - ``source_dist``: source-to-isocenter distance (D_so).
    - ``det_dist``: isocenter-to-detector distance (D_od); the detector line
      is perpendicular to the central ray.
    - ``det_spacing``: detector cell pitch.  Defaults (``None``) to the
      magnification ``(D_so + D_od) / D_so`` so n_det = N cells cover the
      magnified object, converging to unit pitch in the parallel limit.
    - ``step``: integration step along each ray (default 1 pixel, the
      parallel projector's implicit step).

    As ``source_dist -> inf`` the fan opens to parallel beam.
    """
    source_dist: float
    det_dist: float = 0.0
    det_spacing: Optional[float] = None
    step: float = 1.0

    @property
    def magnification(self) -> float:
        return (self.source_dist + self.det_dist) / self.source_dist

    def spacing(self) -> float:
        return self.det_spacing if self.det_spacing is not None else self.magnification


def _fan_grid(betas, N: int, n_det: int, geom: FanBeamGeometry):
    """``grid_sample`` coordinates of every sample of every fan ray,
    ``(G, B * n_det, n_samples, 2)`` for ``(G, B)`` angles: the line from
    the point source at angle beta to each flat-detector cell, sampled on
    an equispaced grid centred at the ray's closest approach to the
    isocentre and covering the ball ``|P| <= 0.75 N`` (the image fits
    inside)."""
    dtype, device = betas.dtype, betas.device
    c = (N - 1) / 2.0
    u_axis = (torch.arange(n_det, dtype=dtype, device=device)
              - (n_det - 1) / 2.0) * geom.spacing()
    s_axis = _ray_axis(0.75 * N, geom.step, dtype, device)
    cosb = torch.cos(betas)[..., None]                 # (G, B, 1)
    sinb = torch.sin(betas)[..., None]
    # central-ray direction v = (sinb, cosb), detector axis u = (cosb, -sinb)
    # (the parallel projector's convention at beta = theta)
    src_r, src_c = -geom.source_dist * sinb, -geom.source_dist * cosb
    det_r = geom.det_dist * sinb + u_axis * cosb       # (G, B, n_det)
    det_c = geom.det_dist * cosb - u_axis * sinb
    dr, dc = det_r - src_r, det_c - src_c
    inv_len = 1.0 / torch.sqrt(dr * dr + dc * dc)
    dr, dc = dr * inv_len, dc * inv_len                # unit ray directions
    t_star = -(src_r * dr + src_c * dc)                # closest approach to O
    t = t_star[..., None] + s_axis                     # (G, B, n_det, S)
    rows = (c + src_r)[..., None] + t * dr[..., None]
    cols = (c + src_c)[..., None] + t * dc[..., None]
    return _grid((cols, rows), (N, N)).reshape(betas.shape[0], -1,
                                               len(s_axis), 2)


def _fan_budget(vol_shape, n_det: int, geom, itemsize: int):
    """Bytes of samples per angle of a fan sweep: the JAX package's count,
    on ``ceil(1.5 N / step)`` samples a ray."""
    Nz, M, N = vol_shape[0], vol_shape[1], vol_shape[-1]
    return Nz * M * n_det * int(np.ceil(1.5 * N / geom.step)) * itemsize


def radon_fan(vol, angles, geom: FanBeamGeometry,
              n_det: Optional[int] = None,
              angle_batch: Optional[int] = None, device=None):
    """Fan-beam forward projection of a ``(Nz, M, N, N)`` volume (the beam
    fans in-plane; z decomposes exactly as in parallel geometry).
    ``angles`` is ``(n_angles,)`` shared or ``(M, n_angles)`` per-frame;
    returns ``(Nz, M, n_angles, n_det)``: each ray's line integral, bilinear
    samples ``ds`` apart summed times ``ds`` (linear in the volume).
    ``angle_batch`` bounds the in-flight samples as in :func:`radon`."""
    vol = on_device(vol, device)
    angles = _as_angles(angles, vol)
    _check_geometry(vol.shape, angles)
    N = vol.shape[-1]
    n_det = n_det or N
    _, ds = _ray_spacing(0.75 * N, geom.step)
    sino = _sweep(vol, angles, lambda th: _fan_grid(th, N, n_det, geom),
                  n_det, _fan_budget(vol.shape, n_det, geom,
                                     vol.element_size()), angle_batch)
    return sino * ds


def _radon_fan_adjoint(sino, angles, geom, vol_shape,
                       angle_batch: Optional[int] = None):
    """The exact transpose of :func:`radon_fan` at ``vol_shape``
    (:func:`_sweep_adjoint` on the fan's samples)."""
    vol_shape = tuple(vol_shape)
    angles = _as_angles(angles, sino)
    _check_geometry(vol_shape, angles)
    N, n_det = vol_shape[-1], sino.shape[-1]
    n_samples, ds = _ray_spacing(0.75 * N, geom.step)
    return _sweep_adjoint(sino * ds, angles, vol_shape,
                          lambda th: _fan_grid(th, N, n_det, geom),
                          n_samples, _fan_budget(vol_shape, n_det, geom,
                                                 sino.element_size()),
                          angle_batch)


def make_fan_projector(vol_shape, angles, geom: FanBeamGeometry,
                       n_det: Optional[int] = None, dtype=torch.float32,
                       angle_batch: Optional[int] = None):
    """``(A, A_T)`` for a fixed fan-beam geometry; ``A_T`` is the exact
    transpose (:func:`_radon_fan_adjoint`), the same adjointness contract
    as :func:`make_projector`.  Both compute in ``dtype`` on their input's
    device."""
    vol_shape = tuple(int(n) for n in vol_shape)
    n_det = n_det or vol_shape[-1]

    def A(x):
        return radon_fan(on_device(x).to(dtype), angles, geom, n_det=n_det,
                         angle_batch=angle_batch)

    def A_T(y):
        return _radon_fan_adjoint(on_device(y).to(dtype), angles, geom,
                                  vol_shape, angle_batch=angle_batch)

    return _differentiable_pair(A, A_T)


class ConeBeamGeometry(NamedTuple):
    """Circular-trajectory flat-panel cone-beam geometry, in pixel units.

    The source orbits in the volume's central (z) plane; the flat detector
    is perpendicular to the central ray with axes ``u`` (in-plane, like the
    fan detector) and ``v`` (parallel to z).  Rays diverge in BOTH u and v,
    so unlike parallel/fan geometry the z axis no longer decomposes — the
    sinogram drops the leading Nz axis and is laid out
    ``(M, n_angles, n_det_v, n_det_u)``.

    - ``source_dist``: source-to-isocenter distance (D_so).
    - ``det_dist``: isocenter-to-detector distance (D_od).
    - ``det_spacing_u`` / ``det_spacing_v``: detector pitch per axis;
      ``None`` defaults to the magnification ``(D_so + D_od) / D_so`` so
      ``n_det_u = N`` / ``n_det_v = Nz`` cells cover the magnified object.
    - ``step``: integration step along each ray (pixels).

    As ``source_dist -> inf`` the cone closes to parallel beam and detector
    row ``v`` reads slice ``z = v``.
    """
    source_dist: float
    det_dist: float = 0.0
    det_spacing_u: Optional[float] = None
    det_spacing_v: Optional[float] = None
    step: float = 1.0

    @property
    def magnification(self) -> float:
        return (self.source_dist + self.det_dist) / self.source_dist

    def spacing_u(self) -> float:
        return (self.det_spacing_u if self.det_spacing_u is not None
                else self.magnification)

    def spacing_v(self) -> float:
        return (self.det_spacing_v if self.det_spacing_v is not None
                else self.magnification)


def _cone_grid(betas, Nz: int, N: int, n_det_v: int, n_det_u: int,
               geom: ConeBeamGeometry):
    """``grid_sample`` coordinates of every sample of every cone ray,
    ``(G, B * n_det_v, n_det_u, n_samples, 3)`` in (x = column, y = row,
    z) order for ``(G, B)`` angles: the line from the point source at orbit
    angle beta to each detector cell (v, u), sampled on an equispaced grid
    centred at the ray's closest approach to the isocentre and covering
    ``|P| <= 0.75 max(N, Nz)``."""
    dtype, device = betas.dtype, betas.device
    cz, c = (Nz - 1) / 2.0, (N - 1) / 2.0
    u_axis = (torch.arange(n_det_u, dtype=dtype, device=device)
              - (n_det_u - 1) / 2.0) * geom.spacing_u()
    v_axis = (torch.arange(n_det_v, dtype=dtype, device=device)
              - (n_det_v - 1) / 2.0) * geom.spacing_v()
    s_axis = _ray_axis(0.75 * max(N, Nz), geom.step, dtype, device)
    U, V = u_axis[None, :], v_axis[:, None]            # (n_det_v, n_det_u)
    cosb = torch.cos(betas)[..., None, None]           # (G, B, 1, 1)
    sinb = torch.sin(betas)[..., None, None]
    # (z, r, c) frame: source in the central z plane, the fan projector's
    # in-plane convention (central ray (sinb, cosb))
    src_r, src_c = -geom.source_dist * sinb, -geom.source_dist * cosb
    det_r = geom.det_dist * sinb + U * cosb            # (G, B, V, U)
    det_c = geom.det_dist * cosb - U * sinb
    dz, dr, dc = V, det_r - src_r, det_c - src_c
    inv_len = 1.0 / torch.sqrt(dz * dz + dr * dr + dc * dc)
    dz, dr, dc = dz * inv_len, dr * inv_len, dc * inv_len
    t_star = -(src_r * dr + src_c * dc)                # closest approach to O
    t = t_star[..., None] + s_axis                     # (G, B, V, U, S)
    zs = cz + t * dz[..., None]
    rows = (c + src_r)[..., None] + t * dr[..., None]
    cols = (c + src_c)[..., None] + t * dc[..., None]
    grid = _grid((cols, rows, zs), (N, N, max(Nz, 2)))
    return grid.reshape(betas.shape[0], -1, n_det_u, len(s_axis), 3)


def _cone_setup(vol_shape, angles, geom, n_det_v, n_det_u, itemsize: int):
    """The detector's dimensions, the ray sampling's ``ds`` and the bytes of
    samples per angle of a cone sweep (the JAX package's count, on
    ``ceil(1.5 max(N, Nz) / step)`` samples a ray)."""
    _check_geometry(vol_shape, angles)
    Nz, M, N = vol_shape[0], vol_shape[1], vol_shape[-1]
    n_det_v, n_det_u = n_det_v or Nz, n_det_u or N
    n_samples, ds = _ray_spacing(0.75 * max(N, Nz), geom.step)
    per_angle = (M * n_det_v * n_det_u
                 * int(np.ceil(1.5 * max(N, Nz) / geom.step)) * itemsize)
    return n_det_v, n_det_u, n_samples, ds, per_angle


def radon_cone(vol, angles, geom: ConeBeamGeometry,
               n_det_v: Optional[int] = None, n_det_u: Optional[int] = None,
               angle_batch: Optional[int] = None, device=None):
    """Cone-beam forward projection of a ``(Nz, M, N, N)`` volume; returns
    ``(M, n_angles, n_det_v, n_det_u)`` (no Nz axis — the cone couples z):
    each ray's line integral, trilinear samples ``ds`` apart summed times
    ``ds`` (linear in the volume).  ``angles`` is ``(n_angles,)`` shared or
    ``(M, n_angles)`` per-frame; ``angle_batch`` bounds the in-flight
    samples as in :func:`radon`."""
    vol = on_device(vol, device)
    angles = _as_angles(angles, vol)
    Nz, M, N = vol.shape[0], vol.shape[1], vol.shape[-1]
    n_det_v, n_det_u, _, ds, per_angle = _cone_setup(
        vol.shape, angles, geom, n_det_v, n_det_u, vol.element_size())
    per_frame = angles.ndim == 2
    # frames that share their angles are channels of one batch entry
    frames = vol.transpose(0, 1)                       # (M, Nz, N, N)
    frames = _two_at_least(frames[:, None] if per_frame else frames[None], 3)
    thetas = angles if per_frame else angles[None]
    out = []
    for a, b in _angle_chunks(angles.shape[-1], per_angle, angle_batch):
        grid = _cone_grid(thetas[:, a:b], Nz, N, n_det_v, n_det_u, geom)
        samples = torch.ops.aten.grid_sampler_3d(frames, grid, **_SAMPLER)
        out.append(samples.sum(dim=-1).reshape(M, b - a, n_det_v, n_det_u))
    return torch.cat(out, dim=1) * ds


def _radon_cone_adjoint(sino, angles, geom, vol_shape,
                        angle_batch: Optional[int] = None):
    """The exact transpose of :func:`radon_cone` at ``vol_shape``: every
    sinogram value scattered along its ray with the trilinear weights the
    forward projection sampled with (the 3-D sampler's transpose; atomic
    adds on a CUDA device, as :func:`_sweep_adjoint`)."""
    vol_shape = tuple(vol_shape)
    angles = _as_angles(angles, sino)
    Nz, M, N = vol_shape[0], vol_shape[1], vol_shape[-1]
    n_det_v, n_det_u = sino.shape[2], sino.shape[3]
    _, _, n_samples, ds, per_angle = _cone_setup(
        vol_shape, angles, geom, n_det_v, n_det_u, sino.element_size())
    per_frame = angles.ndim == 2
    y = sino * ds
    y = y[:, None] if per_frame else y[None]           # (G, C, A, V, U)
    thetas = angles if per_frame else angles[None]
    acc = torch.zeros(y.shape[:2] + (max(Nz, 2), N, N), dtype=sino.dtype,
                      device=sino.device)
    for a, b in _angle_chunks(angles.shape[-1], per_angle, angle_batch):
        grid = _cone_grid(thetas[:, a:b], Nz, N, n_det_v, n_det_u, geom)
        g = y[:, :, a:b].reshape(y.shape[0], y.shape[1], -1, n_det_u, 1)
        part, _ = torch.ops.aten.grid_sampler_3d_backward(
            g.expand(-1, -1, -1, -1, n_samples), acc, grid,
            output_mask=(True, False), **_SAMPLER)
        acc += part
    return acc[:, :, :Nz].reshape(M, Nz, N, N).transpose(0, 1).contiguous()


def make_cone_projector(vol_shape, angles, geom: ConeBeamGeometry,
                        n_det_v: Optional[int] = None,
                        n_det_u: Optional[int] = None, dtype=torch.float32,
                        angle_batch: Optional[int] = None):
    """``(A, A_T)`` for a fixed cone-beam geometry; ``A_T`` is the exact
    transpose (:func:`_radon_cone_adjoint`), the same adjointness contract
    as :func:`make_projector`.  Both compute in ``dtype`` on their input's
    device."""
    vol_shape = tuple(int(n) for n in vol_shape)

    def A(x):
        return radon_cone(on_device(x).to(dtype), angles, geom,
                          n_det_v=n_det_v, n_det_u=n_det_u,
                          angle_batch=angle_batch)

    def A_T(y):
        return _radon_cone_adjoint(on_device(y).to(dtype), angles, geom,
                                   vol_shape, angle_batch=angle_batch)

    return _differentiable_pair(A, A_T)


def fdk(sino, angles, geom: ConeBeamGeometry, vol_shape,
        angle_batch: Optional[int] = None, filter_name: str = "ramp",
        method: str = "auto", device=None):
    """Feldkamp-Davis-Kress reconstruction of a cone-beam sinogram
    ``(M, n_angles, n_det_v, n_det_u)``: the classical analytic cone-beam
    method (Feldkamp et al. 1984): cosine-weight each projection,
    bandlimited Ram-Lak filter along ``u``, then distance-weighted
    backprojection ``sum_beta (D_so / U(x, beta))^2 p_filtered``.  Exact in
    the source plane, approximate off-plane (the usual FDK property).
    Returns ``(Nz, M, N, N)``.

    The backprojection weight ``pi/(2 n_angles)`` (with the Ram-Lak
    response normalized as in :func:`fbp`) is angular-coverage-independent
    (each unique line direction is covered ``range/pi`` times, which
    cancels the quadrature spacing), but cone-beam DATA completeness wants
    the usual full-circle orbit.  Use directly for well-sampled data, or
    as ``x_init`` for :func:`cp_reconstruct` with the same geometry.
    ``angles`` may be shared ``(n_angles,)`` or per-frame ``(M,
    n_angles)``; ``filter_name`` as in :func:`fbp`.

    ``method``: ``'gather'`` interpolates each filtered projection
    bilinearly at every voxel's detector position, ``angle_batch`` angles
    at a time (default: ~512 MB of samples in flight); ``'spectral'`` is
    the gather-free rebinning P-FDK (:func:`.ct_spectral.fdk_spectral`:
    de-obliquity weight, cone-to-parallel rebinning matmuls, the spectral
    parallel FBP per slice); ``'auto'`` as :func:`_resolve_method` says for
    the cone.

    A cone sinogram grid cut along t (:func:`cone_sinogram_sharding`) is
    reconstructed shard by shard, each frame on its own: a volume grid on
    the same mesh."""
    from ..parallel.mesh import is_grid

    if is_grid(sino):
        return _per_column(sino, angles, vol_shape, geom, device,
                           lambda part, ang, local: fdk(
                               part, ang, geom, local,
                               angle_batch=angle_batch,
                               filter_name=filter_name, method=method))
    sino = on_device(sino, device)
    if _resolve_method(method, "cone", sino.device) == "spectral":
        return ct_spectral.fdk_spectral(sino, angles, geom, vol_shape,
                                        filter_name=filter_name)
    dt, dev = sino.dtype, sino.device
    angles = _as_angles(angles, sino)
    M, A, n_det_v, n_det_u = sino.shape
    Nz, N = vol_shape[0], vol_shape[-1]
    cz, c = (Nz - 1) / 2.0, (N - 1) / 2.0
    D_so = geom.source_dist
    mag = geom.magnification
    pu, pv = geom.spacing_u(), geom.spacing_v()

    # cosine pre-weight in isocenter-scaled detector coordinates
    u_iso = ((np.arange(n_det_u) - (n_det_u - 1) / 2.0) * pu / mag)
    v_iso = ((np.arange(n_det_v) - (n_det_v - 1) / 2.0) * pv / mag)
    Vw, Uw = np.meshgrid(v_iso, u_iso, indexing="ij")
    w = torch.as_tensor(D_so / np.sqrt(D_so ** 2 + Uw ** 2 + Vw ** 2),
                        device=dev).to(dt)
    H, size = _fourier_ramp(n_det_u, filter_name, dt, dev)
    filtered = _filter_projections(sino * w, H, size, n_det_u)

    zc = torch.arange(Nz, dtype=dt, device=dev) - cz
    rc = torch.arange(N, dtype=dt, device=dev) - c
    R, C2 = rc[:, None], rc[None, :]
    per_frame = angles.ndim == 2
    thetas = angles if per_frame else angles[None]     # (G, A)
    G, C = thetas.shape[0], M // thetas.shape[0]
    back = torch.zeros((G, C, Nz, N * N), dtype=dt, device=dev)
    for a, b in _angle_chunks(A, M * Nz * N * N * sino.element_size(),
                              angle_batch):
        cosb = torch.cos(thetas[:, a:b])[..., None, None]  # (G, B, 1, 1)
        sinb = torch.sin(thetas[:, a:b])[..., None, None]
        U_dist = D_so + R * sinb + C2 * cosb               # (G, B, N, N)
        t_u = R * cosb - C2 * sinb
        # detector-plane magnification for this voxel column
        m_det = (D_so + geom.det_dist) / U_dist
        u_idx = t_u * m_det / pu + (n_det_u - 1) / 2.0
        v_idx = (zc[:, None, None] * m_det[:, :, None] / pv
                 + (n_det_v - 1) / 2.0)                    # (G, B, Nz, N, N)
        grid = _grid((u_idx[:, :, None].expand_as(v_idx), v_idx),
                     (max(n_det_u, 2), max(n_det_v, 2)))
        # the frames that share their angles are channels of one batch
        # entry: (G * B, C, V, U)
        p = filtered[:, a:b].reshape(G, C, b - a, n_det_v, n_det_u)
        p = _two_at_least(p.transpose(1, 2).reshape(
            G * (b - a), C, n_det_v, n_det_u), 2)
        vals = torch.ops.aten.grid_sampler_2d(
            p, grid.reshape(G * (b - a), Nz, N * N, 2), **_SAMPLER)
        weight = torch.square(D_so / U_dist).reshape(G, b - a, 1, 1, N * N)
        back += (vals.reshape(G, b - a, C, Nz, N * N) * weight).sum(dim=1)
    back = back.reshape(M, Nz, N, N) * (np.pi / (2 * A))
    return back.transpose(0, 1).contiguous()               # (Nz, M, N, N)


def _per_column(grid, angles, vol_shape, geom, device, fn):
    """``fn(shard, column angles, local volume shape)`` on every shard of a
    sinogram grid: a grid of its results (``ValueError`` for a ``device``
    naming another than the shards', or a cone sinogram cut along z)."""
    from ..parallel.entry import layout_of

    layout_of(grid, device)
    _, _, local = _grid_layout(grid, tuple(int(n) for n in vol_shape), geom)
    ang_np = _host_angles(angles)
    return [None if row is None else
            [fn(part, _column_angles(ang_np, it, local[1]), local)
             for it, part in enumerate(row)] for row in grid]


class SARTResult(NamedTuple):
    x: torch.Tensor          # reconstructed volume (Nz, M, N, N)
    residual: torch.Tensor   # per-epoch ||A x - b|| history (n_iter,)


def sart(
    sino,
    angles,
    vol_shape,
    n_iter: int = 10,
    n_subsets: int = 8,
    relax: float = 1.0,
    nonneg: bool = True,
    x_init=None,
    project_fn=None,
    n_det: Optional[int] = None,
    angle_axis: int = 2,
    method: str = "auto",
    precision: Optional[str] = None,
    geom=None,
    device=None,
):
    """Ordered-subsets SART reconstruction (Andersen & Kak 1984; OS splitting
    a la OSEM): each sub-iteration corrects x with one angle subset,

        ``x <- x + relax * A_s^T((b_s - A_s x) / (A_s 1)) / (A_s^T 1)``,

    cycling subsets with stride-interleaved angle ordering (subset k takes
    ``angles[k::n_subsets]``, maximizing angular separation per subset).
    One epoch touches every projection once but updates x ``n_subsets``
    times: typically ~n_subsets-fold fewer epochs than SIRT for the same
    residual.  Rows and columns whose sums are at most ``1e-6`` of their
    largest (rays that miss the volume, voxels no ray of the subset
    reaches) are left out, relative to the live scale, never by an
    absolute floor.

    Unregularized: use directly for well-sampled data, or as ``x_init`` for
    :func:`cp_reconstruct` (TV-regularized) on sparse/dynamic data.

    ``angles`` is ``(n_angles,)`` shared or ``(M, n_angles)`` per-frame;
    ``n_angles`` must be divisible by ``n_subsets``.  ``geom`` selects the
    beam geometry like :func:`cp_reconstruct`: ``None`` = parallel,
    :class:`FanBeamGeometry` = fan (sinogram ``(Nz, M, n_angles,
    n_det)``), :class:`ConeBeamGeometry` = cone (sinogram ``(M,
    n_angles, n_det_v, n_det_u)``; ``angle_axis`` is set to 1
    automatically, the detector's dimensions come from the sinogram); each
    uses its projector's exact transpose.  ``project_fn(vol,
    angles_subset) -> sino`` overrides the projector entirely (its
    transpose is then ``torch.func.vjp`` of it, and ``angle_axis`` is the
    caller's to set for other layouts).  ``method`` picks the projector of
    each geometry (:func:`_resolve_method`); on the spectral path every
    subset gets its own memoized pair, its angles taken from the host values
    in float64 (a float32 round trip would break the fan grid's phase
    alignment), and the cone normalizes with the signed sums only where they
    are well conditioned (:func:`_sart_cone_sums`).  ``precision`` as in
    :func:`make_projector`.  Runs on the sinogram's device (a numpy
    sinogram on the CUDA device unless ``device`` names another);
    ``residual`` stays there.

    A sinogram grid (:func:`sinogram_sharding`; the cone's cut along t) is
    reconstructed shard by shard: each subset's projector per column of
    shards with its angles, the dead-row and dead-column tolerances from
    the whole grid's largest sums, the cone's conditioning test on the
    whole grid's smallest and largest, the residual a sum over shards.  A
    caller's ``project_fn`` is then applied per shard, with the angles of
    the shard's column: the premise of :func:`sinogram_sharding`, that the
    projector decouples z and t; ``x`` comes back as a grid.
    """
    from ..ops.space import TENSOR
    from ..parallel.mesh import first_shard, is_grid

    _resolve_method(method)
    grid = is_grid(sino)
    vol_shape = tuple(int(n) for n in vol_shape)
    if grid:
        from ..parallel.entry import layout_of
        from ..parallel.halo import grid_space

        layout_of(sino, device)
        mesh, sharding, local = _grid_layout(sino, vol_shape, geom)
        nt = mesh.shape["t"]
        space = grid_space(mesh, None, vol_shape, nt > 1)
        like = first_shard(sino)
    else:
        sino = on_device(sino, device)
        local, nt, space, like = vol_shape, 1, TENSOR, sino
    dtype = like.dtype
    ang_all = _host_angles(angles).astype(np.float64)
    A = ang_all.shape[-1]
    if A % n_subsets:
        raise ValueError(
            f"n_angles={A} not divisible by n_subsets={n_subsets}; choose a "
            f"divisor (e.g. {[k for k in range(1, min(A, 17)) if A % k == 0]})"
        )
    n_det = n_det or vol_shape[-1]
    # a caller's projector is used whatever geom says
    kind = _geometry_name(geom) if project_fn is None else None
    spectral = (project_fn is None and _resolve_method(
        method, kind, like.device) == "spectral")
    if project_fn is None and kind == "cone":
        angle_axis = 1
    det = tuple(like.shape[2:]) if kind == "cone" else (like.shape[-1],)

    def column_pairs(it):
        """``pair_of(k)`` of the column ``it``: the subset ``k``'s pair on
        a shard of that column (the whole volume's off a grid)."""
        ang_host = _column_angles(ang_all, it, local[1])
        angles = _as_angles(ang_host, like)
        zeros = torch.zeros(local, dtype=dtype, device=like.device)
        if project_fn is not None:
            def pair_of(k):
                a = angles[..., torch.as_tensor(k, device=like.device)]

                def P(x):
                    return project_fn(x, a)

                _, vjp = torch.func.vjp(P, zeros)
                return P, lambda y: vjp(y)[0]

            return pair_of, angles

        def pair_of(k):
            if spectral and kind == "parallel":
                return make_projector(local, ang_host[..., k],
                                      n_det=n_det, dtype=dtype,
                                      method="spectral", precision=precision)
            if spectral:
                return _geometry_pair(geom, local, ang_host[..., k],
                                      dtype, "spectral", precision, det)
            a = angles[..., torch.as_tensor(k, device=like.device)]
            if kind == "cone":
                return make_cone_projector(local, a, geom,
                                           n_det_v=det[0], n_det_u=det[1],
                                           dtype=dtype)
            if kind == "fan":
                return make_fan_projector(local, a, geom, n_det=det[0],
                                          dtype=dtype)
            return _parallel_pair(local, a, n_det, dtype)

        return pair_of, angles

    columns = [column_pairs(it) for it in range(nt)]

    def on_field(fns):
        """One function per column as a map of ``space``'s fields."""
        if not grid:
            return fns[0]
        return lambda f: [None if row is None else
                          [fns[it](cell) for it, cell in enumerate(row)]
                          for row in f]

    # stride-interleaved subsets along the angle axis
    idx = np.arange(A).reshape(-1, n_subsets).T          # (S, A//S)
    col_pairs = [[pair_of(k) for k in idx] for pair_of, _ in columns]
    pairs = [(on_field([c[s][0] for c in col_pairs]),
              on_field([c[s][1] for c in col_pairs]))
             for s in range(len(idx))]
    ones_vol = space.place(torch.ones(vol_shape, dtype=dtype)) if grid \
        else torch.ones(vol_shape, dtype=dtype, device=like.device)
    if spectral and kind == "cone":
        sums = _sart_cone_sums(pairs, col_pairs, idx, ang_all, local, det,
                               dtype, precision, geom, like.device, space,
                               ones_vol)
    else:
        sums = [(row, P_T(space.map(torch.ones_like, row)))
                for P, P_T in pairs for row in (P(ones_vol),)]
    subsets = []
    for k, (P, P_T), (row, col) in zip(idx, pairs, sums):
        # per-subset normalizers: row sums A_s 1 (sino space), column sums
        # A_s^T 1; rows and columns at most 1e-6 of the largest are dead
        tol_r = 1e-6 * space.max(torch.max, row)
        tol_c = 1e-6 * space.max(torch.max, col)
        k_t = torch.as_tensor(k, device=like.device)
        subsets.append((
            P, P_T, space.map(lambda b: torch.index_select(
                b, angle_axis, k_t), sino),
            space.map(lambda r: r > tol_r, row),
            space.map(lambda r: torch.maximum(r, tol_r), row),
            space.map(lambda c: c > tol_c, col),
            space.map(lambda c: torch.maximum(c, tol_c), col)))
    if project_fn is None:
        full = on_field([c[0](np.arange(A))[0] for c in columns])
    else:
        full = on_field([lambda x, a=a: project_fn(x, a)
                         for _, a in columns])

    if x_init is None:
        x = space.map(torch.zeros_like, ones_vol)
    elif grid:
        x = space.map(lambda t: t.to(dtype), space.place(x_init))
    else:
        x = torch.as_tensor(x_init, device=like.device).to(dtype)
    residuals = []
    for _ in range(n_iter):
        for P, P_T, b_s, row_live, row, col_live, col in subsets:
            r = space.map(lambda live, b, p, w: torch.where(
                live, (b - p) / w, 0.0), row_live, b_s, P(x), row)
            upd = space.map(lambda live, u, w: torch.where(
                live, u / w, 0.0), col_live, P_T(r), col)
            x = space.map(lambda a, u: a + relax * u, x, upd)
            if nonneg:
                x = space.map(lambda a: torch.clamp_min(a, 0.0), x)
        residuals.append(torch.sqrt(space.sum(
            lambda p, b: torch.sum(torch.square(p - b)), full(x), sino)))
    return SARTResult(x=x, residual=torch.stack(residuals))


_SART_SUMS_CACHE: dict = {}


def _sart_cone_sums(pairs, col_pairs, idx, ang_np, vol_shape, det_shape,
                    dtype, precision, geom, device, space, ones):
    """The spectral cone SART's normalizers, health-gated: every subset's
    signed row and column sums ``A_s(1)`` / ``A_s^T(1)`` where all of them
    are well conditioned (min above 1e-2 of max, over the whole grid of
    shards), else the abs-factor surrogate's sums
    (:func:`.ct_spectral.cone_spectral_precond_sums`, per column, floored
    at 1e-6 of the whole grid's largest) for every subset: at wide cone
    angles the signed sums go small or negative on oblique rays, and
    dividing by them makes the sweep unstable.  Memoized per (pairs,
    shapes, dtype, device), at most 8; an entry pins its pairs, so their
    ids stay unique while it lives."""
    from ..parallel.mesh import is_grid

    key = (tuple(id(p[0]) for c in col_pairs for p in c), tuple(vol_shape),
           det_shape, dtype, torch.device(device))
    hit = _SART_SUMS_CACHE.get(key)
    if hit is not None:
        return hit[0]
    sums = [(row, P_T(space.map(torch.ones_like, row)))
            for P, P_T in pairs for row in (P(ones),)]
    healthy = all(
        float(space.min(torch.min, row))
        > 1e-2 * float(space.max(torch.max, row))
        and float(space.min(torch.min, col))
        > 1e-2 * float(space.max(torch.max, col))
        for row, col in sums)
    if not healthy:
        sums = []
        for k in idx:
            raw = [ct_spectral.cone_spectral_precond_sums(
                vol_shape, _column_angles(ang_np, it, vol_shape[1])[..., k],
                geom, n_det_v=det_shape[0], n_det_u=det_shape[1],
                dtype=dtype, precision=precision, device=device,
                floor=False) for it in range(len(col_pairs))]
            sums.append(tuple(_floored(space, [[r[j] for r in raw]]
                                       if is_grid(ones) else raw[0][j])
                              for j in range(2)))
    if len(_SART_SUMS_CACHE) >= 8:
        _SART_SUMS_CACHE.pop(next(iter(_SART_SUMS_CACHE)))
    _SART_SUMS_CACHE[key] = (sums, col_pairs)
    return sums


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
    interpolates each pixel's detector coordinate; ``'spectral'``
    backprojects through the exact transpose of the gather-free spectral
    projector (FFTs and matmuls; its memoized pair keeps its tables);
    ``'auto'`` as :func:`_resolve_method` says for the parallel beam.

    A sinogram grid (:func:`sinogram_sharding`) is reconstructed shard by
    shard (the parallel beam decouples z and t): a volume grid on the same
    mesh."""
    from ..parallel.mesh import grid_mesh, is_grid

    if is_grid(sino):
        Nz, M, _, n_det = grid_mesh(sino).shape
        N = n_out or n_det
        return _per_column(sino, angles, (Nz, M, N, N), None, device,
                           lambda part, ang, local: fbp(
                               part, ang, n_out=n_out,
                               filter_name=filter_name, method=method))
    sino = on_device(sino, device)
    Nz, M, n_angles, n_det = sino.shape
    N = n_out or n_det
    if _resolve_method(method, "parallel", sino.device) == "spectral":
        H, size = _fourier_ramp(n_det, filter_name, sino.dtype, sino.device)
        filtered = _filter_projections(sino, H, size, n_det)
        _, A_T = make_projector((Nz, M, N, N), _host_angles(angles),
                                n_det=n_det, dtype=sino.dtype,
                                method="spectral")
        return A_T(filtered) * (np.pi / (2 * n_angles))
    angles = _as_angles(angles, sino)
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
