"""Streaming TGV-2 step: two CUDA kernels per Chambolle-Pock iteration, for
the COUPLED modes (``axes='3d'``/``'4d'``), for resumed and sampled-loss 2d
solves, and for 2d slices the whole-solve kernel (kernels/tgv_resident.py)
does not take.  Replaces ``pytv4d_tpu/kernels/tgv_stream.py::
make_tgv_stream_step`` (its two ``pallas_call``s).

- pass PQ, :func:`tgv_pq` (kernel ``tgv_pq_kernel`` in
  ``csrc/tgv_stream.cu``): reads xb, wb and the duals; computes every D
  channel of xb and every E channel of wb in registers and writes the
  projected duals p, q IN PLACE.
- pass XW, :func:`tgv_xw` (kernel ``tgv_xw_kernel``): reads the new p, q at
  the voxel and at the neighbours their adjoints scatter from, x, w, x0;
  updates x, w IN PLACE and writes the extrapolated xb, wb.

Both are bound by HBM bytes (``utils.profiling.tgv_traffic_model``: 28 / 44
/ 63 planes per iteration for 2d / 3d / 4d).  One thread per voxel gates
its own global index against the one-sided zero boundary, so the TPU
kernel's row tiles, 8-row seam blocks and clamped z-shifted operands are
gone, and with them its VMEM sizing (``choose_tile_rows``, ``_vmem_limit``,
``_workset``) and its ``Nc % 128`` / ``Nr % 8`` conditions:
:func:`stream_fits` states the CUDA kernels' own limits.

Layout: the TPU kernel kept w/wb/p/q as ``(Nz, M, n, Nr, Nc)`` so that the
time axis sat inside a VMEM tile.  With one thread per voxel that reason is
gone: every array here keeps the public layout, x-like ``(Nz, M, Nr, Nc)``,
w-like ``(Nz, n, M, Nr, Nc)`` and q ``(Nz, n(n+1)/2, M, Nr, Nc)``, and no
conversion exists.  Storage is float32 or bfloat16 (all seven arrays
alike); compute is float32.

The objective, :func:`tgv_stream_objective` (kernel ``tgv_obj_kernel``;
it replaces no TPU kernel), is a third launch for each loss the solve asks
for: it reads x, x0 and w (2 + n planes), computes each voxel's term of
``1/2 |x - x0|^2 + a1 N(D x - w) + a0 N(E w)`` in registers and writes one
float32 partial a block, which one ``torch.sum`` adds up.  So the per-
iteration loss streams too (``solvers.tgv._select_path``).

Each wrapper takes its plain PyTorch version (:func:`tgv_pq_plain`,
:func:`tgv_xw_plain`; for the objective ``solvers.tgv.tgv_objective``
itself) for tensors on the CPU, which is how the CPU tests run the fused
path.  For CUDA tensors it launches the kernel or raises.
``utils.profiling.counters()`` counts their launches under
``launch.B6.pq``, ``launch.B6.xw`` and ``launch.B6.obj``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..solvers.tgv import (
    MODE_AXES,
    TGV_FIELDS,
    _d_fwd_axes,
    _d_fwd_T_axes,
    _sym_grad_axes,
    _sym_grad_T_axes,
    _tgv_dual_prox,
    tgv_objective,
    tgv_steps,
)
from ..ops.space import TENSOR
from ..utils.profiling import count
from .fused import (
    _ENTRY_POINTS,
    _NORM,
    MAX_PLANE_VOXELS,
    MAX_PLANES,
    STORAGE_DTYPES,
    _check_tensors,
    _launch,
)


class TGVParams(ctypes.Structure):
    """Mirror of ``struct TgvParams`` in ``csrc/tgv.cuh``."""
    _fields_ = [
        ("Nz", ctypes.c_int), ("M", ctypes.c_int), ("Nr", ctypes.c_int),
        ("Nc", ctypes.c_int), ("norm", ctypes.c_int),
        ("sigma", ctypes.c_float), ("tau", ctypes.c_float),
        ("one_plus_tau", ctypes.c_float),
        ("a1", ctypes.c_float), ("a0", ctypes.c_float),
        ("shr1", ctypes.c_float), ("shr0", ctypes.c_float),
        ("delta", ctypes.c_float),
    ]


# launch function: (int flags, tensor pointers)
_ENTRY_POINTS["tgv_stream"] = ("tgv", TGVParams, {
    "tgv_pq_launch": (2, 4), "tgv_xw_launch": (2, 7),
    "tgv_obj_launch": (2, 4)})


@functools.lru_cache(maxsize=64)
def tgv_params(shape, mode, alpha1, alpha0, sigma_tau_split, norm,
               huber_delta) -> TGVParams:
    """The TGV kernels' launch parameters: the step sizes of ``mode`` and
    the Huber shrink factors ``1 / (1 + sigma delta / alpha)``."""
    if norm not in _NORM:
        raise ValueError(f"norm must be 'iso', 'aniso' or 'huber', got "
                         f"{norm!r}")
    sigma, tau = tgv_steps(mode, sigma_tau_split)
    Nz, M, Nr, Nc = shape
    return TGVParams(
        Nz=Nz, M=M, Nr=Nr, Nc=Nc, norm=_NORM[norm], sigma=sigma, tau=tau,
        one_plus_tau=1.0 + tau, a1=alpha1, a0=alpha0,
        shr1=1.0 / (1.0 + sigma * huber_delta / alpha1),
        shr0=1.0 / (1.0 + sigma * huber_delta / alpha0), delta=huber_delta)


def stream_fits(shape, mode: str, dtype=torch.float32) -> bool:
    """What the CUDA stream kernels take: a 4D volume stored as float32 or
    bfloat16, ``Nz * M`` planes within the grid's y extent and an
    ``Nr * Nc`` plane indexable by int."""
    if len(shape) != 4 or mode not in MODE_AXES or dtype not in STORAGE_DTYPES:
        return False
    Nz, M, Nr, Nc = shape
    return 0 < Nz * M <= MAX_PLANES and 0 < Nr * Nc <= MAX_PLANE_VOXELS


def _check_state(mode, x_like, w_like, q):
    """Shapes, dtypes, devices and contiguity of a pass's operands:
    ``x_like`` (name -> tensor) are (Nz, M, Nr, Nc), ``w_like`` are
    (Nz, n, M, Nr, Nc), q is (Nz, n(n+1)/2, M, Nr, Nc)."""
    if mode not in MODE_AXES:
        raise ValueError(f"mode must be '2d', '3d' or '4d', got {mode!r}")
    n = TGV_FIELDS[mode]
    (x_name, x), *rest = x_like.items()
    _check_tensors(x, **dict(rest), **w_like, q=q)
    if x.ndim != 4:
        raise ValueError(f"{x_name} must be (Nz, M, Nr, Nc), got "
                         f"{tuple(x.shape)}")
    Nz, M, Nr, Nc = x.shape
    want = dict.fromkeys(x_like, (Nz, M, Nr, Nc))
    want.update(dict.fromkeys(w_like, (Nz, n, M, Nr, Nc)))
    want["q"] = (Nz, n * (n + 1) // 2, M, Nr, Nc)
    for name, t in (*x_like.items(), *w_like.items(), ("q", q)):
        if tuple(t.shape) != want[name] or t.dtype != x.dtype:
            raise ValueError(
                f"{name} must be {want[name]} {x.dtype} for mode {mode!r}, "
                f"got {tuple(t.shape)} {t.dtype}")
    if x.is_cuda and not stream_fits(tuple(x.shape), mode, x.dtype):
        raise ValueError(
            f"shape {tuple(x.shape)} {x.dtype} is outside what the CUDA TGV "
            f"stream kernels accept (stream_fits)")


def _flags(mode, x):
    return (TGV_FIELDS[mode], int(x.dtype == torch.bfloat16))


def tgv_pq(xb, wb, p, q, *, mode, alpha1, alpha0, sigma_tau_split=1.0,
           norm="iso", huber_delta=1.0):
    """Pass PQ: ``(xb, wb, p, q) -> (p', q')``.  The duals are updated in
    place and returned:
    ``p' = proj_{alpha1}(p + sigma (D xb - wb))`` and
    ``q' = proj_{alpha0}(q + sigma E wb)``."""
    _check_state(mode, dict(xb=xb), dict(wb=wb, p=p), q)
    kw = dict(mode=mode, alpha1=alpha1, alpha0=alpha0,
              sigma_tau_split=sigma_tau_split, norm=norm,
              huber_delta=huber_delta)
    if xb.device.type == "cpu":
        return tgv_pq_plain(xb, wb, p, q, **kw)
    prm = tgv_params(tuple(xb.shape), mode, float(alpha1), float(alpha0),
                     float(sigma_tau_split), norm, float(huber_delta))
    _launch("tgv_stream", "tgv_pq_launch", xb, prm, _flags(mode, xb),
            (xb, wb, p, q))
    count("launch.B6.pq")
    return p, q


def tgv_xw(x, x0, p, w, q, xb=None, wb=None, *, mode, sigma_tau_split=1.0):
    """Pass XW: ``(x, x0, p', w, q') -> (x', xb', w', wb')``.  x and w are
    updated in place and returned; xb' and wb' are written into ``xb`` /
    ``wb`` when given (their old values are not read), else into new
    tensors:
    ``x' = (x - tau D^T p' + tau x0) / (1 + tau)``, ``xb' = 2 x' - x``,
    ``w' = w - tau (-p' + E^T q')``, ``wb' = 2 w' - w``."""
    xb = torch.empty_like(x) if xb is None else xb
    wb = torch.empty_like(w) if wb is None else wb
    _check_state(mode, dict(x=x, x0=x0, xb=xb), dict(p=p, w=w, wb=wb), q)
    if x.device.type == "cpu":
        return tgv_xw_plain(x, x0, p, w, q, xb, wb, mode=mode,
                            sigma_tau_split=sigma_tau_split)
    # the primal pass reads no projection radius or norm
    prm = tgv_params(tuple(x.shape), mode, 1.0, 1.0, float(sigma_tau_split),
                     "iso", 1.0)
    _launch("tgv_stream", "tgv_xw_launch", x, prm, _flags(mode, x),
            (x, x0, p, w, q, xb, wb))
    count("launch.B6.xw")
    return x, xb, w, wb


def tgv_stream_objective(x, w, x0, axes, alpha1, alpha0, norm="iso",
                         huber_delta=1.0, space=TENSOR):
    """The primal objective at ``(x, w)``, a float32 scalar tensor on x's
    device: ``solvers.tgv.tgv_objective``'s signature and value, computed
    by the objective kernel (one launch, then one sum of its per-block
    partials in a fixed order).  On a CPU tensor it is ``tgv_objective``
    itself; on a CUDA one ``space`` must be a tensor's."""
    if x.device.type == "cpu":
        return tgv_objective(x, w, x0, axes, alpha1, alpha0, norm,
                             huber_delta, space)
    if space is not TENSOR:
        raise ValueError("the objective kernel takes a tensor, not a grid")
    if axes not in MODE_AXES:
        raise ValueError(f"mode must be '2d', '3d' or '4d', got {axes!r}")
    _check_tensors(x, x0=x0, w=w)
    Nz, M, Nr, Nc = shape = tuple(x.shape)
    n = TGV_FIELDS[axes]
    for name, t, want in (("x0", x0, shape), ("w", w, (Nz, n, M, Nr, Nc))):
        if tuple(t.shape) != want or t.dtype != x.dtype:
            raise ValueError(f"{name} must be {want} {x.dtype} for mode "
                             f"{axes!r}, got {tuple(t.shape)} {t.dtype}")
    if not stream_fits(shape, axes, x.dtype):
        raise ValueError(
            f"shape {shape} {x.dtype} is outside what the CUDA TGV stream "
            f"kernels accept (stream_fits)")
    prm = tgv_params(shape, axes, float(alpha1), float(alpha0), 1.0, norm,
                     float(huber_delta))
    parts = _launch("tgv_stream", "tgv_obj_launch", x, prm, _flags(axes, x),
                    (x, x0, w), with_parts=True)
    count("launch.B6.obj")
    return torch.sum(parts)


def _compute_dtype(t):
    """bf16 is a storage format only: compute in float32, round at the
    store; float32 and float64 compute as they are."""
    return torch.float32 if t.dtype == torch.bfloat16 else t.dtype


def tgv_pq_plain(xb, wb, p, q, *, mode, alpha1, alpha0, sigma_tau_split=1.0,
                 norm="iso", huber_delta=1.0):
    """Plain PyTorch version of :func:`tgv_pq` (same signature, outputs and
    in-place updates), from the ``solvers.tgv`` operators."""
    ax = MODE_AXES[mode]
    sigma, _ = tgv_steps(mode, sigma_tau_split)
    ct = _compute_dtype(xb)
    xbf, wbf = xb.to(ct), wb.to(ct)
    p_new = _tgv_dual_prox(p.to(ct) + sigma * (_d_fwd_axes(xbf, ax) - wbf),
                           alpha1, norm, sigma, huber_delta)
    q_new = _tgv_dual_prox(q.to(ct) + sigma * _sym_grad_axes(wbf, ax),
                           alpha0, norm, sigma, huber_delta)
    p.copy_(p_new)
    q.copy_(q_new)
    return p, q


def tgv_xw_plain(x, x0, p, w, q, xb=None, wb=None, *, mode,
                 sigma_tau_split=1.0):
    """Plain PyTorch version of :func:`tgv_xw`."""
    ax = MODE_AXES[mode]
    _, tau = tgv_steps(mode, sigma_tau_split)
    ct = _compute_dtype(x)
    xf, wf, pf = x.to(ct), w.to(ct), p.to(ct)
    x_new = (xf - tau * _d_fwd_T_axes(pf, ax) + tau * x0.to(ct)) / (1.0 + tau)
    w_new = wf - tau * (-pf + _sym_grad_T_axes(q.to(ct), ax))
    xb = torch.empty_like(x) if xb is None else xb
    wb = torch.empty_like(w) if wb is None else wb
    xb.copy_(2.0 * x_new - xf)
    wb.copy_(2.0 * w_new - wf)
    x.copy_(x_new)
    w.copy_(w_new)
    return x, xb, w, wb


def tgv_stream_step(x, xb, w, wb, p, q, x0, *, mode, alpha1, alpha0,
                    sigma_tau_split=1.0, norm="iso", huber_delta=1.0):
    """One TGV CP iteration as the two passes; all six state arrays are
    updated IN PLACE and returned as ``(x, xb, w, wb, p, q)``."""
    p, q = tgv_pq(xb, wb, p, q, mode=mode, alpha1=alpha1, alpha0=alpha0,
                  sigma_tau_split=sigma_tau_split, norm=norm,
                  huber_delta=huber_delta)
    x, xb, w, wb = tgv_xw(x, x0, p, w, q, xb, wb, mode=mode,
                          sigma_tau_split=sigma_tau_split)
    return x, xb, w, wb, p, q
