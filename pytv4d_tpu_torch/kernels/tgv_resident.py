"""Whole-solve TGV-2 kernels: the ENTIRE Chambolle-Pock solve for
``axes='2d'`` TGV in one launch.  Replace ``pytv4d_tpu/kernels/
tgv_resident.py::make_resident_tgv_solver``.

The in-plane mode couples pixels only within a (N_row, N_col) slice, so the
(z, t) slices are independent subproblems.  The TPU kernel kept one slice's
12 planes of state in VMEM for all iterations.  Here one THREAD-BLOCK
CLUSTER works on one slice and loops over the iterations itself, with a
cluster-wide barrier between the dual pass, the primal pass and the loss of
each one.  Two kernels, chosen by the slice's shape before the launch
(:func:`tgv_resident_variant`):

- ``"onchip"`` (``tgv_onchip_kernel`` in ``csrc/tgv_onchip.cu``): the
  slice's state in the shared memory of a cluster of C blocks, C the
  smallest of 1, 2, 4, 8, 16 whose blocks hold it (:func:`onchip_band`,
  :data:`ONCHIP_SMEM_BYTES` a block, 44 bytes a pixel with the loss, 32
  without: up to 288 x 288 with the loss and 336 x 336 without).  Each
  block owns a band of rows and reads the rows either side of it from its
  neighbours' shared memory (DSMEM).  HBM sees x0 once and the final state
  once.
- ``"l2"`` (``tgv_resident_kernel`` in ``csrc/tgv_resident.cu``): larger
  slices (512 x 512, 1024 x 1024); the state in global memory, a cluster
  of :data:`CLUSTER_SIZE` blocks per slice.

Both run the streaming kernels' per-voxel arithmetic (``csrc/tgv.cuh``), so
their states are equal bit for bit.

Loss history: each block writes one partial per iteration into a
``(n_iter, blocks)`` float32 array in a fixed order (no float atomics); the
wrapper sums it over the blocks.  The objective is separable over slices.

:func:`tgv_resident_solve` takes its plain PyTorch version
(:func:`tgv_resident_plain`) for a tensor on the CPU; for a CUDA tensor it
launches the kernel its variant names or raises — a refused launch never
runs the other kernel, and it never gives way to the streaming path.
``utils.profiling.counters()`` counts its launches (one per solve) under
``launch.B7``, and those of each kernel under ``launch.B7.onchip`` and
``launch.B7.l2``.
"""

from __future__ import annotations

import ctypes

import torch

from ..solvers.tgv import _init_state, tgv_objective
from ..utils.profiling import count
from .fused import _ENTRY_POINTS, _check_tensors, _launch, _lib
from .tgv_stream import (
    TGVParams,
    tgv_params,
    tgv_pq_plain,
    tgv_xw_plain,
)

CLUSTER_SIZE = 8          # blocks per slice of the L2 kernel
MAX_SLICES = (2**31 - 1) // CLUSTER_SIZE  # the slices ride gridDim.x
# What bounds B7 (NVIDIA H100 80GB HBM3, 700.00 W; chip_smoke.py phase 14,
# PERF.md section 6).  Slices up to 288 x 288 (336 x 336 without the
# loss) take the on-chip kernel (tgv_resident_variant): instruction issue
# on 16 SMs a slice and 7 slices at once, 0.0100 ms/it at 256 x 256 with the
# loss (0.0069 without), 0.36 ms/it at 256 such slices, against the L2
# kernel's 0.025 and 0.80.  A larger slice takes the L2 kernel, on 8 of the
# 132 SMs, whose time grows with the slice: 0.43 ms/it at one 1024 x 1024
# slice with the loss, 0.34 without, against 0.084 for one iteration of
# the two streaming launches.  Without the loss the two break even between
# 450 x 450 and 590 x 590 voxels per slice.  The caps below were
# measured on the L2 kernel.  With the per-iteration loss there is no other
# kernel path, only the plain loop (6x slower at 1024 x 1024), and the
# whole solve is taken up to the largest slice it was measured at.
MAX_SLICE_VOXELS = 512 * 512
MAX_SLICE_VOXELS_WITH_LOSS = 1024 * 1024

# The on-chip kernel.  Dynamic shared memory a block may take: the H100's
# 232 448 bytes a block (227 KB), less room for the loss's warp sums.
ONCHIP_SMEM_BYTES = 232448 - 256
ONCHIP_CLUSTERS = (1, 2, 4, 8, 16)
# shared-memory planes a pixel: xb, wb x2, p x2, q x3, and x, w x2 for the
# loss (csrc/tgv_onchip.cu onchip_planes)
ONCHIP_PLANES = {False: 8, True: 11}
# the compiled (threads, pixels a thread) shapes (csrc/tgv_onchip.cu
# onchip_kernel); blocks of 1024 threads, faster than 512 in every case
# tools/torch_probe_tgv_resident.py times (PERF.md section 6), which
# keeps 512 x 8 to A/B them at 256 x 256
ONCHIP_PPT = {1024: (1, 2, 4, 8), 512: (8,)}
ONCHIP_THREADS = 1024
MAX_GRID_BLOCKS = 2**31 - 1

_ENTRY_POINTS["tgv_resident"] = ("tgvr", TGVParams, {
    "tgv_resident_launch": (3, 8)})
_ENTRY_POINTS["tgv_onchip"] = ("tgvo", TGVParams, {
    "tgvo_launch": (6, 8)})


def onchip_band(shape, compute_loss=True):
    """``(C, R)``: the smallest cluster of :data:`ONCHIP_CLUSTERS` whose
    blocks hold a ``(..., Nr, Nc)`` slice's on-chip planes in
    :data:`ONCHIP_SMEM_BYTES` each, with ``R = ceil(Nr / C)`` rows a
    block; ``None`` where no cluster holds it."""
    Nr, Nc = shape[-2:]
    per_row = Nc * ONCHIP_PLANES[bool(compute_loss)] * 4
    for C in ONCHIP_CLUSTERS:
        R = -(-Nr // C)
        if R * per_row <= ONCHIP_SMEM_BYTES:
            return C, R
    return None


def band_rows(Nr, C, R):
    """The rows ``[start, stop)`` that each of the C blocks of a cluster
    owns (``csrc/tgv_onchip.cu``): block b from ``b R``, at most R rows, an
    empty band past the slice's end."""
    return [(min(b * R, Nr), min((b + 1) * R, Nr)) for b in range(C)]


def onchip_launch_shape(shape, compute_loss=True, cluster=None,
                        threads=None):
    """``(C, R, threads, pixels a thread, shared bytes a block)`` of the
    on-chip launch for ``shape``; ``cluster`` and ``threads`` override the
    choice (``tools/torch_probe_tgv_resident.py``).  Raises ``ValueError``
    where the slice does not fit."""
    Nr, Nc = shape[-2:]
    planes = ONCHIP_PLANES[bool(compute_loss)]
    if cluster is None:
        fit = onchip_band(shape, compute_loss)
        if fit is None:
            raise ValueError(f"a {Nr} x {Nc} slice does not fit the on-chip "
                             f"TGV kernel (onchip_band)")
        cluster = fit[0]
    R = -(-Nr // cluster)
    band = R * Nc
    threads = threads or ONCHIP_THREADS
    ppt = next((k for k in ONCHIP_PPT.get(threads, ()) if k * threads >= band),
               None)
    if ppt is None or band * planes * 4 > ONCHIP_SMEM_BYTES:
        raise ValueError(f"a {Nr} x {Nc} slice does not fit {cluster} blocks "
                         f"of {threads} threads on chip")
    return cluster, R, threads, ppt, band * planes * 4


def tgv_resident_variant(shape, compute_loss=True) -> str:
    """Which whole-solve kernel serves a ``(Nz, M, Nr, Nc)`` volume:
    ``"onchip"`` where a slice's state fits one cluster's shared memory
    (:func:`onchip_band`), else ``"l2"``.  A choice by shape, made before
    the launch."""
    return "l2" if onchip_band(shape, compute_loss) is None else "onchip"


def tgv_resident_fits(shape, dtype=torch.float32, n_iter: int = 0,
                      compute_loss: bool = True) -> bool:
    """Auto-dispatch guard of the whole-solve kernel: float32 only (as in
    the JAX package), the ``Nz * M`` slices within the grid, and a slice of
    at most :data:`MAX_SLICE_VOXELS` voxels
    (:data:`MAX_SLICE_VOXELS_WITH_LOSS` when the loss is asked for) — a
    larger slice is worked on by only ``CLUSTER_SIZE`` SMs at a time, where
    the streaming kernels spread it over the card."""
    if len(shape) != 4 or dtype != torch.float32 or n_iter < 0:
        return False
    Nz, M, Nr, Nc = shape
    cap = MAX_SLICE_VOXELS_WITH_LOSS if compute_loss else MAX_SLICE_VOXELS
    return 0 < Nz * M <= MAX_SLICES and 0 < Nr * Nc <= cap


def tgv_resident_solve(x0, n_iter, alpha1, alpha0, sigma_tau_split=1.0,
                       compute_loss=True, norm="iso", huber_delta=1.0):
    """``n_iter`` TGV-2 CP iterations (``axes='2d'``) from a cold start at
    ``x0``: ``-> (x, w, xb, wb, p, q, losses)``, the full final CP state in
    the public layouts (w-like ``(Nz, 2, M, Nr, Nc)``, q
    ``(Nz, 3, M, Nr, Nc)``) for resume; ``losses`` is ``(n_iter,)``, the
    objective after each iteration (empty ``(0,)`` when
    ``compute_loss=False``).  ``x0`` is not modified.  On the card the
    kernel is the one :func:`tgv_resident_variant` names."""
    _check_tensors(x0)
    if x0.ndim != 4:
        raise ValueError(f"x0 must be (Nz, M, Nr, Nc), got {tuple(x0.shape)}")
    kw = dict(alpha1=alpha1, alpha0=alpha0, sigma_tau_split=sigma_tau_split,
              norm=norm, huber_delta=huber_delta)
    if x0.device.type == "cpu":
        return tgv_resident_plain(x0, n_iter, compute_loss=compute_loss, **kw)
    shape = tuple(x0.shape)
    # the kernels themselves take any slice size the grid can index; the
    # smaller cap without the loss is a matter of dispatch, not of the kernel
    if not tgv_resident_fits(shape, x0.dtype, n_iter, True):
        raise ValueError(
            f"shape {shape} {x0.dtype} is outside what the CUDA whole-solve "
            f"TGV kernels accept (tgv_resident_fits)")
    prm = tgv_params(shape, "2d", float(alpha1), float(alpha0),
                     float(sigma_tau_split), norm, float(huber_delta))
    solve = (solve_onchip if tgv_resident_variant(shape, compute_loss)
             == "onchip" else solve_l2)
    out = solve(x0, int(n_iter), prm, bool(compute_loss))
    count("launch.B7")
    return out


def _empty_state(x0, blocks, n_iter, compute_loss):
    """Outputs of a whole-solve launch: x, w, xb, wb, p, q in the public
    layouts and the ``(n_iter, blocks)`` loss partials."""
    Nz, M, Nr, Nc = x0.shape

    def empty(*s):
        return torch.empty(s, dtype=torch.float32, device=x0.device)

    x, xb = empty(Nz, M, Nr, Nc), empty(Nz, M, Nr, Nc)
    w, wb, p = (empty(Nz, 2, M, Nr, Nc) for _ in range(3))
    q = empty(Nz, 3, M, Nr, Nc)
    parts = empty(n_iter if compute_loss else 0, blocks)
    return x, w, xb, wb, p, q, parts


def solve_onchip(x0, n_iter, prm, compute_loss, cluster=None, threads=None,
                 smem_bytes=None):
    """One launch of ``tgv_onchip_kernel`` (``csrc/tgv_onchip.cu``) on the
    float32 CUDA volume ``x0`` with the parameters ``prm``
    (:func:`~.tgv_stream.tgv_params`); ``-> (x, w, xb, wb, p, q,
    losses)``.  ``cluster``, ``threads`` and ``smem_bytes`` override the
    launch shape of :func:`onchip_launch_shape` (the probe; a size the card
    refuses raises ``RuntimeError``)."""
    shape = tuple(x0.shape)
    C, _, threads, ppt, smem = onchip_launch_shape(shape, compute_loss,
                                                   cluster, threads)
    blocks = shape[0] * shape[1] * C
    if blocks > MAX_GRID_BLOCKS:
        raise ValueError(f"{shape[0] * shape[1]} slices x {C} blocks exceed "
                         f"the grid")
    x, w, xb, wb, p, q, parts = _empty_state(x0, blocks, n_iter, compute_loss)
    _launch("tgv_onchip", "tgvo_launch", x0, prm,
            (n_iter, int(compute_loss), C, threads, ppt,
             int(smem if smem_bytes is None else smem_bytes)),
            (x0, x, xb, w, wb, p, q, parts))
    count("launch.B7.onchip")
    return x, w, xb, wb, p, q, parts.sum(dim=1)


def solve_l2(x0, n_iter, prm, compute_loss):
    """One launch of ``tgv_resident_kernel`` (``csrc/tgv_resident.cu``), the
    state in global memory; as :func:`solve_onchip`."""
    Nz, M = x0.shape[:2]
    x, w, xb, wb, p, q, parts = _empty_state(x0, Nz * M * CLUSTER_SIZE,
                                             n_iter, compute_loss)
    _launch("tgv_resident", "tgv_resident_launch", x0, prm,
            (n_iter, int(compute_loss), CLUSTER_SIZE),
            (x0, x, xb, w, wb, p, q, parts))
    count("launch.B7.l2")
    return x, w, xb, wb, p, q, parts.sum(dim=1)


def max_active_clusters(shape, compute_loss=True, cluster=None,
                        threads=None) -> int:
    """How many clusters of the on-chip launch for ``shape`` the card holds
    at once (``cudaOccupancyMaxActiveClusters``); needs a CUDA device."""
    C, _, threads, ppt, smem = onchip_launch_shape(shape, compute_loss,
                                                   cluster, threads)
    lib = _lib("tgv_onchip")
    fn = lib.tgvo_max_active_clusters
    fn.argtypes = [ctypes.POINTER(TGVParams)] + [ctypes.c_int] * 5
    fn.restype = ctypes.c_int
    prm = tgv_params(tuple(shape), "2d", 1.0, 2.0, 1.0, "iso", 1.0)
    n = fn(ctypes.byref(prm), int(compute_loss), C, threads, ppt, smem)
    if n < 0:
        raise RuntimeError(f"cudaOccupancyMaxActiveClusters failed: "
                           f"{lib.tgvo_error_string(-n).decode()}")
    return n


def tgv_resident_plain(x0, n_iter, alpha1, alpha0, sigma_tau_split=1.0,
                       compute_loss=True, norm="iso", huber_delta=1.0):
    """Plain PyTorch version of :func:`tgv_resident_solve` (same signature
    and outputs): the plain streaming step looped, with the objective after
    each iteration."""
    kw = dict(mode="2d", sigma_tau_split=sigma_tau_split)
    x, xb, w, wb, p, q = _init_state(x0.contiguous(), "2d")
    losses = torch.empty(n_iter if compute_loss else 0, dtype=x0.dtype,
                         device=x0.device)
    for i in range(n_iter):
        tgv_pq_plain(xb, wb, p, q, alpha1=alpha1, alpha0=alpha0, norm=norm,
                     huber_delta=huber_delta, **kw)
        tgv_xw_plain(x, x0, p, w, q, xb, wb, **kw)
        if compute_loss:
            losses[i] = tgv_objective(x, w, x0, "2d", alpha1, alpha0, norm,
                                      huber_delta)
    return x, w, xb, wb, p, q, losses
