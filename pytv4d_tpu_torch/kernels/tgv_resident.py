"""Whole-solve TGV-2 kernel: the ENTIRE Chambolle-Pock solve for
``axes='2d'`` TGV in one launch.  Replaces ``pytv4d_tpu/kernels/
tgv_resident.py::make_resident_tgv_solver``.

The in-plane mode couples pixels only within a (N_row, N_col) slice, so the
(z, t) slices are independent subproblems.  The TPU kernel kept one slice's
12 planes of state in VMEM for all iterations; at 256 x 256 that is 3 MB,
against 227 KB of shared memory per thread block on an H100.  Here one
THREAD-BLOCK CLUSTER of :data:`CLUSTER_SIZE` blocks works on one slice
(kernel ``tgv_resident_kernel`` in ``csrc/tgv_resident.cu``): the state
lives in global memory, where it stays in the 50 MB L2 while its cluster
works on it, and the cluster loops over the iterations itself, with a
cluster-wide barrier between the dual pass, the primal pass and the loss
of each one.  The per-voxel arithmetic is the streaming kernels' own
(``csrc/tgv.cuh``).

Loss history: each block writes one partial per iteration into a
``(n_iter, blocks)`` float32 array in a fixed order (no float atomics); the
wrapper sums it over the blocks.  The objective is separable over slices.

:func:`tgv_resident_solve` takes its plain PyTorch version
(:func:`tgv_resident_plain`) for a tensor on the CPU; for a CUDA tensor it
launches the kernel or raises — it never gives way to the streaming path.
``tgv_resident_solve.launches`` counts kernel launches: one per solve.
"""

from __future__ import annotations

import torch

from ..solvers.tgv import _init_state, tgv_objective
from .fused import _ENTRY_POINTS, _check_tensors, _launch
from .tgv_stream import (
    TGVParams,
    tgv_params,
    tgv_pq_plain,
    tgv_xw_plain,
)

CLUSTER_SIZE = 8          # blocks per slice: the portable cluster maximum
MAX_SLICES = (2**31 - 1) // CLUSTER_SIZE  # the slices ride gridDim.x
# One cluster (8 of the 132 SMs) works on a slice, so an iteration's time
# grows with the slice: 0.0187 ms per 65 536 voxels on an NVIDIA H100 80GB
# HBM3 at 700 W, against 0.058-0.1 ms of host time per iteration of the two
# streaming launches (PERF.md section 6).  Without the loss the two break
# even between 450 x 450 and 590 x 590 voxels per slice (measured: the
# streaming pair 3-5x slower than this kernel at one 256 x 256 slice, 3.7x
# faster at one 1024 x 1024 slice).  With the per-iteration loss there is no
# other kernel path, only the plain loop (10x slower at 1024 x 1024), and
# this kernel is taken up to the largest slice it was measured at.
MAX_SLICE_VOXELS = 512 * 512
MAX_SLICE_VOXELS_WITH_LOSS = 1024 * 1024

_ENTRY_POINTS["tgv_resident"] = ("tgvr", TGVParams, {
    "tgv_resident_launch": (3, 8)})


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
    ``compute_loss=False``).  ``x0`` is not modified."""
    _check_tensors(x0)
    if x0.ndim != 4:
        raise ValueError(f"x0 must be (Nz, M, Nr, Nc), got {tuple(x0.shape)}")
    kw = dict(alpha1=alpha1, alpha0=alpha0, sigma_tau_split=sigma_tau_split,
              norm=norm, huber_delta=huber_delta)
    if x0.device.type == "cpu":
        return tgv_resident_plain(x0, n_iter, compute_loss=compute_loss, **kw)
    shape = tuple(x0.shape)
    # the kernel itself takes any slice size the grid can index; the
    # smaller cap without the loss is a matter of dispatch, not of the kernel
    if not tgv_resident_fits(shape, x0.dtype, n_iter, True):
        raise ValueError(
            f"shape {shape} {x0.dtype} is outside what the CUDA whole-solve "
            f"TGV kernel accepts (tgv_resident_fits)")
    prm = tgv_params(shape, "2d", float(alpha1), float(alpha0),
                     float(sigma_tau_split), norm, float(huber_delta))
    Nz, M, Nr, Nc = shape

    def empty(*s):
        return torch.empty(s, dtype=torch.float32, device=x0.device)

    x, xb = empty(*shape), empty(*shape)
    w, wb, p = (empty(Nz, 2, M, Nr, Nc) for _ in range(3))
    q = empty(Nz, 3, M, Nr, Nc)
    blocks = Nz * M * CLUSTER_SIZE
    parts = empty(n_iter if compute_loss else 0, blocks)
    _launch("tgv_resident", "tgv_resident_launch", x0, prm,
            (int(n_iter), int(bool(compute_loss)), CLUSTER_SIZE),
            (x0, x, xb, w, wb, p, q, parts))
    tgv_resident_solve.launches += 1
    return x, w, xb, wb, p, q, parts.sum(dim=1)


tgv_resident_solve.launches = 0


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
