"""Chambolle-Pock pass A marching along z: every x plane is loaded from
memory once.  Replaces
``pytv4d_tpu/kernels/zstream.py::make_cp_dual_kernel_zstream``.

The per-launch pass A (:func:`fused.cp_dual`) reads each voxel's z and row
neighbours from memory, so an x plane is requested five times.  Here
(``zstream_spec_kernel`` in ``csrc/cp_zstream.cu``) a block owns two rows of
one t-plane and marches z = 0 .. Nz-1 with the x tiles of z - 1, z and z + 1
(one row either side) in a ring of shared memory while the tile of z + 2
is in flight (cp.async), so each x plane crosses from memory once and the
row and z neighbours come from shared memory.  The body is B1's, specialised
per channel table (``csrc/specialised.cuh::dual_spec_run``; the nine tables
with a z channel, :func:`tables.zstream_table_id`), so y_A' and y_D' equal
B1's to the bit and the TV partials differ only in the order of the
additions.  The TPU kernel's ``row_tile``, its 8-row seam granules, its DMA
semaphores, its scratch budget and its ``dt_local`` output are TPU tiling
and are not carried over.

This is an EXPLICIT API, as in the JAX package: ``cp_step_fused_internal``
does not dispatch to it.  :func:`cp_dual_zstream` has the contract of
:func:`fused.cp_dual` without the time-plane multiplier; it takes its plain
PyTorch version (:func:`cp_dual_zstream_plain`) for tensors on the CPU, and
for CUDA tensors it launches the kernel or raises.
``utils.profiling.counters()`` counts its launches under ``launch.B10``.
"""

from __future__ import annotations

import torch

from ..core.config import TVConfig
from ..core.schemes import AXIS_Z, scheme_channels
from ..utils.profiling import count
from . import tables
from .fused import (
    _ENTRY_POINTS,
    _Params,
    _check_operands,
    _launch,
    _params,
    _storage_flags,
    cp_dual_plain,
)

# int flags: the table id, then the storage of x and of the dual
_ENTRY_POINTS["cp_zstream"] = ("cpz", _Params,
                               {"cp_dual_zstream_launch": (3, 5)})


def _check_zstream(x, cfg: TVConfig):
    """The guards of the TPU kernel that are not tiling: a volume thick
    enough to have a window, and z channels for it to serve."""
    Nz, M = x.shape[0], x.shape[1]
    if Nz < 3:
        raise ValueError("zstream pass A needs Nz >= 3 (use the production "
                         "kernel for thin volumes)")
    chans, _ = scheme_channels(cfg.scheme, Nz, M, cfg.reg_z_over_reg,
                               cfg.reg_time)
    if not any(ch.axis == AXIS_Z for ch in chans):
        raise ValueError("zstream pass A only pays off with z channels "
                         "(reg_z_over_reg > 0 and Nz > 1)")


def cp_dual_zstream(x, x0, y_A, y_D, *, cfg: TVConfig, sigma_D, sigma_A, reg,
                    fidelity="l2", fid_weight=1.0):
    """Pass A, z-marching: ``(x, x0, y_A, y_D) -> (y_A', y_D', tv_parts)``.

    ``y_A`` and ``y_D`` (internal ``(Nz, M, Nd, Nr, Nc)`` layout) are
    updated in place and returned; ``tv_parts`` are partial sums of the TV
    term of D x, one per block of columns.  Needs ``Nz >= 3`` and a z
    channel in the scheme table (``ValueError`` otherwise); float32 or
    bfloat16 storage of the primary arrays and of the dual."""
    _check_operands(x, x0, y_A, y_D, None, cfg)
    _check_zstream(x, cfg)
    if x.device.type == "cpu":
        return cp_dual_zstream_plain(x, x0, y_A, y_D, cfg=cfg,
                                     sigma_D=sigma_D, sigma_A=sigma_A,
                                     reg=reg, fidelity=fidelity,
                                     fid_weight=fid_weight)
    return _zstream_kernel(x, x0, y_A, y_D, cfg=cfg, sigma_D=sigma_D,
                           sigma_A=sigma_A, reg=reg, fidelity=fidelity,
                           fid_weight=fid_weight)


def _zstream_kernel(x, x0, y_A, y_D, *, cfg: TVConfig, sigma_D, sigma_A, reg,
                    fidelity, fid_weight):
    """:func:`cp_dual_zstream`'s launch, on checked operands: the kernel of
    the scheme's channel table (:func:`tables.zstream_table_id`; raises
    where ``csrc/cp_zstream.cu`` has none) and storage."""
    p = _params(cfg, tuple(x.shape), False, sigma_D=float(sigma_D),
                sigma_A=float(sigma_A), reg=float(reg), fidelity=fidelity,
                fid_weight=float(fid_weight))
    flags = (tables.zstream_table_id(cfg, x.shape[0], x.shape[1]),
             *_storage_flags(x, y_D))
    parts = _launch("cp_zstream", "cp_dual_zstream_launch", x, p, flags,
                    (x, x0, y_A, y_D), with_parts=True)
    count("launch.B10")
    return y_A, y_D, parts


def cp_dual_zstream_plain(x, x0, y_A, y_D, *, cfg: TVConfig, sigma_D,
                          sigma_A, reg, fidelity="l2", fid_weight=1.0):
    """Plain PyTorch version of :func:`cp_dual_zstream`: pass A computes
    one function whatever the order of its memory traffic, so this is
    :func:`fused.cp_dual_plain` behind the same guards."""
    _check_zstream(x, cfg)
    return cp_dual_plain(x, x0, y_A, y_D, None, cfg=cfg, sigma_D=sigma_D,
                         sigma_A=sigma_A, reg=reg, fidelity=fidelity,
                         fid_weight=fid_weight)
