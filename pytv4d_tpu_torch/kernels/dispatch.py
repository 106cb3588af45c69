"""Dispatch for the fused kernels (the CP step and the TV subgradient):
which problems the kernels take, and the per-pixel time-channel multiplier
they apply.

Feature coverage of the fused path, as in the JAX package: all four
schemes, the 'iso', 'aniso' and 'huber' norms, float32 or bfloat16 storage,
static masks and ``weight_time`` planes shaped like the reference's
``(1, 1, N, N)`` contract (``tv_operators_CPU.py:148-151``, ``README.md:258``).
Full per-voxel ``(Nz, M, N, N)`` fields and float64 volumes take the plain
``solvers.cp.cp_step`` / ``ops.tv.tv_and_subgrad``.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..core.config import TVConfig
from ..core.schemes import AXIS_T, num_channels, scheme_channels
from ..ops.operators import mask_enabled
from .fused import fits_kernel


def _is_plane(arr, shape) -> bool:
    """True when ``arr`` is broadcastable to (1, 1, Nr, Nc) — the reference's
    static-mask contract — i.e. per-pixel but constant over z and t."""
    s = tuple(np.shape(arr))
    if len(s) < 2 or s[-2:] != (shape[-2], shape[-1]):
        return False
    return all(d == 1 for d in s[:-2])


def _has_t_channels(shape, cfg: TVConfig) -> bool:
    chans, _ = scheme_channels(cfg.scheme, shape[0], shape[1],
                               cfg.reg_z_over_reg, cfg.reg_time)
    return any(ch.axis == AXIS_T for ch in chans)


def t_plane_multiplier(shape, cfg: TVConfig, mask_static=None,
                       weight_time=None, dtype=torch.float32, *, device):
    """The (Nr, Nc) per-pixel multiplier the fused kernels apply to time
    channels, as a tensor on ``device``, or None when no multiplier is
    needed.

    Composes the reference's static-mask factor (masked pixels' time
    channels x sqrt(factor_reg_static), ``tv_operators_CPU.py:148-151``)
    with a ``weight_time`` plane.  Only valid when both inputs satisfy
    :func:`_is_plane` — enforced by :func:`can_fuse`.
    """
    if not _has_t_channels(shape, cfg):
        return None
    plane = (shape[-2], shape[-1])
    tm = None
    if mask_enabled(mask_static):
        mask = torch.as_tensor(mask_static, device=device).bool().reshape(plane)
        factor = math.sqrt(cfg.factor_reg_static)
        tm = torch.where(mask, torch.tensor(factor, dtype=dtype, device=device),
                         torch.tensor(1.0, dtype=dtype, device=device))
    if weight_time is not None:
        wt = torch.as_tensor(weight_time, device=device).to(dtype).reshape(plane)
        tm = wt if tm is None else tm * wt
    return tm


def as_dtype(dtype) -> torch.dtype:
    """A torch dtype from a dtype or its name ('float32', 'bfloat16')."""
    if isinstance(dtype, torch.dtype):
        return dtype
    return getattr(torch, str(dtype))


def can_fuse(shape, cfg: TVConfig, mask_static=None, dtype="float32",
             weight_time=None, for_gd: bool = False,
             table_dims=None) -> bool:
    """Whether the fused kernels support this problem instance: rank 4, a
    known norm, plane-shaped ``mask_static`` / ``weight_time``, float32 or
    bfloat16 storage, and a shape within :func:`fused.fits_kernel`.  On a
    shard, ``table_dims`` is the whole volume's ``(Nz, M)``, which sizes the
    channel table.

    ``for_gd``: kept for call-site symmetry with the JAX package — both
    kernel families (CP step, TV norms/subgradient) cover the same
    instances."""
    if len(shape) != 4:
        return False
    if cfg.norm not in ("iso", "aniso", "huber"):
        return False
    if mask_enabled(mask_static) and not _is_plane(mask_static, shape):
        return False  # full (Nz, M, N, N) masks stay on the plain path
    if weight_time is not None and not _is_plane(weight_time, shape):
        return False
    Nd = num_channels(cfg.scheme, *(table_dims or shape[:2]),
                      cfg.reg_z_over_reg, cfg.reg_time)
    return fits_kernel(tuple(shape), Nd, as_dtype(dtype))
