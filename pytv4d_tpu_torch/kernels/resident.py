"""Whole-solve kernels: ALL iterations of a Chambolle-Pock or
subgradient-descent TV denoising solve in one launch.  Replaces
``pytv4d_tpu/kernels/resident.py::make_resident_cp_solver`` and
``make_resident_gd_solver``.

For a small problem (the reference's headline case is one 256 x 256 image)
an iteration of the host loop costs far more in launches than in arithmetic.
Here one launch runs every iteration (kernels ``resident_cp_kernel`` and
``resident_gd_kernel`` in ``csrc/resident.cu``): the state lives in global
memory, where a volume :func:`resident_fits` admits stays in the L2 cache,
the launch's threads stride over all voxels, and a barrier that spans the
whole launch separates the two passes of an iteration.  The volume is one
coupled problem (z and t channels couple its slices), so the launch is one
cooperative grid of :data:`THREADS`-thread blocks (``grid.sync()``).  The
per-voxel
arithmetic is the per-launch kernels' own (``csrc/voxel.cuh``), so a solve
tracks the host loop over :func:`fused.cp_dual` / :func:`fused.cp_primal`
(or :func:`fused.tv_norms` / :func:`fused.tv_subgrad`) to float32 round-off.

This is an EXPLICIT API, as in the JAX package: call the ``make_resident_*``
factories directly; ``chambolle_pock`` and ``subgradient_descent`` do not
dispatch to it.

Each factory returns a ``solve`` that takes its plain PyTorch version
(:func:`resident_cp_plain`, :func:`resident_gd_plain`: the port's
``cp_step`` / ``gd_step`` looped) for tensors on the CPU; for CUDA tensors it
launches the kernel or raises.  A numpy array goes to the CUDA device, and
the call raises where there is none (``utils.device``).  ``make_resident_cp_solver.launches`` and
``make_resident_gd_solver.launches`` count the kernel launches of their
solvers: one per solve.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.config import TVConfig
from ..core.schemes import num_channels
from ..utils.device import on_device
from .dispatch import as_dtype
from .fused import (
    _ENTRY_POINTS,
    MAX_CHANNELS,
    _Params,
    _check_tensors,
    _launch,
    _lib,
    _params,
    from_internal_layout,
    to_internal_layout,
)

# The state a solve keeps on the card between iterations must stay in the
# H100's 50 MB L2 with room for x0 and the partials: x, y_A and the Nd
# channels of y_D for CP (GD's two x buffers and norms are fewer).
L2_STATE_BUDGET = 32 * 1024 * 1024
# Threads per block of the cooperative grid.  tools/torch_probe_resident.py
# A/Bs it against 512 and 1024 and against one thread-block cluster (PERF.md
# section 6).
THREADS = 256

_ENTRY_POINTS["resident"] = ("resident", _Params, {
    "resident_cp_launch": (3, 5), "resident_gd_launch": (3, 5)})


def resident_fits(shape, cfg: TVConfig, dtype=torch.float32) -> bool:
    """Guard of the whole-solve kernels: a float32 4D volume, at most
    :data:`fused.MAX_CHANNELS` channels, and a solver state
    (``(2 + Nd)`` volumes) within :data:`L2_STATE_BUDGET`, so that the
    iterations run out of the L2 cache."""
    if len(shape) != 4 or as_dtype(dtype) != torch.float32:
        return False
    Nz, M, Nr, Nc = shape
    vol = Nz * M * Nr * Nc
    if vol <= 0:
        return False
    Nd = num_channels(cfg.scheme, Nz, M, cfg.reg_z_over_reg, cfg.reg_time)
    return 0 < Nd <= MAX_CHANNELS and (2 + Nd) * vol * 4 <= L2_STATE_BUDGET


def _launch_shape(x, vol):
    """``(blocks, threads)`` for a volume of ``vol`` voxels on x's device:
    one voxel per thread where that many blocks are co-resident, else as
    many blocks as are (the threads stride)."""
    lib = _lib("resident")
    lib.resident_max_blocks.argtypes = [ctypes.c_int]
    lib.resident_max_blocks.restype = ctypes.c_int
    with torch.cuda.device(x.device):
        cap = lib.resident_max_blocks(THREADS)
    if cap <= 0:
        raise RuntimeError(
            "resident_max_blocks failed: "
            f"{lib.resident_error_string(-cap).decode()}")
    return min(-(-vol // THREADS), cap), THREADS


def _check_request(cfg, shape, n_iter, dtype_name):
    shape = tuple(int(n) for n in shape)
    if not resident_fits(shape, cfg, dtype_name):
        raise ValueError(
            f"shape {shape} {dtype_name} with scheme {cfg.scheme!r} is outside "
            f"what the whole-solve kernels accept (resident_fits)")
    if n_iter < 0:
        raise ValueError(f"n_iter must be >= 0, got {n_iter}")
    return shape


def _check_state(shapes, **tensors):
    """Every tensor is contiguous, on x's device, float32 and of its shape
    in ``shapes``."""
    _check_tensors(tensors["x"],
                   **{k: t for k, t in tensors.items() if k != "x"})
    for name, t in tensors.items():
        if t.dtype != torch.float32 or tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name} must be float32 {shapes[name]}, got "
                             f"{tuple(t.shape)} {t.dtype}")


def make_resident_cp_solver(cfg: TVConfig, shape, n_iter: int,
                            dtype_name="float32", reg=1.0, sigma_D=0.5,
                            sigma_A=1.0, tau=0.1):
    """``n_iter`` CP iterations in one launch.

    Returns ``solve(x_noisy, x, y_A, y_D) -> (x, y_A, y_D, losses)`` with
    the public ``(Nz, Nd, M, Nr, Nc)`` dual layout and the semantics of
    ``solvers.cp.cp_step`` (l2 fidelity, no mask, no ``nonneg``);
    ``losses`` is ``(n_iter,)`` float32 on the device.  The inputs are not
    modified."""
    shape = _check_request(cfg, shape, n_iter, dtype_name)
    Nz, M, Nr, Nc = shape
    Nd = num_channels(cfg.scheme, Nz, M, cfg.reg_z_over_reg, cfg.reg_time)
    kw = dict(reg=float(reg), sigma_D=float(sigma_D), sigma_A=float(sigma_A),
              tau=float(tau))

    shapes = dict(x_noisy=shape, x=shape, y_A=shape,
                  y_D=(Nz, Nd, M, Nr, Nc))

    def solve(x_noisy, x, y_A, y_D):
        x_noisy, x, y_A, y_D = (on_device(a) for a in (x_noisy, x, y_A, y_D))
        _check_state(shapes, x_noisy=x_noisy, x=x, y_A=y_A, y_D=y_D)
        if x_noisy.device.type == "cpu":
            return resident_cp_plain(x_noisy, x, y_A, y_D, n_iter, cfg=cfg,
                                     **kw)
        blocks, threads = _launch_shape(x_noisy, Nz * M * Nr * Nc)
        x, y_A, y_D_int = x.clone(), y_A.clone(), to_internal_layout(y_D)
        parts = torch.empty((n_iter, 2, blocks), dtype=torch.float32,
                            device=x.device)
        _launch("resident", "resident_cp_launch", x_noisy,
                _params(cfg, shape, False, **kw),
                (int(n_iter), blocks, threads),
                (x_noisy, x, y_A, y_D_int, parts))
        make_resident_cp_solver.launches += 1
        sums = parts.sum(dim=2)
        losses = torch.add(sums[:, 1], sums[:, 0], alpha=kw["reg"])
        return x, y_A, from_internal_layout(y_D_int).contiguous(), losses

    return solve


def make_resident_gd_solver(cfg: TVConfig, shape, n_iter: int,
                            dtype_name="float32", reg=1.0, step_size=5e-3):
    """``n_iter`` subgradient-descent iterations in one launch.

    Returns ``solve(x_noisy, x) -> (x, losses)`` with the semantics of
    ``solvers.gd.gd_step`` (no mask); ``losses`` is ``(n_iter,)`` float32
    on the device.  The inputs are not modified."""
    shape = _check_request(cfg, shape, n_iter, dtype_name)
    kw = dict(reg=float(reg), step_size=float(step_size))

    def solve(x_noisy, x):
        x_noisy, x = on_device(x_noisy), on_device(x)
        _check_state(dict(x_noisy=shape, x=shape), x_noisy=x_noisy, x=x)
        if x_noisy.device.type == "cpu":
            return resident_gd_plain(x_noisy, x, n_iter, cfg=cfg, **kw)
        vol = x.numel()
        blocks, threads = _launch_shape(x_noisy, vol)
        # iteration i reads buffer i % 2 and writes the other
        bufs = (x.clone(), torch.empty_like(x))
        norms = torch.empty_like(x)
        parts = torch.empty((n_iter, 2, blocks), dtype=torch.float32,
                            device=x.device)
        # the kernel reads its step size from the struct's tau
        _launch("resident", "resident_gd_launch", x_noisy,
                _params(cfg, shape, False, reg=kw["reg"],
                        tau=kw["step_size"]),
                (int(n_iter), blocks, threads),
                (x_noisy, *bufs, norms, parts))
        make_resident_gd_solver.launches += 1
        sums = parts.sum(dim=2)
        losses = torch.add(sums[:, 1], sums[:, 0], alpha=kw["reg"])
        return bufs[n_iter % 2], losses

    return solve


make_resident_cp_solver.launches = 0
make_resident_gd_solver.launches = 0


def resident_cp_plain(x_noisy, x, y_A, y_D, n_iter, *, cfg: TVConfig, reg,
                      sigma_D, sigma_A, tau):
    """Plain PyTorch version of the CP whole solve: ``solvers.cp.cp_step``
    looped, ``-> (x, y_A, y_D, losses)``."""
    from ..solvers.cp import CPState, cp_step

    st = CPState(x, y_A, y_D)
    losses = torch.empty(n_iter, dtype=x.dtype, device=x.device)
    for i in range(n_iter):
        st, losses[i] = cp_step(st, x_noisy, reg=reg, sigma_D=sigma_D,
                                sigma_A=sigma_A, tau=tau, cfg=cfg)
    return st.x, st.y_A, st.y_D, losses


def resident_gd_plain(x_noisy, x, n_iter, *, cfg: TVConfig, reg, step_size):
    """Plain PyTorch version of the GD whole solve: ``solvers.gd.gd_step``
    looped, ``-> (x, losses)``."""
    from ..solvers.gd import gd_step

    losses = torch.empty(n_iter, dtype=x.dtype, device=x.device)
    for i in range(n_iter):
        x, losses[i], _ = gd_step(x, x_noisy, reg=reg, step_size=step_size,
                                  cfg=cfg)
    return x, losses
