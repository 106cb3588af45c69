"""Whole-solve kernels: ALL iterations of a Chambolle-Pock or
subgradient-descent TV denoising solve in one launch.  Replaces
``pytv4d_tpu/kernels/resident.py::make_resident_cp_solver`` and
``make_resident_gd_solver``.

For a small problem (the reference's headline case is one 256 x 256 image)
an iteration of the host loop costs far more in launches than in arithmetic.
Here one launch runs every iteration.  The volume is one coupled problem (z
and t channels couple its slices), so every block of the launch takes part
in every iteration.  Two kernels, chosen by the volume's shape before the
launch (:func:`resident_variant`):

- ``"onchip"`` (``reso_cp_kernel`` / ``reso_gd_kernel`` in
  ``csrc/resident_onchip.cu``): block b owns a band of rows of every (z, t)
  plane (:func:`onchip_band`: one block an SM, R rows a band, at least as
  many as GD's halo), holds the band's state and the halo rows its passes
  read in shared memory for the whole solve, and waits only for its two
  neighbour bands between the passes: the edge rows travel through L2 as
  64-bit words carrying their pass's flag.  The body is specialised per
  channel table (``kernels/tables.py::table_id``).
- ``"l2"`` (``resident_cp_kernel`` / ``resident_gd_kernel`` in
  ``csrc/resident.cu``): volumes whose bands do not fit; the state in
  global memory, where a volume :func:`resident_fits` admits stays in the
  L2 cache, the threads striding over all voxels, a cooperative grid of
  :data:`THREADS`-thread blocks with ``grid.sync()`` between the passes.

Both run the per-launch kernels' per-voxel arithmetic (``csrc/voxel.cuh``,
and its per-table form in ``csrc/specialised.cuh``): their states are equal
bit for bit, and a solve tracks the host loop over :func:`fused.cp_dual` /
:func:`fused.cp_primal` (or :func:`fused.tv_norms` /
:func:`fused.tv_subgrad`) to float32 round-off.

This is an EXPLICIT API, as in the JAX package: call the ``make_resident_*``
factories directly; ``chambolle_pock`` and ``subgradient_descent`` do not
dispatch to it.

Each factory returns a ``solve`` that takes its plain PyTorch version
(:func:`resident_cp_plain`, :func:`resident_gd_plain`: the port's
``cp_step`` / ``gd_step`` looped) for tensors on the CPU; for CUDA tensors it
launches the kernel :func:`resident_variant` names or raises -- a refused launch never
runs the other kernel.  A numpy array goes to the CUDA device, and the call
raises where there is none (``utils.device``).
``utils.profiling.counters()`` counts the launches of their solvers (one
per solve) under ``launch.B9.cp`` and ``launch.B9.gd``; :func:`solve_onchip`
and :func:`solve_l2` launch one kernel each on the internal-layout state
(``chip_smoke.py`` and the tools call them to hold the two against each
other), counted under ``launch.B9.onchip`` and ``launch.B9.l2``.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.config import TVConfig
from ..core.schemes import AXIS_ROW, CTR, num_channels
from ..utils.device import on_device
from ..utils.profiling import count
from . import tables
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

# The on-chip kernels (csrc/resident_onchip.cu).  Dynamic shared memory a
# block may take: the H100's 232 448 bytes a block (227 KB) less the
# kernels' static warp sums (RESO_SMEM_BYTES); threads a block
# (RESO_THREADS); one block an SM, so a launch holds at most as many blocks
# as the card has SMs (the H100 SXM's 132 where no card is asked).
ONCHIP_SMEM_BYTES = 232448 - 256
ONCHIP_THREADS = 512
H100_SMS = 132

_ENTRY_POINTS["resident_onchip"] = ("reso", _Params, {
    "reso_cp_launch": (4, 6), "reso_gd_launch": (4, 5)})


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


def onchip_halo(cfg: TVConfig, Nz: int, M: int, solver: str) -> int:
    """Halo rows a band of the on-chip kernel reads each side: x +-1 for CP
    and GD, +-2 for GD's pass 2 where a row channel is central
    (``gd_halo``)."""
    if solver == "gd" and (AXIS_ROW, CTR) in tables.TABLES[
            tables.table_id(cfg, Nz, M)]:
        return 2
    return 1


def onchip_floats(solver: str, Nd: int, halo: int, planes: int, Nc: int,
                  R: int) -> int:
    """Floats of shared memory a band of R rows of ``planes`` planes takes,
    in the order ``reso_cp_kernel`` / ``reso_gd_kernel`` lay them out
    (``csrc/resident_onchip.cu``, which takes the size from here): CP x
    with a halo row each side, y_A, x0, the Nd dual channels and one row
    each side of the row channels' dual; GD two x buffers with ``halo``
    rows each side, the norms with one, x0."""
    if solver == "cp":
        return planes * Nc * ((R + 2) + (2 + Nd) * R + 2)
    return planes * Nc * (2 * (R + 2 * halo) + (R + 2) + R)


def onchip_band(shape, cfg: TVConfig, solver="cp", sms=H100_SMS):
    """``(blocks, R, shared bytes a block)`` of the on-chip launch for a
    ``(Nz, M, Nr, Nc)`` volume: R = ceil(Nr / sms) rows a band, at least
    the rows a band lends its neighbours (:func:`onchip_halo`), one block a
    band; ``None`` where a band's state does not fit
    :data:`ONCHIP_SMEM_BYTES` or the table has no on-chip kernel."""
    if solver not in ("cp", "gd"):
        raise ValueError(f"solver must be 'cp' or 'gd', got {solver!r}")
    Nz, M, Nr, Nc = shape
    try:
        halo = onchip_halo(cfg, Nz, M, solver)
    except ValueError:
        return None
    Nd = num_channels(cfg.scheme, Nz, M, cfg.reg_z_over_reg, cfg.reg_time)
    R = max(-(-Nr // sms), min(halo, Nr))
    smem = 4 * onchip_floats(solver, Nd, halo, Nz * M, Nc, R)
    if smem > ONCHIP_SMEM_BYTES:
        return None
    return -(-Nr // R), R, smem


def band_rows(Nr: int, R: int):
    """The rows ``[start, stop)`` of each block's band: block b from
    ``b R``, at most R rows, ``ceil(Nr / R)`` blocks."""
    return [(b * R, min((b + 1) * R, Nr)) for b in range(-(-Nr // R))]


def resident_variant(shape, cfg: TVConfig, solver="cp", sms=H100_SMS) -> str:
    """Which whole-solve kernel serves a ``(Nz, M, Nr, Nc)`` volume:
    ``"onchip"`` where the bands of the blocks the card holds at once (one
    an SM, ``sms`` of them) fit their shared memory (:func:`onchip_band`),
    else ``"l2"``.  A choice by shape, made before the launch."""
    return "l2" if onchip_band(shape, cfg, solver, sms) is None else "onchip"


def _sm_count(device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


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


def _kernel(solver, cfg, shape, device):
    """The launch of the kernel :func:`resident_variant` names for
    ``shape`` on ``device``'s card: :func:`solve_onchip` or
    :func:`solve_l2`."""
    return (solve_onchip if resident_variant(shape, cfg, solver,
                                             _sm_count(device)) == "onchip"
            else solve_l2)


def solver_params(solver, cfg: TVConfig, shape, *, reg, **kw):
    """The launch parameters of a whole solve: CP's ``sigma_D``,
    ``sigma_A`` and ``tau``, or GD's ``step_size``, which the kernels read
    from the struct's tau."""
    if solver == "gd":
        return _params(cfg, shape, False, reg=reg, tau=kw["step_size"])
    return _params(cfg, shape, False, reg=reg, **kw)


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
        x, y_A, y_D_int = x.clone(), y_A.clone(), to_internal_layout(y_D)
        losses = _kernel("cp", cfg, shape, x.device)(
            "cp", cfg, x_noisy, solver_params("cp", cfg, shape, **kw),
            int(n_iter), (x, y_A, y_D_int))
        count("launch.B9.cp")
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
        # iteration i reads buffer i % 2 and writes the other
        bufs = (x.clone(), torch.empty_like(x))
        losses = _kernel("gd", cfg, shape, x.device)(
            "gd", cfg, x_noisy, solver_params("gd", cfg, shape, **kw),
            int(n_iter), bufs)
        count("launch.B9.gd")
        return bufs[n_iter % 2], losses

    return solve


def solve_onchip(solver, cfg, x_noisy, p, n_iter, state):
    """One launch of ``reso_cp_kernel`` / ``reso_gd_kernel``
    (``csrc/resident_onchip.cu``) for the table of ``cfg`` on the volume
    ``x_noisy`` with the parameters ``p`` (:func:`solver_params`):
    ``state`` is ``(x, y_A, y_D)`` (internal layout, updated in place) for
    ``solver="cp"``, the two x buffers for ``"gd"`` (the start iterate in
    the first, the result in buffer ``n_iter % 2``).  Returns the
    ``(n_iter,)`` losses.  Raises where the volume's bands do not fit
    (:func:`onchip_band`)."""
    shape = tuple(x_noisy.shape)
    fit = onchip_band(shape, cfg, solver, _sm_count(x_noisy.device))
    if fit is None:
        raise ValueError(f"shape {shape} does not fit the on-chip {solver} "
                         f"kernel (onchip_band)")
    blocks, R, smem = fit
    Nz, M, _, Nc = shape
    parts = torch.empty((n_iter, 2, blocks), dtype=torch.float32,
                        device=x_noisy.device)
    # the words the bands exchange (exch_words a block), zeroed: no flag is 0
    ex = torch.zeros(blocks * 12 * Nz * M * Nc, dtype=torch.int64,
                     device=x_noisy.device)
    _launch("resident_onchip", f"reso_{solver}_launch", x_noisy, p,
            (tables.table_id(cfg, Nz, M), n_iter, R, smem),
            (x_noisy, *state, parts, ex))
    count("launch.B9.onchip")
    return _losses(parts, p)


def solve_l2(solver, cfg, x_noisy, p, n_iter, state):
    """One launch of ``resident_cp_kernel`` / ``resident_gd_kernel``
    (``csrc/resident.cu``), the state in global memory; as
    :func:`solve_onchip`."""
    blocks, threads = _launch_shape(x_noisy, x_noisy.numel())
    parts = torch.empty((n_iter, 2, blocks), dtype=torch.float32,
                        device=x_noisy.device)
    extra = (torch.empty_like(x_noisy),) if solver == "gd" else ()  # norms
    _launch("resident", f"resident_{solver}_launch", x_noisy, p,
            (n_iter, blocks, threads), (x_noisy, *state, *extra, parts))
    count("launch.B9.l2")
    return _losses(parts, p)


def _losses(parts, p):
    """The losses of ``(n_iter, 2, blocks)`` partials (TV, fidelity): the
    blocks added in order, the TV term times reg."""
    sums = parts.sum(dim=2)
    return torch.add(sums[:, 1], sums[:, 0], alpha=p.reg)


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
