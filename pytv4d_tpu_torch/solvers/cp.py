"""Chambolle-Pock primal-dual TV denoising — the reference's user-loop recipe
(``README.md:139-158``, Chambolle & Pock 2011 doi:10.1007/s10851-010-0251-1)
as an eager PyTorch loop on the tensor's own device.

Minimizes ``F(x) + reg * TV(x)`` with ``F`` the data term of
``solvers.fidelity`` (``1/2 ||x - x0||^2`` by default).  The dual TV prox
uses ``keepdim=True`` so it is correct for all of 2D/3D/4D (SURVEY.md
section 2.4.6).  The port of ``pytv4d_tpu/solvers/cp.py``, the diagonally
preconditioned solver (:func:`chambolle_pock_precond`) included.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..core.config import TVConfig
from ..core.schemes import num_channels, operator_norm_bound_sq
from ..ops.operators import _safe_sqrt, precond_maps, tv_norm
from ..ops.space import Space, d_zeros, tensor_space
from ..parallel.mesh import indexed, is_grid
from ..utils.device import on_device
from ..utils.profiling import ITER_SPAN, solve_span, span
from .fidelity import fidelity_dual_prox, fidelity_loss, validate_fidelity
from .progress import emit_progress


class CPState(NamedTuple):
    x: torch.Tensor                # primal iterate (Nz, M, N_row, N_col)
    y_A: torch.Tensor              # dual of the fidelity term, shaped like x
    y_D: Optional[torch.Tensor]    # TV dual (Nz, Nd, M, N_row, N_col)


class CPPrecondState(NamedTuple):
    """Carry of :func:`chambolle_pock_precond`: the over-relaxed iterate
    rides along so that a resumed run continues exactly."""
    x: torch.Tensor
    x_bar: torch.Tensor
    y_A: torch.Tensor
    y_D: torch.Tensor


class CPResult(NamedTuple):
    x: torch.Tensor
    state: CPState  # a CPPrecondState from chambolle_pock_precond
    loss: torch.Tensor  # per-iteration loss history (n_iter,), on the device


def default_tau(cfg: TVConfig, Nz: int, M: int, sigma_A: float = 1.0) -> float:
    """Reference step rule ``tau = 1/(||D||^2 + sigma_A)`` — the README's
    ``1/(8+1)`` with 8 = hybrid-scheme bound (``README.md:141-143``),
    generalized per scheme/config via the stencil table."""
    L2 = operator_norm_bound_sq(cfg.scheme, Nz, M, cfg.reg_z_over_reg, cfg.reg_time)
    return 1.0 / (L2 + sigma_A)


def _require_scalar_weight(fidelity_weight, what: str) -> float:
    """The denoising solver takes a scalar data weight (the fused kernels
    read it as a launch argument)."""
    if (isinstance(fidelity_weight, (int, float))
            or getattr(fidelity_weight, "ndim", None) == 0):
        return float(fidelity_weight)
    raise ValueError(
        f"{what} takes a SCALAR fidelity_weight; per-measurement weight "
        f"arrays belong to the inverse solvers (solvers.inverse.cp_inverse)"
    )


def dual_prox(p, reg, norm: str, sigma=1.0, huber_delta: float = 1.0):
    """Prox of the TV term's convex conjugate: the per-pixel L2 reg-ball
    projection for isotropic TV (``README.md:150-151``), the [-reg, reg] box
    for anisotropic L1,1, and for Huber-TV a shrink by ``1 + sigma*delta/reg``
    before the ball projection (Chambolle & Pock 2011 section 6.2)."""
    if norm == "aniso":
        return torch.clamp(p, -reg, reg)
    if norm == "huber":
        p = p / (1.0 + sigma * huber_delta / reg)
    p_norms = _safe_sqrt(torch.sum(torch.square(p), dim=1, keepdim=True))
    return p / torch.clamp_min(p_norms / reg, 1.0)


def cp_step(state: CPState, x_noisy, *, reg, sigma_D, sigma_A, tau,
            cfg: TVConfig, mask_static=None, weight_time=None, fidelity="l2",
            fidelity_weight=1.0, nonneg=False, space: Space = None):
    """One CP iteration, exactly the reference recipe (``README.md:146-157``):

    - fidelity dual:  y_A <- (y_A + sigma_A (x - x0)) / (1 + sigma_A)
      (``'l1'`` / ``'kl'``: the matching conjugate prox)
    - TV dual prox:   y_D <- p / max(1, |p|_2 / reg),  p = y_D + sigma_D D x
    - primal:         x   <- x - tau y_A - tau D^T y_D  (then x >= 0 when
      ``nonneg``)
    - loss:           F(x_new) + reg * TV(D x_old)
      (the reference reuses the pre-update ``D_x`` in the loss line)

    ``space`` (``ops.space``): the fields' operations, a tensor's from
    ``cfg`` / ``mask_static`` / ``weight_time`` by default, or a grid's
    (``parallel.halo.grid_space``, which carries its own masks).
    """
    if space is None:
        space = tensor_space(cfg, mask_static, weight_time)
    x, y_A, y_D = state
    y_A = space.map(lambda ya, xs, x0: fidelity_dual_prox(
        ya, xs, x0, sigma_A, fidelity, fidelity_weight), y_A, x, x_noisy)
    D_x = space.D(x)
    y_D = space.map(lambda yd, d: dual_prox(
        yd + sigma_D * d, reg, cfg.norm, sigma_D, cfg.huber_delta), y_D, D_x)

    def primal(xs, ya, dty):
        xs = xs - tau * ya - tau * dty
        return torch.clamp_min(xs, 0.0) if nonneg else xs

    x = space.map(primal, x, y_A, space.D_T(y_D))
    loss = space.sum(lambda xs, x0, d: fidelity_loss(
        xs, x0, fidelity, fidelity_weight) + reg * tv_norm(
        d, cfg.norm, huber_delta=cfg.huber_delta), x, x_noisy, D_x)
    return CPState(x, y_A, y_D), loss


def cp_step_precond(state_and_bar, x_noisy, *, reg, sigma_D_map, tau_map,
                    sigma_A, cfg: TVConfig, fidelity="l2",
                    fidelity_weight=1.0, nonneg=False, space: Space = None):
    """One diagonally-preconditioned CP iteration (Pock & Chambolle 2011)
    with over-relaxation: per-slot dual steps, per-pixel primal steps, so no
    operator-norm tuning is needed; faster on anisotropic configs
    (reg_z/reg_time far from 1).  ``(x, x_bar, y_A, y_D) -> ((x', x_bar',
    y_A', y_D'), loss)`` with ``loss = F(x') + reg * TV(D x')``.
    ``space`` as in :func:`cp_step` (the step maps are fields of it)."""
    if space is None:
        space = tensor_space(cfg)
    x, x_bar, y_A, y_D = state_and_bar
    y_A = space.map(lambda ya, xb, x0: fidelity_dual_prox(
        ya, xb, x0, sigma_A, fidelity, fidelity_weight), y_A, x_bar, x_noisy)
    y_D = space.map(lambda yd, s, d: dual_prox(
        yd + s * d, reg, cfg.norm, s, cfg.huber_delta),
        y_D, sigma_D_map, space.D(x_bar))

    def primal(xs, t, ya, dty):
        xn = xs - t * (ya + dty)
        return torch.clamp_min(xn, 0.0) if nonneg else xn

    x_new = space.map(primal, x, tau_map, y_A, space.D_T(y_D))
    x_bar = space.map(lambda a, b: 2.0 * a - b, x_new, x)
    loss = space.sum(lambda xn, x0, d: fidelity_loss(
        xn, x0, fidelity, fidelity_weight) + reg * tv_norm(
        d, cfg.norm, huber_delta=cfg.huber_delta),
        x_new, x_noisy, space.D(x_new))
    return (x_new, x_bar, y_A, y_D), loss


def chambolle_pock_precond(
    x_noisy,
    n_iter: int = 300,
    reg: float = 25.0,
    sigma_A: float = 1.0,
    cfg: TVConfig = TVConfig(),
    state=None,
    fidelity: str = "l2",
    fidelity_weight: float = 1.0,
    nonneg: bool = False,
    device=None,
) -> CPResult:
    """Diagonally-preconditioned Chambolle-Pock on ``x_noisy``'s device (a
    tensor's own; the CUDA device for a numpy array, ``RuntimeError`` where
    there is none, or ``device`` where given: ``utils.device``):
    parameter-free step sizes from the stencil table
    (``ops.operators.precond_maps``).  Carries the fidelity family of
    :func:`chambolle_pock`.  ``state`` resumes from ``result.state`` (a
    :class:`CPPrecondState`: the over-relaxed iterate must ride along for
    an exact continuation).  Plain PyTorch, as the JAX solver runs no
    kernel; the loss history stays on the device.

    A grid of shards (``parallel.mesh.shard_volume``) runs the same loop
    on ``parallel.halo.grid_space``, each shard's step maps built from its
    place in the volume (``parallel.halo.grid_precond_maps``); ``x`` and
    the state come back as grids, and ``state`` may hold grids or whole
    arrays."""
    fidelity_weight = _require_scalar_weight(
        fidelity_weight, "chambolle_pock_precond")
    if is_grid(x_noisy):
        from ..parallel import entry
        from ..parallel.halo import grid_precond_maps

        lay = entry.layout_of(x_noisy, device)
        space = entry.solver_space(x_noisy, cfg)
        for _, _, part in indexed(x_noisy):
            validate_fidelity(fidelity, part, fidelity_weight)
        sigma_D_map, tau_map = grid_precond_maps(
            lay.mesh, lay.shape, lay.shard_time, scheme=cfg.scheme,
            reg_z_over_reg=cfg.reg_z_over_reg, reg_time=cfg.reg_time,
            sigma_A_rows=sigma_A, dtype=space.first(x_noisy).dtype)
    else:
        x_noisy = on_device(x_noisy, device)
        validate_fidelity(fidelity, x_noisy, fidelity_weight)
        space = tensor_space(cfg, shape=x_noisy.shape)
        # the fidelity rows use the CALLER's sigma_A, so the tau map is
        # sized against it (Pock-Chambolle: tau_j = 1/(colsum_D_j +
        # sigma_A))
        sigma_D_map, tau_map = precond_maps(
            tuple(x_noisy.shape), cfg.scheme, cfg.reg_z_over_reg,
            cfg.reg_time, sigma_A_rows=sigma_A, dtype=x_noisy.dtype,
            device=x_noisy.device,
        )
    if state is None:
        st = init_state(x_noisy, cfg, space=space)
        carry = (st.x, st.x, st.y_A, st.y_D)
    else:
        st = CPPrecondState(*state)
        carry = (space.place(st.x), space.place(st.x_bar),
                 space.place(st.y_A), space.place(st.y_D, d_volume=True))
    first = space.first(x_noisy)
    losses = torch.empty(n_iter, dtype=first.dtype, device=first.device)
    for i in range(n_iter):
        carry, losses[i] = cp_step_precond(
            carry, x_noisy, reg=reg, sigma_D_map=sigma_D_map,
            tau_map=tau_map, sigma_A=sigma_A, cfg=cfg, fidelity=fidelity,
            fidelity_weight=fidelity_weight, nonneg=nonneg, space=space,
        )
    final = CPPrecondState(*carry)
    return CPResult(x=final.x, state=final, loss=losses)


def pd_gap(state: CPState, x_noisy, reg: float = 25.0,
           cfg: TVConfig = TVConfig(), mask_static=None, weight_time=None):
    """Duality gap of the TV denoising problem at ``(state.x, state.y_D)``,
    a certified distance to optimality:

        gap = P(x) - g(y) >= P(x) - P(x*) >= 0

    with ``P(x) = 1/2 ||x - x0||^2 + reg ||Dx||`` and the dual
    ``g(y) = <D^T y, x0> - 1/2 ||D^T y||^2 - F*(y)`` (for Huber-TV,
    ``F*(y) = delta/(2 reg) ||y||^2``; 0 for iso/aniso).  ``y`` is projected
    onto the dual ball first, so the bound holds for any input.  l2
    fidelity only (the reference denoising model).  On a grid of shards
    (``x_noisy`` and the state's fields grids) every term is a sum over
    shards."""
    if is_grid(x_noisy):
        from ..parallel import entry

        space = entry.solver_space(x_noisy, cfg, mask_static, weight_time)
    else:
        space = tensor_space(cfg, mask_static, weight_time)
    x, y_D = state.x, space.place(state.y_D, d_volume=True)
    y = space.map(lambda a: dual_prox(a, reg, cfg.norm, 0.0,
                                      cfg.huber_delta), y_D)
    primal = space.sum(lambda xs, x0, d: 0.5 * torch.sum(
        torch.square(xs - x0)) + reg * tv_norm(
        d, cfg.norm, huber_delta=cfg.huber_delta),
        space.place(x), x_noisy, space.D(space.place(x)))
    dual = space.sum(lambda d, x0: torch.sum(d * x0) - 0.5 * torch.sum(
        torch.square(d)), space.D_T(y), x_noisy)
    if cfg.norm == "huber":
        dual = dual - cfg.huber_delta / (2.0 * reg) * space.sum(
            lambda a: torch.sum(torch.square(a)), y)
    return primal - dual


def init_state(x_noisy, cfg: TVConfig, x_init=None,
               space: Space = None) -> CPState:
    """A cold start: ``x = x_noisy`` (copied) and zero duals; ``space``
    (``ops.space``) for a grid of shards."""
    space = space or tensor_space(shape=x_noisy.shape)
    Nz, M = space.shape[0], space.shape[1]
    Nd = num_channels(cfg.scheme, Nz, M, cfg.reg_z_over_reg, cfg.reg_time)
    x = space.map(torch.clone, x_noisy if x_init is None else x_init)
    return CPState(x=x, y_A=space.map(torch.zeros_like, x_noisy),
                   y_D=d_zeros(space, x_noisy, Nd))


@solve_span
def chambolle_pock(
    x_noisy,
    n_iter: int = 300,
    reg: float = 25.0,
    sigma_D: float = 0.5,
    sigma_A: float = 1.0,
    tau: float = None,
    cfg: TVConfig = TVConfig(),
    state: CPState = None,
    mask_static=None,
    weight_time=None,
    fused: bool = None,
    dual_dtype=None,
    return_dual: bool = True,
    progress_every: int = 0,
    progress_fn=None,
    fidelity: str = "l2",
    fidelity_weight: float = 1.0,
    nonneg: bool = False,
) -> CPResult:
    """Run ``n_iter`` Chambolle-Pock iterations on ``x_noisy``'s device.

    Defaults are the reference recipe (``README.md:141-143``): sigma_D=0.5,
    sigma_A=1.0, tau=1/(||D||^2 + sigma_A).  Pass ``state`` (a
    :class:`CPState`, e.g. from a previous result or ``interop``) to resume.
    The inputs are never modified.

    ``fused=None`` takes the fused step (``kernels.fused``: the CUDA kernels
    on a CUDA tensor, their plain versions on the CPU) when
    ``kernels.dispatch.can_fuse`` allows it — float32 or bfloat16 storage,
    plane-shaped ``mask_static`` / ``weight_time`` — and the plain
    :func:`cp_step` otherwise (float64, full per-voxel fields).
    ``fused=False`` forces the plain step.  ``dual_dtype='bfloat16'`` (fused
    only) stores the TV dual in bf16.  ``return_dual=False`` drops y_D from
    the result (``state.y_D`` is None).  ``progress_every=k`` calls
    ``progress_fn(iteration, loss)`` on the host every k iterations (only
    those iterations sync).  ``fidelity`` is ``'l2'``, ``'l1'`` or ``'kl'``
    (``x_noisy >= 0``) with a scalar ``fidelity_weight``; ``nonneg=True``
    projects onto x >= 0.

    The loss history stays on the device: one tensor of length ``n_iter``.

    A grid of shards (``parallel.mesh.shard_volume``) is solved on the
    sharded blocks: the fused kernels B1 / B2 (with B8 on the overlapped
    step) for CUDA shards they serve (``parallel.entry.use_kernels``,
    ``chambolle_pock_fused``), else this loop's :func:`cp_step` on
    ``parallel.halo.grid_space``; ``x`` and the state come back as grids
    (``y_D`` in ``shard_d_volume``'s layout), and ``state`` may be a
    :class:`CPState` of grids.
    """
    from ..kernels.dispatch import as_dtype, can_fuse, t_plane_multiplier

    fidelity_weight = _require_scalar_weight(fidelity_weight, "chambolle_pock")
    grid = is_grid(x_noisy)
    if grid:
        from ..parallel import entry

        space = entry.solver_space(x_noisy, cfg, mask_static, weight_time)
        for _, _, part in indexed(x_noisy):
            validate_fidelity(fidelity, part, fidelity_weight)
        fused = entry.use_kernels(x_noisy, cfg, mask_static, weight_time,
                                  fused, want=dual_dtype is not None)
    else:
        space = tensor_space(cfg, mask_static, weight_time, x_noisy.shape)
        validate_fidelity(fidelity, x_noisy, fidelity_weight)
        if fused is None:
            fused = can_fuse(tuple(x_noisy.shape), cfg,
                             mask_static=mask_static, dtype=x_noisy.dtype,
                             weight_time=weight_time)
    shape = space.shape
    device = space.first(x_noisy).device
    if tau is None:
        tau = default_tau(cfg, shape[0], shape[1], sigma_A)
    if dual_dtype is not None and not fused:
        raise ValueError(
            "dual_dtype requires the fused kernel path (fused=True), which "
            "this problem instance does not support (see kernels.dispatch."
            "can_fuse: float32/bfloat16 volumes, plane-shaped masks)"
        )
    dual_dtype = None if dual_dtype is None else as_dtype(dual_dtype)

    if not fused:
        if state is None:
            st = init_state(x_noisy, cfg, space=space)
        else:
            st = CPState(space.place(state[0]), space.place(state[1]),
                         space.place(state[2], d_volume=True))
        losses = torch.empty(n_iter, dtype=space.first(x_noisy).dtype,
                             device=device)
        for i in range(n_iter):
            with span(ITER_SPAN, device):
                st, loss = cp_step(
                    st, x_noisy, reg=reg, sigma_D=sigma_D, sigma_A=sigma_A,
                    tau=tau, cfg=cfg, fidelity=fidelity,
                    fidelity_weight=fidelity_weight, nonneg=nonneg,
                    space=space,
                )
                losses[i] = loss
                emit_progress(i, loss, progress_every, progress_fn)
        if not return_dual:
            st = st._replace(y_D=None)
        return CPResult(x=st.x, state=st, loss=losses)
    if grid:
        return entry.chambolle_pock_fused(
            x_noisy, space, n_iter=n_iter, reg=reg, sigma_D=sigma_D,
            sigma_A=sigma_A, tau=tau, cfg=cfg, state=state,
            mask_static=mask_static, weight_time=weight_time,
            dual_dtype=dual_dtype, return_dual=return_dual,
            each=(lambda i, loss: emit_progress(i, loss, progress_every,
                                                progress_fn))
            if progress_every else None,
            fidelity=fidelity, fidelity_weight=fidelity_weight,
            nonneg=nonneg)

    from ..kernels.fused import (
        cp_step_fused_internal,
        from_internal_layout,
        to_internal_layout,
    )

    # y_D rides the loop in the kernels' channel-contiguous layout (one
    # transpose in, one out); a fresh run allocates it directly in its
    # storage dtype, so a bf16 dual never exists in f32
    tmul = t_plane_multiplier(shape, cfg, mask_static, weight_time,
                              dtype=x_noisy.dtype, device=device)
    if tmul is not None:
        tmul = tmul.float().contiguous()
    x0 = x_noisy.contiguous()
    if state is None:
        Nd = num_channels(cfg.scheme, shape[0], shape[1], cfg.reg_z_over_reg,
                          cfg.reg_time)
        out_dual_dtype = x_noisy.dtype
        y_D_int = torch.zeros((shape[0], shape[1], Nd) + shape[2:],
                              dtype=dual_dtype or x_noisy.dtype, device=device)
        x, y_A = x0.clone(), torch.zeros_like(x0)
    else:
        out_dual_dtype = state.y_D.dtype
        y_D_int = to_internal_layout(state.y_D)
        if dual_dtype is not None:
            y_D_int = y_D_int.to(dual_dtype)
        x = state.x.contiguous().clone()
        y_A = state.y_A.contiguous().clone()

    losses = torch.empty(n_iter, dtype=torch.float32, device=device)
    for i in range(n_iter):
        with span(ITER_SPAN, device):
            x, y_A, y_D_int, loss = cp_step_fused_internal(
                x, y_A, y_D_int, x0, reg=reg, sigma_D=sigma_D,
                sigma_A=sigma_A, tau=tau, cfg=cfg, tmul=tmul,
                fidelity=fidelity, fid_weight=fidelity_weight, nonneg=nonneg,
            )
            losses[i] = loss
            emit_progress(i, loss, progress_every, progress_fn)
    y_D_out = (from_internal_layout(y_D_int).to(out_dual_dtype)
               if return_dual else None)
    final = CPState(x, y_A, y_D_out)
    return CPResult(x=final.x, state=final, loss=losses)
