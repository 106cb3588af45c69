"""Second-order Total Generalized Variation (TGV-2) denoising and linear
inverse problems — the standard fix for first-order TV's staircasing
artifact (Bredies, Kunisch & Pock 2010, doi:10.1137/090769521).  The port of
``pytv4d_tpu/solvers/tgv.py``.

    min_{x, w} 1/2 ||x - x0||^2 + a1 ||D x - w||_{2,1} + a0 ||E w||_{2,1}

where ``D`` is the forward-difference gradient (one-sided zero boundary, as
the reference's TV operators) and ``E`` is the symmetrized Jacobian of the
vector field ``w``.  On piecewise-LINEAR signals TGV recovers the slope (w
tracks the gradient) where TV produces staircases.

Scope: ``axes='2d'`` (default) acts in-plane per (z, t) slice of the
canonical ``(Nz, M, N_row, N_col)`` volume; ``axes='3d'`` couples (z, row,
col): ``w`` becomes a 3-field and ``E`` the 3x3 symmetrized Jacobian (6
channels); ``axes='4d'`` additionally couples time (4-field ``w``,
10-channel ``E``).  Solved with Chambolle-Pock over K = [[D, -I], [0, E]].
The adjoints of ``D`` and ``E`` are written by hand from the
one-sided-difference adjoint (``ops.operators.dt_channel``) and held to
<Kx, y> = <x, K^T y> by ``tests/test_torch_tgv.py``.

:func:`tgv_inverse` replaces the identity data term by ``F(A x)`` for any
linear operator ``A`` (K = [[A, 0], [D, -I], [0, E]]); it runs the plain
loop on every device, as the JAX package runs it without a kernel.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Optional

import numpy as np
import torch

from ..core.schemes import AXIS_COL, AXIS_ROW, AXIS_T, AXIS_Z, BWD, FWD
from ..ops.operators import _safe_sqrt
from ..ops.space import TENSOR, Space, d_zeros
from ..parallel.mesh import is_grid
from ..utils.device import on_device
from ..utils.profiling import ITER_SPAN, TGV_OBJECTIVE_SPAN, solve_span, span
from .fidelity import (
    fidelity_conjugate,
    fidelity_dual_prox,
    fidelity_loss,
    validate_fidelity,
)


class TGVState(NamedTuple):
    """Full CP state for resume/checkpointing (public layouts: w-like
    fields are (Nz, n_w, M, Nr, Nc), q is (Nz, n_q, M, Nr, Nc))."""
    x: torch.Tensor
    xb: torch.Tensor
    w: torch.Tensor
    wb: torch.Tensor
    p: torch.Tensor
    q: torch.Tensor


class TGVInverseState(NamedTuple):
    """Full CP carry of :func:`tgv_inverse` for resume/checkpointing:
    primal x/w with their over-relaxed copies, the fidelity dual y_A, and
    the TGV duals p/q.  ``s_x``/``s_xb`` carry the forward projections
    ``A(x)``/``A(xb)`` so the linearity-derived over-relaxed projection
    (one forward per iteration, see ``solvers.inverse.InverseState``)
    resumes on the uninterrupted run's path; ``None`` is recomputed once."""
    x: torch.Tensor
    xb: torch.Tensor
    w: torch.Tensor
    wb: torch.Tensor
    y_A: torch.Tensor
    p: torch.Tensor
    q: torch.Tensor
    s_x: Optional[torch.Tensor] = None
    s_xb: Optional[torch.Tensor] = None


class TGVResult(NamedTuple):
    x: torch.Tensor     # denoised volume (Nz, M, N_row, N_col)
    w: torch.Tensor     # auxiliary vector field (Nz, n_w, M, N_row, N_col)
    loss: torch.Tensor  # primal objective history, on the device
    state: NamedTuple = None  # TGVState (tgv_denoise) or TGVInverseState
                              # (tgv_inverse); resume via the state kwarg


# ||K_tgv||^2 bounds per axes mode: exact 2D (Bredies et al. sec. 6),
# conservative max(2||D||^2, 2 + ||E||^2) for the coupled modes
TGV_NORM_BOUND_SQ = {
    "2d": 12.0 + math.sqrt(136.0),
    "3d": 24.0,
    "4d": 32.0,
}

# number of w-fields per mode; E has n(n+1)/2 channels
TGV_FIELDS = {"2d": 2, "3d": 3, "4d": 4}

# the volume axes each mode differences, in w's channel order
MODE_AXES = {
    "2d": (AXIS_ROW, AXIS_COL),
    "3d": (AXIS_Z, AXIS_ROW, AXIS_COL),
    "4d": (AXIS_Z, AXIS_T, AXIS_ROW, AXIS_COL),
}


def _q_pairs(n: int):
    """Symmetrized-Jacobian channel order: diagonals then (i, j) with i<j."""
    return [(i, i) for i in range(n)] + [
        (i, j) for i in range(n) for j in range(i + 1, n)
    ]


def _channel(field, i, space: Space):
    return space.map(lambda v: v[:, i], field)


def _d_fwd_axes(x, axes, space: Space = TENSOR):
    """Forward differences of (Nz, M, Nr, Nc) along ``axes`` ->
    (Nz, n, M, Nr, Nc), zero at the far boundary; on ``space``'s fields
    (``ops.space``: a tensor, or a grid of shards with one plane exchanged
    per cut axis)."""
    return space.map(lambda *d: torch.stack(d, dim=1),
                     *[space.d_channel(x, a, FWD) for a in axes])


def _d_fwd_T_axes(p, axes, space: Space = TENSOR):
    """Exact adjoint of :func:`_d_fwd_axes`: (Nz, n, M, Nr, Nc) ->
    (Nz, M, Nr, Nc)."""
    out = space.dt_channel(_channel(p, 0, space), axes[0], FWD)
    for i in range(1, len(axes)):
        out = space.map(torch.add, out, space.dt_channel(
            _channel(p, i, space), axes[i], FWD))
    return out


def _sym_channel(w, axes, i, j, space: Space = TENSOR):
    """Channel (i, j) of the symmetrized Jacobian of the n-field w: d_i w_i
    for i = j, else (d_j w_i + d_i w_j)/2; backward differences, zero at the
    first slot (the discretization dual to the forward ``D``)."""
    def d(f, axis):
        return space.d_channel(_channel(w, f, space), axis, BWD)

    if i == j:
        return d(i, axes[i])
    return space.map(lambda a, b: 0.5 * (a + b), d(i, axes[j]),
                     d(j, axes[i]))


def _sym_grad_axes(w, axes, space: Space = TENSOR):
    """Symmetrized Jacobian of the n-field w (Nz, n, M, Nr, Nc) ->
    (Nz, n(n+1)/2, M, Nr, Nc): :func:`_sym_channel` in the order of
    :func:`_q_pairs`."""
    return space.map(lambda *c: torch.stack(c, dim=1), *[
        _sym_channel(w, axes, i, j, space) for i, j in _q_pairs(len(axes))])


def _sym_grad_T_axes(q, axes, space: Space = TENSOR):
    """Exact adjoint of :func:`_sym_grad_axes`: field i collects its
    diagonal channel scattered along its own axis, plus half of every
    off-diagonal channel that involves i, scattered along the OTHER axis of
    the pair."""
    n = len(axes)
    acc = [None] * n

    def add(i, term):
        acc[i] = term if acc[i] is None else space.map(torch.add, acc[i],
                                                       term)

    def half_dt(c, axis):
        return space.map(lambda a: 0.5 * a, space.dt_channel(
            _channel(q, c, space), axis, BWD))

    for c, (i, j) in enumerate(_q_pairs(n)):
        if i == j:
            add(i, space.dt_channel(_channel(q, c, space), axes[i], BWD))
        else:
            add(i, half_dt(c, axes[j]))
            add(j, half_dt(c, axes[i]))
    return space.map(lambda *f: torch.stack(f, dim=1), *acc)


def _d_fwd(x):
    """In-plane forward differences -> (Nz, 2, M, Nr, Nc), [row, col]."""
    return _d_fwd_axes(x, MODE_AXES["2d"])


def _d_fwd3(x):
    """Volumetric forward differences -> (Nz, 3, M, Nr, Nc), [z, row, col]."""
    return _d_fwd_axes(x, MODE_AXES["3d"])


def _d_fwd4(x):
    """Space-time forward differences -> (Nz, 4, M, Nr, Nc),
    [z, t, row, col]."""
    return _d_fwd_axes(x, MODE_AXES["4d"])


def _sym_grad(w):
    """2-field symmetrized Jacobian -> 3 channels
    [d_r w_r, d_c w_c, (d_c w_r + d_r w_c)/2]."""
    return _sym_grad_axes(w, MODE_AXES["2d"])


def _sym_grad3(w):
    """3-field symmetrized Jacobian -> 6 channels."""
    return _sym_grad_axes(w, MODE_AXES["3d"])


def _sym_grad4(w):
    """4-field symmetrized Jacobian -> 10 channels."""
    return _sym_grad_axes(w, MODE_AXES["4d"])


def _tgv_ops(axes: str, space: Space = TENSOR):
    """(d_fwd, sym_grad, their adjoints, n_w, n_q, ||K_tgv||^2 bound) for an
    axes mode on ``space``'s fields — the same table tgv_denoise uses."""
    if axes not in MODE_AXES:
        raise ValueError(f"axes must be '2d', '3d' or '4d', got {axes!r}")
    ax = MODE_AXES[axes]
    n_w = len(ax)
    return (lambda x: _d_fwd_axes(x, ax, space),
            lambda w: _sym_grad_axes(w, ax, space),
            lambda p: _d_fwd_T_axes(p, ax, space),
            lambda q: _sym_grad_T_axes(q, ax, space),
            n_w, n_w * (n_w + 1) // 2, TGV_NORM_BOUND_SQ[axes])


def tgv_steps(axes: str, sigma_tau_split: float = 1.0):
    """``(sigma, tau)`` of the CP iteration for an axes mode, as Python
    floats: ``sigma = s / L`` and ``tau = 1 / (s L)`` with ``L`` the root
    of :data:`TGV_NORM_BOUND_SQ`."""
    L = math.sqrt(TGV_NORM_BOUND_SQ[axes])
    return float(sigma_tau_split / L), float(1.0 / (sigma_tau_split * L))


def _proj_ball(p, radius):
    n = _safe_sqrt(torch.sum(torch.square(p), dim=1, keepdim=True))
    return p / torch.clamp_min(n / radius, 1.0)


def _tgv_dual_prox(p, radius, norm, sigma, delta):
    """Prox of the conjugate of ``radius * N(.)`` for the TGV norm family
    (channel axis 1): iso L2,1 ball projection; aniso L1,1 box; Huber =
    shrink by ``1 + sigma*delta/radius`` then ball-project (the conjugate
    gains ``delta/(2 radius) |y|^2`` — same rule as solvers/cp.dual_prox)."""
    if norm == "aniso":
        return torch.clamp(p, -radius, radius)
    if norm == "huber":
        p = p / (1.0 + sigma * delta / radius)
    return _proj_ball(p, radius)


def _group_value(acc, norm, delta):
    """A channel group's norm value summed over the voxels, from its
    per-voxel accumulation: the sum of ``|v_c|`` for aniso, else of the
    squares, whose root is the iso norm or the Huber function's
    argument."""
    if norm == "aniso":
        return torch.sum(acc)
    n = _safe_sqrt(acc)
    if norm == "huber":
        return torch.sum(torch.where(n <= delta, torch.square(n) / (2.0 * delta),
                                     n - delta / 2.0))
    return torch.sum(n)


def _tgv_norm_val(v, norm, delta):
    """The TGV term's norm value (channel axis 1): iso L2,1; aniso L1,1;
    Huber of the per-pixel channel 2-norm (ops.operators.compute_huber_norm
    convention)."""
    if norm == "aniso":
        return _group_value(torch.abs(v), norm, delta)
    return _group_value(torch.sum(torch.square(v), dim=1), norm, delta)


def tgv_objective(x, w, x0, axes, alpha1, alpha0, norm="iso",
                  huber_delta=1.0, space: Space = TENSOR):
    """The primal objective at ``(x, w)``, a scalar tensor on the device
    (on a grid, each shard's three terms added, then summed over shards);
    bfloat16 storage is widened to float32 first.  The channels of
    ``D x - w`` and ``E w`` are taken one at a time into a per-voxel
    accumulator of each group, so no stack of them is ever held: a few
    volumes of transients where the stacks took n + n(n+1)/2.  The plain
    version of the objective kernel
    (``kernels.tgv_stream.tgv_stream_objective``)."""
    if space.first(x).dtype == torch.bfloat16:
        x, w, x0 = (space.map(lambda a: a.float(), f) for f in (x, w, x0))
    ax = MODE_AXES[axes]
    term = torch.abs if norm == "aniso" else torch.square

    def add(acc, v):
        t = space.map(term, v)
        return t if acc is None else space.map(lambda a, b: a.add_(b), acc, t)

    acc1 = acc0 = None
    for i, a in enumerate(ax):
        acc1 = add(acc1, space.map(torch.sub, space.d_channel(x, a, FWD),
                                   _channel(w, i, space)))
    for i, j in _q_pairs(len(ax)):
        acc0 = add(acc0, _sym_channel(w, ax, i, j, space))
    return space.sum(
        lambda xs, x0s, a1, a0: 0.5 * torch.sum(torch.square(xs - x0s))
        + alpha1 * _group_value(a1, norm, huber_delta)
        + alpha0 * _group_value(a0, norm, huber_delta),
        x, x0, acc1, acc0)


def _select_path(shape, dtype, axes, n_iter, compute_loss, fused,
                 loss_every, has_state, on_cuda):
    """Kernel-path dispatch for one device: 'resident' (the whole 2d solve
    in one launch), 'stream' (two kernels an iteration, and the objective
    kernel for each loss asked for) or 'plain' (the eager loop over the
    operators above)."""
    if fused is False:
        return "plain"
    from ..kernels.tgv_resident import tgv_resident_fits
    from ..kernels.tgv_stream import stream_fits

    # the resident whole-solve kernel has no state passthrough and cannot
    # sample the loss
    whole_solve = axes == "2d" and not loss_every and not has_state
    resident_ok = whole_solve and tgv_resident_fits(shape, dtype, n_iter,
                                                    compute_loss)
    if fused is None:
        # auto: the kernels for a CUDA tensor; on the CPU their plain
        # versions would only repeat the plain path (tests opt in with
        # fused=True)
        if not on_cuda:
            return "plain"
        return ("resident" if resident_ok
                else "stream" if stream_fits(shape, axes, dtype) else "plain")
    # fused=True: force a kernel path
    if resident_ok or (whole_solve and compute_loss):
        return "resident"
    return "stream"


@solve_span
def tgv_denoise(
    x_noisy,
    n_iter: int = 300,
    alpha1: float = 25.0,
    alpha0: float = 50.0,
    sigma_tau_split: float = 1.0,
    axes: str = "2d",
    compute_loss: bool = True,
    fused: bool = None,
    loss_every: int = 0,
    state: TGVState = None,
    norm: str = "iso",
    huber_delta: float = 1.0,
) -> TGVResult:
    """TGV-2 denoising with Chambolle-Pock on ``x_noisy``'s device.
    ``alpha1`` weighs first-order variation (like TV's reg), ``alpha0`` the
    second-order term — the usual choice is ``alpha0 = 2 * alpha1``.

    ``axes='2d'`` (default): in-plane TGV per (z, t) slice — step sizes use
    the exact 2D bound ``||K||^2 = 12 + sqrt(136)`` (Bredies et al. sec. 6).
    ``axes='3d'``: volumetric TGV coupling (z, row, col), steps from the
    conservative bound ``||K||^2 <= max(2 ||D||^2, 2 + ||E||^2) = 24``.
    ``axes='4d'``: full space-time coupling (z, t, row, col), bound
    ``max(2*16, 2 + 10) = 32``.

    ``compute_loss=False`` skips the per-iteration objective (an extra
    ``D`` + ``E`` application per step); ``loss`` then comes back empty,
    shape ``(0,)``.  ``loss_every=k`` (k > 0, must divide ``n_iter``)
    instead SAMPLES the objective after every k-th iteration — ``loss`` has
    shape ``(n_iter // k,)``.

    ``fused=None`` selects the CUDA kernels for a CUDA tensor: for
    ``axes='2d'`` the whole-solve kernel (kernels/tgv_resident.py, one
    launch) where ``tgv_resident_fits`` holds; otherwise, and for the
    coupled modes, the two streaming kernels per iteration
    (kernels/tgv_stream.py), with the objective kernel after each
    iteration whose loss is asked for, where ``stream_fits`` holds; else
    the plain loop.  A CPU tensor takes the plain loop.  (The JAX package
    runs the per-iteration loss in its plain loop; the port streams it.)
    ``fused=False`` forces the plain loop; ``fused=True`` forces a kernel
    path (on a CPU tensor the wrappers' plain versions — used by the
    parity tests).

    ``state`` resumes a previous run from ``result.state`` (full CP state:
    x, x_bar, w, w_bar, p, q).  A resumed call never uses the whole-solve
    kernel; it continues on the streaming kernels or the plain loop.  The
    inputs are never modified, and the loss history stays on the device.

    Input must be the canonical 4D ``(Nz, M, N_row, N_col)`` tensor
    (``models.TVDenoiser.tgv`` accepts 2D/3D and numpy, and restores the
    rank), or a grid of its shards (``parallel.mesh.shard_volume``), which
    ``parallel.tgv_sharded.tgv_denoise_grid`` solves: x, w and the state
    come back as grids, the loss summed over shards.  ``'2d'`` runs B7 a
    shard on the card; ``'3d'``, and ``'4d'`` on a grid that does not cut
    time, the streaming kernels where a shard of that shape would take
    them; ``'4d'`` on a grid that cuts time runs the plain loop, and
    ``fused=True`` raises there."""
    if is_grid(x_noisy):
        _check_options(axes, n_iter, loss_every, norm)
        from ..parallel.tgv_sharded import tgv_denoise_grid

        return tgv_denoise_grid(
            x_noisy, n_iter=n_iter, alpha1=alpha1, alpha0=alpha0,
            sigma_tau_split=sigma_tau_split, axes=axes,
            compute_loss=compute_loss, fused=fused, loss_every=loss_every,
            state=state, norm=norm, huber_delta=huber_delta)
    if hasattr(x_noisy, "ndim") and x_noisy.ndim != 4:
        raise ValueError(
            f"tgv_denoise expects a rank-4 (Nz, M, N_row, N_col) volume, got "
            f"shape {tuple(x_noisy.shape)}; use models.TVDenoiser(...).tgv "
            f"for 2D/3D inputs"
        )
    if not isinstance(x_noisy, torch.Tensor):
        raise TypeError(
            f"tgv_denoise takes a torch.Tensor, got {type(x_noisy)}; "
            f"models.TVDenoiser(...).tgv takes numpy arrays")
    _check_options(axes, n_iter, loss_every, norm)
    path = _select_path(tuple(x_noisy.shape), x_noisy.dtype, axes, n_iter,
                        compute_loss, fused, loss_every, state is not None,
                        x_noisy.is_cuda)
    kw = dict(n_iter=n_iter, alpha1=alpha1, alpha0=alpha0,
              sigma_tau_split=sigma_tau_split, norm=norm,
              huber_delta=huber_delta)
    if path == "resident":
        from ..kernels.tgv_resident import tgv_resident_solve

        x, w, xb, wb, p, q, losses = tgv_resident_solve(
            x_noisy.contiguous(), compute_loss=compute_loss, **kw)
        st = TGVState(x=x, xb=xb, w=w, wb=wb, p=p, q=q)
        return TGVResult(x=x, w=w, loss=losses, state=st)
    run = _run_stream if path == "stream" else run_plain
    return run(x_noisy, state, axes=axes, compute_loss=compute_loss,
               loss_every=loss_every, **kw)


def _check_options(axes, n_iter, loss_every, norm):
    if axes not in ("2d", "3d", "4d"):
        raise ValueError(f"axes must be '2d', '3d' or '4d', got {axes!r}")
    if loss_every and (loss_every < 0 or n_iter % loss_every):
        raise ValueError(
            f"loss_every must be a positive divisor of n_iter, got "
            f"loss_every={loss_every} with n_iter={n_iter}"
        )
    if norm not in ("iso", "aniso", "huber"):
        raise ValueError(f"norm must be 'iso', 'aniso' or 'huber', got "
                         f"{norm!r}")


def _init_state(x0, axes, space: Space = TENSOR) -> TGVState:
    """A cold start: ``x = xb = x0`` (copied) and zero w, duals."""
    n_w = TGV_FIELDS[axes]

    def zeros(n):
        return d_zeros(space, x0, n)

    return TGVState(space.map(torch.clone, x0), space.map(torch.clone, x0),
                    zeros(n_w), zeros(n_w), zeros(n_w),
                    zeros(n_w * (n_w + 1) // 2))


def loss_dtype(dtype):
    """The objective's dtype: a bfloat16 state's is float32."""
    return torch.float32 if dtype == torch.bfloat16 else dtype


def _iterate(step, st, x0, *, n_iter, axes, alpha1, alpha0, norm,
             huber_delta, compute_loss, loss_every, objective=tgv_objective,
             space: Space = TENSOR) -> TGVResult:
    """Run ``step`` ``n_iter`` times from ``st``, recording the objective
    every iteration (``compute_loss``) or every ``loss_every``-th, by
    ``objective`` (:func:`tgv_objective`'s signature).  Each iteration is
    a ``pytv.iter`` span and each evaluation a ``pytv.tgv.objective`` span
    inside it (``utils.profiling``)."""
    every = loss_every or (1 if compute_loss else 0)
    first = space.first(x0)
    losses = torch.empty(n_iter // every if every else 0,
                         dtype=loss_dtype(first.dtype), device=first.device)
    for i in range(n_iter):
        with span(ITER_SPAN, first.device):
            st = step(st)
            if every and (i + 1) % every == 0:
                with span(TGV_OBJECTIVE_SPAN, first.device):
                    losses[i // every] = objective(
                        st.x, st.w, x0, axes, alpha1, alpha0, norm,
                        huber_delta, space)
    return TGVResult(x=st.x, w=st.w, loss=losses, state=st)


def run_plain(x0, state, *, axes, sigma_tau_split, space: Space = TENSOR,
              **kw) -> TGVResult:
    """The plain loop (no kernel) on ``space``'s fields (``ops.space``:
    a tensor, or a grid of shards of any cut)."""
    d_fwd, sym_grad, d_T, sym_T, *_ = _tgv_ops(axes, space)
    sigma, tau = tgv_steps(axes, sigma_tau_split)
    alpha1, alpha0 = kw["alpha1"], kw["alpha0"]
    norm, delta = kw["norm"], kw["huber_delta"]

    def step(st):
        x, xb, w, wb, p, q = st
        p = space.map(lambda ps, d, wbs: _tgv_dual_prox(
            ps + sigma * (d - wbs), alpha1, norm, sigma, delta),
            p, d_fwd(xb), wb)
        q = space.map(lambda qs, e: _tgv_dual_prox(
            qs + sigma * e, alpha0, norm, sigma, delta), q, sym_grad(wb))
        x_new = space.map(lambda xs, d, x0s: (xs - tau * d + tau * x0s)
                          / (1.0 + tau), x, d_T(p), x0)
        w_new = space.map(lambda ws, ps, e: ws - tau * (-ps + e), w, p,
                          sym_T(q))
        return TGVState(x_new, space.map(lambda a, b: 2.0 * a - b, x_new, x),
                        w_new, space.map(lambda a, b: 2.0 * a - b, w_new, w),
                        p, q)

    st = (_init_state(x0, axes, space) if state is None
          else TGVState(*state))
    return _iterate(step, st, x0, axes=axes, space=space, **kw)


def _run_stream(x0, state, *, axes, sigma_tau_split, **kw):
    from ..kernels.tgv_stream import tgv_stream_objective, tgv_stream_step

    x0 = x0.contiguous()
    if state is None:
        st = _init_state(x0, axes)
    else:  # the step updates its state in place: work on a copy
        st = TGVState(*(t.to(x0.dtype).clone(
            memory_format=torch.contiguous_format) for t in state))
    step_kw = dict(mode=axes, alpha1=kw["alpha1"], alpha0=kw["alpha0"],
                   sigma_tau_split=sigma_tau_split, norm=kw["norm"],
                   huber_delta=kw["huber_delta"])

    def step(st):
        return TGVState(*tgv_stream_step(*st, x0, **step_kw))

    return _iterate(step, st, x0, axes=axes, objective=tgv_stream_objective,
                    **kw)


def _axis_mask(vol_shape, dim, kind, dtype, device):
    """Boundary-validity mask broadcast over the volume: ``kind='ge1'`` is
    1 where index >= 1 along ``dim``; ``'lem2'`` is 1 where index <= N-2."""
    n = vol_shape[dim]
    idx = torch.arange(n, device=device)
    m = (idx >= 1) if kind == "ge1" else (idx <= n - 2)
    shape = [1] * len(vol_shape)
    shape[dim] = n
    return m.to(dtype).reshape(shape)


def _mask_field(template, vol_shape, dim, kind, dtype, device):
    """:func:`_axis_mask` as a field of ``template``'s kind: the mask
    itself, which broadcasts against a tensor and, along an axis the mesh
    does not cut, against every shard; along a cut axis each shard's own
    planes of it."""
    from ..parallel.mesh import grid_like, indexed

    m = _axis_mask(vol_shape, dim, kind, dtype, device)
    if not is_grid(template) or dim > 1:
        return m
    cells = []
    for iz, it, part in indexed(template):
        k, n = (iz, it)[dim], part.shape[dim]
        cells.append(m[k * n:(k + 1) * n] if dim == 0
                     else m[:, k * n:(k + 1) * n])
    return grid_like(template, cells)


def _tgv_precond_maps(vol_shape, axes, dtype, device, norm="iso", A=None,
                      A_T=None, b=None, space: Space = TENSOR,
                      template=None):
    """Pock-Chambolle (2011, alpha=1) diagonal preconditioners for
    K = [[A, 0], [D, -I], [0, E]] from EXACT row/column absolute sums:
    D/E stencils have coefficients +-1 and +-0.5 with known boundary
    structure, so their abs-sums are closed-form per-axis boundary masks;
    the CT projectors (and blur/masking operators) have NONNEGATIVE
    coefficients, so ``|A| 1 = A 1`` and ``|A|^T 1 = A^T 1`` exactly.

    Dual steps: for the separable ANISO norm, per-channel reciprocal row
    sums (lists of rank-4 broadcastable masks: exact prox per channel).
    For the GROUPED iso/Huber norms the channel-group ball/shrink prox is
    exact only with one step per pixel group, so sigma is the per-pixel
    group MINIMUM of the channel bounds (rank-5-broadcastable via a
    length-1 channel axis): below the row-sum bound, so the step condition
    ``||Sigma^1/2 K T^1/2|| <= 1`` still holds.  Primal steps are always
    separable: per-field lists.  All masks stay broadcastable (nothing
    volume-sized beyond ``|A|^T 1``, which is real data).  On ``space``'s
    fields: ``template`` is a volume field (its shards give each mask's
    part), ``b`` the data."""
    dims = MODE_AXES[axes]
    n = len(dims)
    M = space.map

    def ge1(d):
        return _mask_field(template, vol_shape, d, "ge1", dtype, device)

    def lem2(d):
        return _mask_field(template, vol_shape, d, "lem2", dtype, device)

    # dual of (D x - w): row sum = 2*[fwd slot valid] + 1 (the -I entry)
    sp = [M(lambda m: 1.0 / (2.0 * m + 1.0), lem2(d)) for d in dims]
    # dual of E w: diag channel rows sum to 2*[bwd valid]; off-diag (i, j)
    # rows sum to |0.5|*2 per valid part (all-zero rows: the dual stays 0,
    # any finite step is fine)
    sq = []
    for (i, j) in _q_pairs(n):
        r = (M(lambda g: 2.0 * g, ge1(dims[i])) if i == j
             else M(torch.add, ge1(dims[j]), ge1(dims[i])))
        sq.append(M(lambda r: 1.0 / torch.where(r == 0, 1.0, r), r))
    if norm == "aniso":  # tuples: a grid of shards is a list
        sig_p, sig_q = tuple(sp), tuple(sq)
    else:
        def group_min(*a):
            return functools.reduce(torch.minimum, a)[:, None]

        sig_p, sig_q = M(group_min, *sp), M(group_min, *sq)

    # primal x: |A|^T 1 + per-axis fwd-diff column sums
    tx_den = M(lambda *m: sum(m[2 * k] + m[2 * k + 1] for k in range(n)),
               *[f for d in dims for f in (lem2(d), ge1(d))])
    if A is not None:
        tx_den = M(torch.add, tx_den, A_T(M(torch.ones_like, b)))
    T_x = M(lambda t: 1.0 / torch.where(t == 0, 1.0, t), tx_den)
    # primal w_i: 1 (the -I) + bwd column sums from every E channel:
    # separable, so per-field exactness holds for every norm
    T_w = []
    for i in range(n):
        den = M(lambda g, m: 1.0 + g + m, ge1(dims[i]), lem2(dims[i]))
        for j in range(n):
            if j != i:
                den = M(lambda dd, g, m: dd + 0.5 * (g + m), den,
                        ge1(dims[j]), lem2(dims[j]))
        T_w.append(M(lambda dd: 1.0 / dd, den))
    T_w = tuple(T_w)

    sig_A = None
    if A is not None:
        from .inverse import _reciprocal_rows

        sig_A = _reciprocal_rows(A(M(torch.ones_like, template)), space)
    return sig_A, sig_p, sig_q, T_x, T_w


def _chanmul(maps, arr):
    """Multiply a channel-stacked rank-5 tensor by per-channel rank-4
    broadcastable maps (or by one scalar or rank-5-broadcastable map)."""
    if isinstance(maps, (list, tuple)):
        return torch.stack([maps[i] * arr[:, i] for i in range(len(maps))],
                           dim=1)
    return maps * arr


def _chanmul_on(space: Space, maps, arr):
    """:func:`_chanmul` on ``space``'s fields (``maps`` a scalar, a field
    or a tuple of fields, one a channel)."""
    if isinstance(maps, tuple):
        return space.map(lambda a, *m: _chanmul(list(m), a), arr, *maps)
    return space.map(lambda m, a: _chanmul(m, a), maps, arr)


def tgv_gap_inverse(
    state: TGVInverseState,
    A,
    b,
    alpha1: float = 1.0,
    alpha0: float = 2.0,
    axes: str = "2d",
    norm: str = "iso",
    huber_delta: float = 1.0,
    fidelity: str = "l2",
    fidelity_weight=1.0,
    x_box: float = None,
    w_box: float = None,
    A_T=None,
):
    """Certified duality gap for the TGV-2 inverse problem

        min_{(x, w) in C} F(A x) + a1 N(D x - w) + a0 N(E w)

    at ``(state.x, state.w, state.y_A, state.p, state.q)``: the TGV
    counterpart of ``solvers.inverse.pd_gap_inverse`` over the two primal
    blocks of K = [[A, 0], [D, -I], [0, E]]:

        gap = P(x, w) + F*(y_A) + N1*(p) + N0*(q)
            + sup_{x in Cx} <-r_x, x> + sup_{w in Cw} <-r_w, w>,
        r_x = A^T y_A + D^T p,   r_w = -p + E^T q,

    with the duals projected feasible first (a1/a0 balls or boxes; Huber
    conjugates gain the quadratic).  The prior sets: ``x_box = c`` is the
    physical bound ``0 <= x <= c``; ``w_box`` bounds the auxiliary field
    componentwise, ``|w| <= w_box`` (w tracks the gradient of x, so the
    gradient bound of a ``[0, c]`` image, ``w_box = c``, is the default).
    Both support terms vanish as the dual residuals converge."""
    if x_box is None:
        raise ValueError(
            "tgv_gap_inverse needs the compact prior set: pass x_box=c "
            "(0 <= x <= c; w_box defaults to c — the gradient bound of a "
            "[0, c] image)"
        )
    if w_box is None:
        w_box = x_box
    d_fwd, sym_grad, d_T, sym_T, *_ = _tgv_ops(axes)
    x, w, y_A, p, q = state.x, state.w, state.y_A, state.p, state.q
    primal = fidelity_loss(A(x), b, fidelity, fidelity_weight) + (
        alpha1 * _tgv_norm_val(d_fwd(x) - w, norm, huber_delta)
        + alpha0 * _tgv_norm_val(sym_grad(w), norm, huber_delta)
    )
    y_A, f_star = fidelity_conjugate(y_A, b, fidelity, fidelity_weight)
    p = _tgv_dual_prox(p, alpha1, norm, 0.0, huber_delta)
    q = _tgv_dual_prox(q, alpha0, norm, 0.0, huber_delta)
    tv_star = 0.0
    if norm == "huber":
        tv_star = (huber_delta / (2.0 * alpha1) * torch.sum(torch.square(p))
                   + huber_delta / (2.0 * alpha0) * torch.sum(torch.square(q)))
    if A_T is None:
        from .inverse import cached_transpose

        A_T = cached_transpose(A, tuple(x.shape), x.dtype)
    r_x = A_T(y_A) + d_T(p)
    r_w = -p + sym_T(q)
    sup_x = x_box * torch.sum(torch.clamp_min(-r_x, 0.0))
    sup_w = w_box * torch.sum(torch.abs(r_w))   # sign-free box on w
    return primal + f_star + tv_star + sup_x + sup_w


def tgv_inverse(
    A,
    b,
    vol_shape,
    A_T=None,
    n_iter: int = 100,
    alpha1: float = 1.0,
    alpha0: float = 2.0,
    axes: str = "2d",
    op_norm: float = None,
    x_init=None,
    precond: bool = False,
    norm: str = "iso",
    huber_delta: float = 1.0,
    fidelity: str = "l2",
    fidelity_weight=1.0,
    nonneg: bool = False,
    state: TGVInverseState = None,
    device=None,
) -> TGVResult:
    """TGV-2-regularized linear inverse problem:

        min_{x, w} F(A x) + a1 ||D x - w||_{2,1} + a0 ||E w||_{2,1}

    for any linear forward operator ``A`` made of torch ops (CT projection,
    blur, inpainting masks, ...): the TGV counterpart of
    ``solvers.inverse.cp_inverse``, removing first-order TV's staircasing
    from reconstructions of piecewise-linear objects (classic TGV-CT).
    Chambolle-Pock over K = [[A, 0], [D, -I], [0, E]]; ``A_T`` defaults to
    the exact transpose (the vjp); step rule
    ``sigma = tau = 1/sqrt(||A||^2 + ||K_tgv||^2)`` with the per-axes-mode
    TGV block bound of ``tgv_denoise``.  ``models.ct.tgv_reconstruct`` is
    this solver specialized to the CT projector.  The solve is the plain
    eager loop on the device of ``b`` (``utils.device``: a numpy ``b`` goes
    to the CUDA device unless ``device`` names another).

    ``precond=True`` switches to the diagonally preconditioned iteration
    (Pock & Chambolle 2011, alpha=1): per-element step sizes from the exact
    row/column absolute sums of K (closed-form boundary masks for D/E; the
    operator's own row/column sums for A, exact whenever A has nonnegative
    coefficients).  No ``op_norm`` or power iteration needed.

    ``fidelity`` selects the data term ``F`` (``solvers.fidelity``):
    ``'l2'`` (default), ``'l1'`` (impulsive noise), ``'kl'`` (Poisson
    counts, ``b >= 0``); ``fidelity_weight`` a scalar or per-measurement
    array.  ``nonneg=True`` projects the primal onto ``x >= 0``.  ``state``
    resumes from ``result.state``.  The loop is :func:`tgv_inverse_on`,
    which a grid of shards runs too (``models.ct.tgv_reconstruct``)."""
    from .inverse import (
        _bind_operator,
        _Fields,
        _tensor_tv_half,
        cached_transpose,
    )
    from ..ops.space import tensor_space

    b = on_device(b, device)
    dtype, device = b.dtype, b.device
    validate_fidelity(fidelity, b, fidelity_weight)
    vol_shape = tuple(int(n) for n in vol_shape)
    if len(vol_shape) != 4:
        raise ValueError(
            f"tgv_inverse expects a rank-4 (Nz, M, N_row, N_col) vol_shape, "
            f"got {vol_shape}"
        )
    if A_T is None:
        A_T = cached_transpose(A, vol_shape, dtype)
    A_, A_T_ = _bind_operator(A, A_T, vol_shape, dtype)

    def place(a, kind="volume"):
        return None if a is None else torch.as_tensor(a, device=device)

    def start(seed):
        return on_device(np.random.default_rng(seed).standard_normal(
            vol_shape), device, dtype)

    fields = _Fields(tensor_space(shape=vol_shape), A_, A_T_, place, None,
                     start, _tensor_tv_half, False)
    return tgv_inverse_on(
        fields, b, n_iter=n_iter, alpha1=alpha1, alpha0=alpha0, axes=axes,
        op_norm=op_norm, x_init=x_init, precond=precond, norm=norm,
        huber_delta=huber_delta, fidelity=fidelity,
        fidelity_weight=fidelity_weight, nonneg=nonneg, state=state)


def tgv_inverse_on(fields, b, *, n_iter, alpha1, alpha0, axes, op_norm,
                   x_init, precond, norm, huber_delta, fidelity,
                   fidelity_weight, nonneg, state) -> TGVResult:
    """:func:`tgv_inverse` on ``fields`` (``solvers.inverse._Fields``: a
    tensor's, or a grid's from ``solvers.inverse.grid_fields``, where the
    operator norm, the preconditioners' floors and the loss are taken over
    the whole grid)."""
    from .inverse import _check_nonneg_rows, _power_norm

    space = fields.space
    vol_shape = space.shape
    first = space.first(b)
    dtype, device = first.dtype, first.device
    if norm not in ("iso", "aniso", "huber"):
        raise ValueError(f"norm must be 'iso', 'aniso' or 'huber', got "
                         f"{norm!r}")
    d_fwd, sym_grad, d_T, sym_T, n_w, n_q, L_sq = _tgv_ops(axes, space)
    A_, A_T_ = fields.A, fields.A_T
    if precond:
        if op_norm is not None:
            raise ValueError(
                "op_norm and precond=True are mutually exclusive — the "
                "preconditioned steps come from the operator's exact "
                "row/column sums, not an operator-norm bound"
            )
        _check_nonneg_rows(A_(fields.place(torch.ones(vol_shape,
                                                      dtype=dtype))),
                           space, "tgv_inverse")
    elif op_norm is None:
        op_norm = float(_power_norm(A_, A_T_, fields.start(0), space,
                                    12))
    M = space.map
    zeros = fields.place(torch.zeros(vol_shape, dtype=dtype))
    if precond:
        sig_A, sig_p, sig_q, T_x, T_w = _tgv_precond_maps(
            vol_shape, axes, dtype, device, norm=norm, A=A_, A_T=A_T_, b=b,
            space=space, template=zeros)
    else:
        sig_A = sig_p = sig_q = T_x = T_w = float(
            1.0 / math.sqrt(op_norm ** 2 + L_sq))

    if np.ndim(fidelity_weight) == 0 and not is_grid(fidelity_weight):
        fw = torch.as_tensor(fidelity_weight, dtype=dtype, device=device)
    else:
        fw = M(lambda t: t.to(dtype), fields.place(fidelity_weight, "data"))
    if state is None:
        x = (zeros if x_init is None
             else M(lambda t: t.to(dtype), fields.place(x_init)))
        w = d_zeros(space, zeros, n_w)
        q = d_zeros(space, zeros, n_q)
        xb, wb, y_A, p = x, w, M(torch.zeros_like, b), w
        sAx = sAxb = A_(x)
    else:
        st = TGVInverseState(*(fields.place(t, kind) for t, kind in zip(
            state, ("volume", "volume", "d_volume", "d_volume", "data",
                    "d_volume", "d_volume", "data", "data"))))
        x, xb, w, wb, y_A, p, q = st[:7]
        sAx = A_(x) if st.s_x is None else st.s_x
        sAxb = A_(xb) if st.s_xb is None else st.s_xb

    def primal_x(xs, t, at, dt):
        xn = xs - t * (at + dt)
        return torch.clamp_min(xn, 0.0) if nonneg else xn

    losses = torch.empty(n_iter, dtype=dtype, device=device)
    for i in range(n_iter):
        # linearity rewrite (solvers.inverse): A(xb) = 2 A(x_new) - A(x)
        # from the carried projections: one forward and one adjoint per
        # iteration, and the loss reuses the same A(x_new)
        y_A = M(lambda ya, s, bs, sa, fws: fidelity_dual_prox(
            ya, s, bs, sa, fidelity, fws), y_A, sAxb, b, sig_A, fw)
        p = M(lambda ps, c, sg: _tgv_dual_prox(ps + c, alpha1, norm, sg,
                                              huber_delta),
              p, _chanmul_on(space, sig_p, M(torch.sub, d_fwd(xb), wb)),
              0.0 if isinstance(sig_p, tuple) else sig_p)
        q = M(lambda qs, c, sg: _tgv_dual_prox(qs + c, alpha0, norm, sg,
                                              huber_delta),
              q, _chanmul_on(space, sig_q, sym_grad(wb)),
              0.0 if isinstance(sig_q, tuple) else sig_q)
        x_new = M(primal_x, x, T_x, A_T_(y_A), d_T(p))
        w_new = M(lambda ws, c: ws - c, w, _chanmul_on(
            space, T_w, M(lambda ps, e: -ps + e, p, sym_T(q))))
        xb = M(lambda a, c: 2.0 * a - c, x_new, x)
        wb = M(lambda a, c: 2.0 * a - c, w_new, w)
        s_new = A_(x_new)
        x, w, sAx, sAxb = x_new, w_new, s_new, M(
            lambda sn, s: 2.0 * sn - s, s_new, sAx)
        losses[i] = space.sum(
            lambda sn, bs, fws, d, ws, e: fidelity_loss(sn, bs, fidelity,
                                                         fws)
            + alpha1 * _tgv_norm_val(d - ws, norm, huber_delta)
            + alpha0 * _tgv_norm_val(e, norm, huber_delta),
            s_new, b, fw, d_fwd(x), w, sym_grad(w))
    final = TGVInverseState(x, xb, w, wb, y_A, p, q, sAx, sAxb)
    return TGVResult(x=final.x, w=final.w, loss=losses, state=final)
