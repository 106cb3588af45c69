"""Second-order Total Generalized Variation (TGV-2) denoising — the standard
fix for first-order TV's staircasing artifact (Bredies, Kunisch & Pock 2010,
doi:10.1137/090769521).  The port of the denoising half of
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

Not ported yet: ``tgv_inverse``, ``tgv_gap_inverse`` and their
preconditioner maps, which need ``solvers/inverse.py`` (ROADMAP.md queue A).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..core.schemes import AXIS_COL, AXIS_ROW, AXIS_T, AXIS_Z, BWD, FWD
from ..ops.operators import _safe_sqrt, d_channel, dt_channel


class TGVState(NamedTuple):
    """Full CP state for resume/checkpointing (public layouts: w-like
    fields are (Nz, n_w, M, Nr, Nc), q is (Nz, n_q, M, Nr, Nc))."""
    x: torch.Tensor
    xb: torch.Tensor
    w: torch.Tensor
    wb: torch.Tensor
    p: torch.Tensor
    q: torch.Tensor


class TGVResult(NamedTuple):
    x: torch.Tensor     # denoised volume (Nz, M, N_row, N_col)
    w: torch.Tensor     # auxiliary vector field (Nz, n_w, M, N_row, N_col)
    loss: torch.Tensor  # primal objective history, on the device
    state: TGVState = None  # resume via the state kwarg


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


def _d_fwd_axes(x, axes):
    """Forward differences of (Nz, M, Nr, Nc) along ``axes`` ->
    (Nz, n, M, Nr, Nc), zero at the far boundary."""
    return torch.stack([d_channel(x, a, FWD) for a in axes], dim=1)


def _d_fwd_T_axes(p, axes):
    """Exact adjoint of :func:`_d_fwd_axes`: (Nz, n, M, Nr, Nc) ->
    (Nz, M, Nr, Nc)."""
    out = dt_channel(p[:, 0], axes[0], FWD)
    for i in range(1, len(axes)):
        out = out + dt_channel(p[:, i], axes[i], FWD)
    return out


def _sym_grad_axes(w, axes):
    """Symmetrized Jacobian of the n-field w (Nz, n, M, Nr, Nc) ->
    (Nz, n(n+1)/2, M, Nr, Nc): the diagonals d_i w_i, then
    (d_j w_i + d_i w_j)/2 for i < j; backward differences, zero at the first
    slot (the discretization dual to the forward ``D``)."""
    out = []
    for i, j in _q_pairs(len(axes)):
        if i == j:
            out.append(d_channel(w[:, i], axes[i], BWD))
        else:
            out.append(0.5 * (d_channel(w[:, i], axes[j], BWD)
                              + d_channel(w[:, j], axes[i], BWD)))
    return torch.stack(out, dim=1)


def _sym_grad_T_axes(q, axes):
    """Exact adjoint of :func:`_sym_grad_axes`: field i collects its
    diagonal channel scattered along its own axis, plus half of every
    off-diagonal channel that involves i, scattered along the OTHER axis of
    the pair."""
    n = len(axes)
    acc = [None] * n

    def add(i, term):
        acc[i] = term if acc[i] is None else acc[i] + term

    for c, (i, j) in enumerate(_q_pairs(n)):
        if i == j:
            add(i, dt_channel(q[:, c], axes[i], BWD))
        else:
            add(i, 0.5 * dt_channel(q[:, c], axes[j], BWD))
            add(j, 0.5 * dt_channel(q[:, c], axes[i], BWD))
    return torch.stack(acc, dim=1)


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


def _tgv_ops(axes: str):
    """(d_fwd, sym_grad, their adjoints, n_w, n_q, ||K_tgv||^2 bound) for an
    axes mode — the same table tgv_denoise uses."""
    if axes not in MODE_AXES:
        raise ValueError(f"axes must be '2d', '3d' or '4d', got {axes!r}")
    ax = MODE_AXES[axes]
    n_w = len(ax)
    return (lambda x: _d_fwd_axes(x, ax), lambda w: _sym_grad_axes(w, ax),
            lambda p: _d_fwd_T_axes(p, ax), lambda q: _sym_grad_T_axes(q, ax),
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


def _tgv_norm_val(v, norm, delta):
    """The TGV term's norm value (channel axis 1): iso L2,1; aniso L1,1;
    Huber of the per-pixel channel 2-norm (ops.operators.compute_huber_norm
    convention)."""
    if norm == "aniso":
        return torch.sum(torch.abs(v))
    n = _safe_sqrt(torch.sum(torch.square(v), dim=1))
    if norm == "huber":
        return torch.sum(torch.where(n <= delta, torch.square(n) / (2.0 * delta),
                                     n - delta / 2.0))
    return torch.sum(n)


def tgv_objective(x, w, x0, axes, alpha1, alpha0, norm="iso",
                  huber_delta=1.0):
    """The primal objective at ``(x, w)``, a scalar tensor on the device;
    bfloat16 storage is widened to float32 first."""
    if x.dtype == torch.bfloat16:
        x, w, x0 = x.float(), w.float(), x0.float()
    ax = MODE_AXES[axes]
    return (0.5 * torch.sum(torch.square(x - x0))
            + alpha1 * _tgv_norm_val(_d_fwd_axes(x, ax) - w, norm, huber_delta)
            + alpha0 * _tgv_norm_val(_sym_grad_axes(w, ax), norm, huber_delta))


def _select_path(shape, dtype, axes, n_iter, compute_loss, fused,
                 loss_every, has_state, on_cuda):
    """Kernel-path dispatch for one device: 'resident' (the whole 2d solve
    in one launch), 'stream' (two kernels per iteration; coupled modes,
    resumed and sampled-loss solves) or 'plain' (the eager loop over the
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
    stream_possible = ((not compute_loss or bool(loss_every))
                       and (bool(fused) or stream_fits(shape, axes, dtype)))
    if fused is None:
        # auto: the kernels for a CUDA tensor; on the CPU their plain
        # versions would only repeat the plain path (tests opt in with
        # fused=True)
        if not on_cuda:
            return "plain"
        return ("resident" if resident_ok
                else "stream" if stream_possible else "plain")
    # fused=True: force a kernel path where one can serve
    if resident_ok or (whole_solve and compute_loss):
        return "resident"
    if stream_possible:
        return "stream"
    if has_state:
        # a resumed call continues on the stream kernels or the plain loop;
        # here only the plain loop can serve (per-iteration loss)
        return "plain"
    raise ValueError(
        "fused=True cannot serve this combination: the streaming TGV "
        "kernels (kernels/tgv_stream.py, the only fused path for "
        "axes='3d'/'4d' and resumed 2d solves) need compute_loss=False or "
        "loss_every=k"
    )


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
    shape ``(n_iter // k,)`` — which is also the only way to get a loss
    series out of the streaming kernels, which do not fuse the loss.

    ``fused=None`` selects the CUDA kernels for a CUDA tensor: for
    ``axes='2d'`` the whole-solve kernel (kernels/tgv_resident.py, one
    launch) where ``tgv_resident_fits`` holds; otherwise, and for the
    coupled modes, the two streaming kernels per iteration
    (kernels/tgv_stream.py) when ``compute_loss=False`` or ``loss_every=k``;
    else the plain loop.  A CPU tensor takes the plain loop.
    ``fused=False`` forces the plain loop; ``fused=True`` forces a kernel
    path (on a CPU tensor the wrappers' plain versions — used by the
    parity tests).

    ``state`` resumes a previous run from ``result.state`` (full CP state:
    x, x_bar, w, w_bar, p, q).  A resumed call never uses the whole-solve
    kernel; it continues on the streaming kernels or the plain loop.  The
    inputs are never modified, and the loss history stays on the device.

    Input must be the canonical 4D ``(Nz, M, N_row, N_col)`` tensor
    (``models.TVDenoiser.tgv`` accepts 2D/3D and numpy, and restores the
    rank)."""
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
    if axes not in ("2d", "3d", "4d"):
        raise ValueError(f"axes must be '2d', '3d' or '4d', got {axes!r}")
    if loss_every:
        if loss_every < 0 or n_iter % loss_every:
            raise ValueError(
                f"loss_every must be a positive divisor of n_iter, got "
                f"loss_every={loss_every} with n_iter={n_iter}"
            )
    path = _select_path(tuple(x_noisy.shape), x_noisy.dtype, axes, n_iter,
                        compute_loss, fused, loss_every, state is not None,
                        x_noisy.is_cuda)
    if norm not in ("iso", "aniso", "huber"):
        raise ValueError(f"norm must be 'iso', 'aniso' or 'huber', got "
                         f"{norm!r}")
    kw = dict(n_iter=n_iter, alpha1=alpha1, alpha0=alpha0,
              sigma_tau_split=sigma_tau_split, norm=norm,
              huber_delta=huber_delta)
    if path == "resident":
        from ..kernels.tgv_resident import tgv_resident_solve

        x, w, xb, wb, p, q, losses = tgv_resident_solve(
            x_noisy.contiguous(), compute_loss=compute_loss, **kw)
        st = TGVState(x=x, xb=xb, w=w, wb=wb, p=p, q=q)
        return TGVResult(x=x, w=w, loss=losses, state=st)
    run = _run_stream if path == "stream" else _run_plain
    return run(x_noisy, state, axes=axes, compute_loss=compute_loss,
               loss_every=loss_every, **kw)


def _init_state(x0, axes) -> TGVState:
    """A cold start: ``x = xb = x0`` (copied) and zero w, duals."""
    n_w = TGV_FIELDS[axes]
    Nz, M, Nr, Nc = x0.shape

    def zeros(n):
        return torch.zeros((Nz, n, M, Nr, Nc), dtype=x0.dtype,
                           device=x0.device)

    return TGVState(x0.clone(), x0.clone(), zeros(n_w), zeros(n_w),
                    zeros(n_w), zeros(n_w * (n_w + 1) // 2))


def _iterate(step, st, x0, *, n_iter, axes, alpha1, alpha0, norm,
             huber_delta, compute_loss, loss_every) -> TGVResult:
    """Run ``step`` ``n_iter`` times from ``st``, recording the objective
    every iteration (``compute_loss``) or every ``loss_every``-th."""
    every = loss_every or (1 if compute_loss else 0)
    loss_dtype = torch.float32 if x0.dtype == torch.bfloat16 else x0.dtype
    losses = torch.empty(n_iter // every if every else 0, dtype=loss_dtype,
                         device=x0.device)
    for i in range(n_iter):
        st = step(st)
        if every and (i + 1) % every == 0:
            losses[i // every] = tgv_objective(st.x, st.w, x0, axes, alpha1,
                                               alpha0, norm, huber_delta)
    return TGVResult(x=st.x, w=st.w, loss=losses, state=st)


def _run_plain(x0, state, *, axes, sigma_tau_split, **kw):
    d_fwd, sym_grad, d_T, sym_T, *_ = _tgv_ops(axes)
    sigma, tau = tgv_steps(axes, sigma_tau_split)
    alpha1, alpha0 = kw["alpha1"], kw["alpha0"]
    norm, delta = kw["norm"], kw["huber_delta"]

    def step(st):
        x, xb, w, wb, p, q = st
        p = _tgv_dual_prox(p + sigma * (d_fwd(xb) - wb), alpha1, norm,
                           sigma, delta)
        q = _tgv_dual_prox(q + sigma * sym_grad(wb), alpha0, norm, sigma,
                           delta)
        x_new = (x - tau * d_T(p) + tau * x0) / (1.0 + tau)
        w_new = w - tau * (-p + sym_T(q))
        return TGVState(x_new, 2.0 * x_new - x, w_new, 2.0 * w_new - w, p, q)

    st = _init_state(x0, axes) if state is None else TGVState(*state)
    return _iterate(step, st, x0, axes=axes, **kw)


def _run_stream(x0, state, *, axes, sigma_tau_split, **kw):
    from ..kernels.tgv_stream import tgv_stream_step

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

    return _iterate(step, st, x0, axes=axes, **kw)
