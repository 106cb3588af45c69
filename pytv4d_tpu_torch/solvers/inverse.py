"""Generic TV-regularized linear inverse problems:
``min_x F(A x) + reg * TV(x)`` (``F = 1/2 ||. - b||^2`` by default) for any
linear forward operator ``A`` written in torch ops (CT projection, blur,
masking/inpainting, MRI-style undersampling, ...).  The port of
``pytv4d_tpu/solvers/inverse.py``.

Chambolle-Pock over the joint operator ``K = [A; D]`` with over-relaxation.
``A_T`` defaults to the exact transpose of ``A``, the vjp of the linear map,
so the adjointness contract holds automatically.  ``models.ct.cp_reconstruct``
is this solver specialized to the Radon projector.

The solve is an eager loop on the device of the data ``b``.  With the fused
path the TV half of each iteration runs as two kernels
(``kernels.fused.tv_dual`` and ``cp_primal``; their plain versions on the
CPU) and the loss's TV value as a third (``tv_norms``); the fidelity dual
and the operator stay torch ops.  The loss history stays on the device.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..core.config import TVConfig
from ..core.schemes import num_channels, operator_norm_bound_sq
from ..ops.operators import D, D_T, precond_maps, tv_norm
from ..utils.device import on_device
from .cp import dual_prox
from .fidelity import (
    fidelity_conjugate,
    fidelity_dual_prox,
    fidelity_loss,
    validate_fidelity,
)


class InverseState(NamedTuple):
    """Full CP carry of :func:`cp_inverse` for resume and checkpointing:
    primal, over-relaxed primal, fidelity dual, TV dual (public layout
    ``(Nz, Nd, M, Nr, Nc)``).

    ``s_x`` / ``s_x_bar`` carry the forward projections ``A(x)`` /
    ``A(x_bar)`` of the iterates: the solver derives the over-relaxed
    projection by linearity (``A(2 x_new - x) = 2 A(x_new) - A(x)``), saving
    one operator application per iteration, and carrying these images keeps
    a resumed run on the uninterrupted one's path (recomputing ``A(x_bar)``
    on resume would differ from the derived value in the last ulps).
    ``None`` (an old checkpoint, a hand-built state) is accepted: the solver
    then recomputes them once, which is exact in math but may differ from an
    uninterrupted run at round-off."""
    x: torch.Tensor
    x_bar: torch.Tensor
    y_A: torch.Tensor
    y_D: torch.Tensor
    s_x: Optional[torch.Tensor] = None
    s_x_bar: Optional[torch.Tensor] = None


class InverseResult(NamedTuple):
    x: torch.Tensor
    loss: torch.Tensor  # sampled loss history, on the device
    state: InverseState = None


def check_nonneg_operator(A: Callable, vol_shape, dtype, what: str, *,
                          device):
    """Eager gate for ``precond=True``: the exact row/column-sum
    preconditioners assume ``|A| 1 = A 1``, i.e. nonnegative operator
    coefficients (CT projectors, blurs, masks).  ``A(1)`` with negative
    entries proves signed coefficients (the converse does not hold: this is
    a necessary check); signed operators (Fourier, wavelets, high-pass) must
    use the operator-norm step rule instead."""
    row = A(torch.ones(tuple(vol_shape), dtype=dtype, device=device))
    lo = float(torch.min(row))
    scale = max(1.0, float(torch.max(torch.abs(row))))
    if lo < -1e-6 * scale:
        raise ValueError(
            f"{what}(precond=True) requires a forward operator with "
            f"nonnegative coefficients (A(ones) has negative entries, so "
            f"A(1) != |A| 1 and the preconditioned steps would violate the "
            f"step condition) — use precond=False with op_norm instead"
        )


def _reciprocal_rows(row):
    """``1 / row`` with zero rows (rays that miss the volume) floored
    relative to the live-row scale, so their decoupled duals get a bounded
    step without distorting the live rows."""
    floor = 1e-6 * torch.clamp_min(torch.max(row), 1e-30)
    return 1.0 / torch.maximum(row, floor)


def fidelity_row_precond(A: Callable, vol_shape, dtype, *, device):
    """Per-measurement dual step ``sigma_A = 1 / (|A| 1)`` for a nonnegative
    operator (Pock-Chambolle 2011 diagonal preconditioning, alpha = 1): the
    reciprocal row sums of A, zero rows floored relative to the largest."""
    return _reciprocal_rows(
        A(torch.ones(tuple(vol_shape), dtype=dtype, device=device)))


def _operator_proto(A: Callable):
    """The optional heavy-operator protocol: ``A.prepare() -> consts`` (the
    operator's input-independent tables, built once per solve),
    ``A.apply(consts, x)`` (the same linear map reading them) and,
    optionally, its explicit transpose ``A.apply_T(consts, y)``.  Solvers
    that loop over A use it to keep such precomputation out of the
    iteration.  Returns ``A.apply`` or None."""
    prepare = getattr(A, "prepare", None)
    apply_fn = getattr(A, "apply", None)
    return apply_fn if (prepare is not None and apply_fn is not None) \
        else None


def _bind_operator(A, A_T, vol_shape, dtype):
    """The ``(A, A_T)`` pair a solve iterates.  With the protocol, A binds
    the consts prepared here and A_T becomes the transpose of the bound
    map (``A.apply_T`` where the operator has one, else its vjp), so the
    one set of tables serves both directions."""
    proto_apply = _operator_proto(A)
    if proto_apply is None:
        return A, A_T
    consts = A.prepare()

    def A_(x):
        return proto_apply(consts, x)

    apply_T = getattr(A, "apply_T", None)
    if apply_T is not None:
        return A_, lambda y: apply_T(consts, y)
    return A_, exact_transpose(A_, vol_shape, dtype)


class _LinearTranspose(torch.autograd.Function):
    """``vjp(y)``, the transpose of the linear map ``A``, differentiable in
    ``y``: its own transpose is ``A`` (no op of ``A`` needs a second
    derivative, which some, such as the CUDA grid sampler's, lack)."""

    @staticmethod
    def forward(ctx, y, A, vjp):
        ctx.A = A
        return vjp(y)

    @staticmethod
    def backward(ctx, g):
        return ctx.A(g), None, None


def exact_transpose(A: Callable, vol_shape, dtype=torch.float32) -> Callable:
    """The exact adjoint of a linear map: its vjp, which passes the
    dot-product test to round-off by construction.  A is linear, so the
    graph recorded once at zeros serves every cotangent: the first call on
    a device records it and later calls only run it backwards.  A ``y``
    that requires grad (a solve differentiated in ``reg``) gets an
    ``A^T y`` differentiable in it."""
    graphs = {}

    def vjp(y):
        if y.device not in graphs:
            x = torch.zeros(tuple(vol_shape), dtype=dtype, device=y.device,
                            requires_grad=True)
            with torch.enable_grad():
                graphs[y.device] = (x, A(x))
        x, out = graphs[y.device]
        (x_bar,) = torch.autograd.grad(out, x, y.detach(),
                                       retain_graph=True)
        return x_bar

    def A_T(y):
        if y.requires_grad and torch.is_grad_enabled():
            return _LinearTranspose.apply(y, A, vjp)
        return vjp(y)

    return A_T


@functools.lru_cache(maxsize=64)
def cached_transpose(A, vol_shape, dtype):
    """:func:`exact_transpose` memoized on the operator's identity: repeated
    solver calls with the same ``A`` (chunked resumes, reg sweeps) reuse one
    recorded graph instead of recording it per call."""
    return exact_transpose(A, vol_shape, dtype)


def power_iteration(A: Callable, A_T: Callable, vol_shape, n_iter: int = 12,
                    seed: int = 0, dtype=torch.float32, device=None):
    """Power-method estimate of ``||A||_2`` for step sizing, as a 0-d tensor.
    The start vector is numpy's ``default_rng(seed).standard_normal``, so a
    seed gives the JAX package's estimate.  It goes to the CUDA device
    unless ``device`` names another (``utils.device``).  Honors the
    heavy-operator protocol (:func:`_operator_proto`)."""
    x = on_device(np.random.default_rng(seed).standard_normal(vol_shape),
                  device, dtype)
    A_, A_T_ = _bind_operator(A, A_T, vol_shape, dtype)
    x = x / torch.sqrt(torch.sum(torch.square(x)))
    n = None
    for _ in range(n_iter):
        y = A_T_(A_(x))
        n = torch.sqrt(torch.sum(torch.square(y)))
        x = y / torch.clamp_min(n, 1e-30)
    return torch.sqrt(n)


def pd_gap_inverse(
    state: "InverseState",
    A: Callable,
    b,
    reg: float = 1.0,
    cfg: TVConfig = TVConfig(),
    fidelity: str = "l2",
    fidelity_weight=1.0,
    x_box: Optional[float] = None,
    norm_bound: Optional[float] = None,
    A_T: Optional[Callable] = None,
):
    """Certified duality gap for the inverse problem
    ``min_{x in C} F(A x) + reg TV(x)`` at ``(state.x, state.y_A,
    state.y_D)``, the inverse-solver analog of ``solvers.cp.pd_gap``.

    Unlike denoising, the fidelity here composes with ``A``, so Fenchel
    duality leaves a residual ``r = A^T y_A + D^T y_D`` that is only zero
    at the exact dual optimum; a finite certificate needs a compact prior
    set ``C`` containing the minimizer to absorb it:

        gap(x, y) = F(A x) + reg TV(x)            [primal P(x)]
                  + F*(y_A) + TV*(y_D)            [conjugates, y projected
                                                   feasible first]
                  + sup_{z in C} <-r, z>          [support function of C]
            >= P(x) - min_{z in C} P(z) >= 0.

    ``C`` comes from whichever bound holds for the true solution (pass at
    least one; with both, the tighter certificate wins):

    - ``x_box = c``: the box ``0 <= x <= c`` (natural for attenuation
      coefficients); ``sup = c * sum(relu(-r))``.
    - ``norm_bound = R``: the ball ``||x||_2 <= R`` (sign-free);
      ``sup = R * ||r||_2``.

    As the iterates converge, ``r -> 0`` and the support term vanishes, so
    the certificate is asymptotically tight.
    """
    if x_box is None and norm_bound is None:
        raise ValueError(
            "pd_gap_inverse needs a compact prior set containing the true "
            "solution to certify against — pass x_box=c (the physical "
            "upper bound, 0 <= x <= c) and/or norm_bound=R (||x||_2 <= R)"
        )
    kw = cfg.kwargs()
    x, y_A, y_D = state.x, state.y_A, state.y_D
    primal = fidelity_loss(A(x), b, fidelity, fidelity_weight) + (
        reg * tv_norm(D(x, cfg.scheme, **kw), cfg.norm,
                      huber_delta=cfg.huber_delta)
    )
    # feasibility projections make the bound valid for any input
    y_A, f_star = fidelity_conjugate(y_A, b, fidelity, fidelity_weight)
    y = dual_prox(y_D, reg, cfg.norm, 0.0, cfg.huber_delta)
    tv_star = 0.0
    if cfg.norm == "huber":
        tv_star = cfg.huber_delta / (2.0 * reg) * torch.sum(torch.square(y))
    if A_T is None:
        A_T = cached_transpose(A, tuple(x.shape), x.dtype)
    r = A_T(y_A) + D_T(y, cfg.scheme, **kw)
    sup_terms = []
    if x_box is not None:
        sup_terms.append(x_box * torch.sum(torch.clamp_min(-r, 0.0)))
    if norm_bound is not None:
        sup_terms.append(norm_bound * torch.sqrt(torch.sum(torch.square(r))))
    sup_C = sup_terms[0] if len(sup_terms) == 1 else torch.minimum(*sup_terms)
    return primal + f_star + tv_star + sup_C


def cp_inverse(
    A: Callable,
    b,
    vol_shape,
    A_T: Optional[Callable] = None,
    n_iter: int = 100,
    reg: float = 1.0,
    cfg: TVConfig = TVConfig(),
    op_norm: Optional[float] = None,
    x_init=None,
    precond: bool = False,
    fidelity: str = "l2",
    fidelity_weight=1.0,
    nonneg: bool = False,
    state: Optional[InverseState] = None,
    fused: bool = None,
    dual_dtype=None,
    loss_every: int = 1,
    precond_sums=None,
    precond_scale: float = 1.0,
    device=None,
) -> InverseResult:
    """Solve ``min_x F(A x) + reg TV(x)`` with Chambolle-Pock.

    ``A`` maps a ``vol_shape`` volume to the data space of ``b``; it must be
    linear and made of torch ops.  Step rule:
    ``tau = sigma = 1/sqrt(||A||^2 + ||D||^2)``.  The solve runs on the
    device of ``b``: a tensor's own, the CUDA device for a numpy array
    (``RuntimeError`` where there is none), or ``device`` where given
    (``utils.device``).

    ``fidelity`` selects the data term ``F`` (``solvers.fidelity``):
    ``'l2'`` = ``weight/2 ||Ax - b||^2`` (default), ``'l1'`` =
    ``weight ||Ax - b||_1`` (impulsive noise), ``'kl'`` = Poisson
    log-likelihood (photon-count CT; requires ``b >= 0``).
    ``fidelity_weight`` may be a scalar or a per-measurement array.
    ``nonneg=True`` constrains ``x >= 0`` (standard for attenuation
    coefficients in CT).

    ``precond=True``: diagonally preconditioned steps (Pock & Chambolle
    2011, alpha = 1) from the exact row/column absolute sums of ``[A; D]``
    (``ops.operators.precond_maps``; the A sums are exact whenever A has
    nonnegative coefficients).  No ``op_norm`` or power iteration, and
    typically several-fold fewer iterations.

    ``precond_sums=(row_sum, col_sum)`` supplies external absolute-sum
    surrogates ``|A| 1`` (data-shaped) / ``|A|^T 1`` (volume-shaped) for a
    signed operator whose plain ``A(1)`` / ``A^T(1)`` would underestimate
    them; the nonnegative-operator gate is skipped, so the caller owns
    validity.  ``precond_scale >= 1`` divides all preconditioned steps by
    the given factor: with ``rho = ||Sigma^{1/2} K T^{1/2}||`` measured by
    a power method, ``precond_scale = rho`` restores the step condition when
    surrogate sums are only approximate bounds.

    ``state`` resumes a previous run from ``result.state`` (the
    over-relaxed iterate, both duals and the projections are carried; the
    state is not modified).

    ``fused=None`` takes the fused TV kernels for the D half of the
    iteration (``kernels.fused.tv_dual`` and ``cp_primal``: CUDA kernels on
    a CUDA tensor, their plain versions on the CPU) when the problem
    supports it: float32/bfloat16 volumes that
    ``kernels.dispatch.can_fuse`` accepts, and scalar steps
    (``precond=False``).  ``fused=False`` forces the plain step.  A
    ``reg`` tensor that requires grad takes the plain step, where it stays
    a tensor, so ``torch.autograd`` differentiates the solve in ``reg``
    through the unrolled iterations (``fused=True`` then raises).
    ``dual_dtype='bfloat16'`` (fused path only) stores the Nd-channel TV
    dual, by far the largest state, in bf16; the returned state's ``y_D``
    keeps the volume dtype.

    ``loss_every=k`` (a positive divisor of ``n_iter``) samples the loss
    once per k iterations: ``result.loss`` has length ``n_iter // k``, each
    entry the loss at its chunk's last iteration.  The forward projection
    ``A(x_new)`` is always paid (the carry needs it for the linearity
    rewrite ``A(x_bar) = 2 A(x_new) - A(x)``), so skipping the loss only
    skips the TV value and the fidelity sum.
    """
    from ..kernels.dispatch import as_dtype, can_fuse

    b = on_device(b, device)
    dtype, device = b.dtype, b.device
    vol_shape = tuple(int(n) for n in vol_shape)
    validate_fidelity(fidelity, b, fidelity_weight)
    if loss_every < 1 or n_iter % loss_every:
        raise ValueError(
            f"loss_every must be a positive divisor of n_iter, got "
            f"loss_every={loss_every} with n_iter={n_iter}"
        )
    if A_T is None:
        A_T = cached_transpose(A, vol_shape, dtype)
    if precond:
        if op_norm is not None:
            raise ValueError(
                "op_norm and precond=True are mutually exclusive — the "
                "preconditioned steps come from the operator's exact "
                "row/column sums, not an operator-norm bound"
            )
        if precond_sums is None:
            check_nonneg_operator(A, vol_shape, dtype, what="cp_inverse",
                                  device=device)
        step = None  # per-element maps, built below
    else:
        if op_norm is None:
            op_norm = float(power_iteration(A, A_T, vol_shape, dtype=dtype,
                                            device=device))
        L_sq = op_norm ** 2 + operator_norm_bound_sq(
            cfg.scheme, vol_shape[0], vol_shape[1], cfg.reg_z_over_reg,
            cfg.reg_time,
        )
        step = float(1.0 / np.sqrt(L_sq))  # sigma = tau

    fusable = can_fuse(vol_shape, cfg, dtype=dtype)
    # reg stays a tensor when the caller differentiates through the solve
    # (unrolled hyperparameter gradients, cf. Bertrand et al. 2020)
    reg_grad = isinstance(reg, torch.Tensor) and reg.requires_grad
    if fused is None:
        fused = not precond and not reg_grad and fusable
    if fused and (precond or reg_grad):
        raise ValueError(
            "fused=True is incompatible with precond=True (per-pixel step "
            "maps; the fused kernels take scalar steps) and with a reg that "
            "requires grad (the fused kernels take reg and the steps as "
            "constants) — use fused=False"
        )
    if fused and not fusable:
        raise ValueError(
            f"fused=True cannot serve this problem (see kernels.dispatch."
            f"can_fuse): volume shape {vol_shape}, dtype {dtype}, "
            f"cfg={cfg} — the fused kernels need rank-4 float32/bfloat16 "
            f"volumes; use fused=False (or None for auto-selection)"
        )
    if dual_dtype is not None and not fused:
        raise ValueError(
            "dual_dtype requires the fused kernel path (fused=True), which "
            "this problem instance does not support (see kernels.dispatch."
            "can_fuse: float32/bfloat16 volumes, scalar steps)"
        )
    if precond_sums is not None and not precond:
        raise ValueError("precond_sums requires precond=True")
    if precond_scale != 1.0 and not precond:
        raise ValueError("precond_scale requires precond=True")

    def tensor(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    fw = tensor(fidelity_weight)
    A_, A_T_ = _bind_operator(A, A_T, vol_shape, dtype)
    if state is None:
        x = (torch.zeros(vol_shape, dtype=dtype, device=device)
             if x_init is None else tensor(x_init).clone())
        s0 = A_(x)
        carry = (x, x, torch.zeros_like(b), None, s0, s0)
    else:
        st = InverseState(*(t if t is None else
                            torch.as_tensor(t, device=device) for t in state))
        carry = (st.x, st.x_bar, st.y_A, st.y_D,
                 A_(st.x) if st.s_x is None else st.s_x,
                 A_(st.x_bar) if st.s_x_bar is None else st.s_x_bar)

    if fused:
        run = functools.partial(
            _inverse_run_fused, sigma=step, tau=step,
            dual_dtype=as_dtype(dual_dtype or dtype),
            out_dual_dtype=dtype if state is None else carry[3].dtype)
    else:
        if precond:
            steps = _precond_steps(A_, A_T_, b, vol_shape, cfg, precond_sums,
                                   precond_scale)
        else:
            steps = (step, step, step)
        run = functools.partial(_inverse_run, steps=steps)
    final, losses = run(A_, A_T_, b, carry, fw, vol_shape=vol_shape, cfg=cfg,
                        reg=reg if reg_grad else float(reg),
                        fidelity=fidelity,
                        nonneg=bool(nonneg), n_iter=int(n_iter),
                        loss_every=int(loss_every))
    return InverseResult(x=final.x, loss=losses, state=final)


def _precond_steps(A, A_T, b, vol_shape, cfg, precond_sums, precond_scale):
    """``(sigma_D map, tau map, sigma_A map)`` of the preconditioned run:
    from the operator's own sums ``A(1)`` / ``A^T(1)``, or from externally
    supplied surrogates, all divided by ``precond_scale``."""
    dtype, device = b.dtype, b.device
    if precond_sums is not None:
        row, col = (torch.as_tensor(s, dtype=dtype, device=device)
                    for s in precond_sums)
        sig_A = _reciprocal_rows(row)
    else:
        col = A_T(torch.ones_like(b))
        sig_A = fidelity_row_precond(A, vol_shape, dtype, device=device)
    sig, tau_m = precond_maps(
        vol_shape, cfg.scheme, cfg.reg_z_over_reg, cfg.reg_time,
        fidelity_colsum=col, grouped=(cfg.norm != "aniso"), dtype=dtype,
        device=device)
    return (sig / precond_scale, tau_m / precond_scale,
            sig_A / precond_scale)


def _inverse_run(A, A_T, b, carry, fw, *, steps, vol_shape, cfg, reg,
                 fidelity, nonneg, n_iter, loss_every):
    """The plain CP loop on ``K = [A; D]``: scalar or per-element steps
    ``(sigma_D, tau, sigma_A)``, any dtype.  One forward and one adjoint
    application per iteration: ``A(x_bar) = 2 A(x_new) - A(x)`` comes from
    the carried projections, and the loss reuses the same ``A(x_new)``."""
    sig, tau, sig_A = steps
    kw = cfg.kwargs()
    x, x_bar, y_A, y_D, sAx, sAx_bar = carry
    if y_D is None:
        Nd = num_channels(cfg.scheme, vol_shape[0], vol_shape[1],
                          cfg.reg_z_over_reg, cfg.reg_time)
        y_D = torch.zeros((vol_shape[0], Nd, vol_shape[1]) + vol_shape[2:],
                          dtype=b.dtype, device=b.device)
    losses = torch.empty(n_iter // loss_every, dtype=b.dtype,
                         device=b.device)
    for i in range(n_iter):
        y_A = fidelity_dual_prox(y_A, sAx_bar, b, sig_A, fidelity, fw)
        p = y_D + sig * D(x_bar, cfg.scheme, **kw)
        y_D = dual_prox(p, reg, cfg.norm, sig, cfg.huber_delta)
        x_new = x - tau * (A_T(y_A) + D_T(y_D, cfg.scheme, **kw))
        if nonneg:
            x_new = torch.clamp_min(x_new, 0.0)
        x_bar = 2.0 * x_new - x
        s_new = A(x_new)
        x, sAx, sAx_bar = x_new, s_new, 2.0 * s_new - sAx
        if (i + 1) % loss_every == 0:
            losses[i // loss_every] = (
                fidelity_loss(s_new, b, fidelity, fw) + reg * tv_norm(
                    D(x, cfg.scheme, **kw), cfg.norm,
                    huber_delta=cfg.huber_delta))
    return InverseState(x, x_bar, y_A, y_D, sAx, sAx_bar), losses


def _inverse_run_fused(A, A_T, b, carry, fw, *, sigma, tau, dual_dtype,
                       out_dual_dtype, vol_shape, cfg, reg, fidelity, nonneg,
                       n_iter, loss_every):
    """The fused CP loop: per iteration the measurement-space fidelity dual
    prox (torch ops), ``tv_dual`` (TV dual prox of the over-relaxed
    iterate), ``A_T``, ``cp_primal`` with ``A^T y_A`` in its y_A slot, and
    ``A(x_new)``; per sampled loss one ``tv_norms``.  The dual rides the
    loop in the kernels' channel-contiguous layout and its storage dtype.
    ``cp_primal`` writes x' into a second buffer and the two swap, because
    ``x_bar' = 2 x' - x`` still needs x; its x0 slot gets x itself and its
    fidelity partial (a denoising quantity) is discarded."""
    from ..kernels.fused import (
        cp_primal,
        from_internal_layout,
        to_internal_layout,
        tv_dual,
        tv_norms,
    )

    x, x_bar, y_A, y_D, sAx, sAx_bar = carry
    if y_D is None:
        Nd = num_channels(cfg.scheme, vol_shape[0], vol_shape[1],
                          cfg.reg_z_over_reg, cfg.reg_time)
        y_D_int = torch.zeros((vol_shape[0], vol_shape[1], Nd)
                              + vol_shape[2:], dtype=dual_dtype,
                              device=b.device)
    else:
        y_D_int = to_internal_layout(y_D).to(dual_dtype)
    # the loop owns its volumes: the caller's state is left alone
    x = x.contiguous().clone()
    x_bar = x_bar.contiguous().clone()
    spare = torch.empty_like(x)
    losses = torch.empty(n_iter // loss_every, dtype=torch.float32,
                         device=b.device)
    for i in range(n_iter):
        y_A = fidelity_dual_prox(y_A, sAx_bar, b, sigma, fidelity, fw)
        y_D_int, _ = tv_dual(x_bar, y_D_int, cfg=cfg, sigma_D=sigma, reg=reg)
        at = A_T(y_A).contiguous()
        x_new, _ = cp_primal(x, x, at, y_D_int, cfg=cfg, tau=tau,
                             nonneg=nonneg, out=spare)
        torch.mul(x_new, 2.0, out=x_bar).sub_(x)
        s_new = A(x_new)
        x, spare, sAx, sAx_bar = x_new, x, s_new, 2.0 * s_new - sAx
        if (i + 1) % loss_every == 0:
            _, tv_parts = tv_norms(x, cfg=cfg)
            losses[i // loss_every] = torch.add(
                fidelity_loss(s_new, b, fidelity, fw), torch.sum(tv_parts),
                alpha=reg)
    final = InverseState(
        x, x_bar, y_A, from_internal_layout(y_D_int).to(out_dual_dtype),
        sAx, sAx_bar)
    return final, losses


def cp_inverse_grid(pair_of, b, vol_shape, *, n_iter: int = 100,
                    reg: float = 1.0, cfg: TVConfig = TVConfig(),
                    op_norm: Optional[float] = None, x_init=None,
                    fidelity: str = "l2", fidelity_weight: float = 1.0,
                    nonneg: bool = False, loss_every: int = 1,
                    seed: int = 0) -> InverseResult:
    """:func:`cp_inverse`'s plain loop on a grid of shards
    (``parallel.mesh``): ``b[iz][it]`` is a shard of the data and
    ``pair_of(it)`` the ``(A, A_T)`` that maps a volume shard of column
    ``it`` to it and back, with no exchange (a projector that batches over
    z and t).  The TV half runs on ``parallel.halo``'s exchanged ``D`` /
    ``D_T``, the loss and the norms are sums over shards in (iz, it) order.
    ``op_norm=None`` estimates ``||A||`` by the power method on the grid,
    from the unsharded estimate's start vector.  ``x_init`` is a whole
    volume or a grid.  Returns ``x`` and every state field as grids."""
    from ..parallel.halo import sharded_D, sharded_D_T
    from ..parallel.mesh import (
        Sharding,
        first_shard,
        grid_map,
        grid_mesh,
        grid_sum,
        mesh_sizes,
        shard,
        volume_spec,
    )

    vol_shape = tuple(int(n) for n in vol_shape)
    if np.ndim(fidelity_weight) != 0:
        raise ValueError("a sharded solve takes a scalar fidelity_weight")
    if loss_every < 1 or n_iter % loss_every:
        raise ValueError(
            f"loss_every must be a positive divisor of n_iter, got "
            f"loss_every={loss_every} with n_iter={n_iter}"
        )
    for row in b:
        for part in row or ():
            validate_fidelity(fidelity, part, fidelity_weight)
    first = first_shard(b)
    dtype, device = first.dtype, first.device
    mesh = grid_mesh(b).mesh
    nz, nt = mesh_sizes(mesh)
    D_g = sharded_D(mesh, cfg, vol_shape)
    D_T_g = sharded_D_T(mesh, cfg, vol_shape)
    binds = [_bind_operator(*pair_of(it), (vol_shape[0] // nz,
                                           vol_shape[1] // nt)
                            + vol_shape[2:], dtype) for it in range(nt)]

    def per_shard(i, fn, *grids):
        """``fn`` over the grids' shards, with the pair of each column."""
        return [None if rows[0] is None else
                [fn(binds[it][i], *cells) for it, cells in
                 enumerate(zip(*rows))] for rows in zip(*grids)]

    def A(x):
        return per_shard(0, lambda f, xs: f(xs), x)

    def A_T(y):
        return per_shard(1, lambda f, ys: f(ys), y)

    def place(a):
        if isinstance(a, list):
            return a
        if not isinstance(a, torch.Tensor):
            a = torch.as_tensor(np.asarray(a))
        return shard(a.to(dtype), Sharding(mesh, volume_spec()))

    def norm2(grid):
        return torch.sqrt(grid_sum(grid_map(
            lambda a: torch.sum(torch.square(a)), grid)))

    if op_norm is None:
        v = place(np.random.default_rng(seed).standard_normal(vol_shape))
        n0 = norm2(v)
        v = grid_map(lambda a: a / n0, v)
        n = None
        for _ in range(12):
            y = A_T(A(v))
            n = norm2(y)
            v = grid_map(lambda a, n=n: a / torch.clamp_min(n, 1e-30), y)
        op_norm = float(torch.sqrt(n))
    L_sq = op_norm ** 2 + operator_norm_bound_sq(
        cfg.scheme, vol_shape[0], vol_shape[1], cfg.reg_z_over_reg,
        cfg.reg_time)
    sig = tau = float(1.0 / np.sqrt(L_sq))
    fw = torch.as_tensor(fidelity_weight, dtype=dtype, device=device)
    Nd = num_channels(cfg.scheme, vol_shape[0], vol_shape[1],
                      cfg.reg_z_over_reg, cfg.reg_time)

    x = (place(torch.zeros(vol_shape, dtype=dtype)) if x_init is None
         else grid_map(torch.clone, place(x_init)))
    x_bar = x
    sAx = sAx_bar = A(x)
    y_A = grid_map(torch.zeros_like, b)
    y_D = grid_map(lambda a: a.new_zeros(
        (a.shape[0], Nd) + tuple(a.shape[1:])), x)
    losses = torch.empty(n_iter // loss_every, dtype=dtype, device=device)
    for i in range(n_iter):
        y_A = grid_map(lambda ya, s, bs: fidelity_dual_prox(
            ya, s, bs, sig, fidelity, fw), y_A, sAx_bar, b)
        y_D = grid_map(lambda yd, d: dual_prox(
            yd + sig * d, reg, cfg.norm, sig, cfg.huber_delta),
            y_D, D_g(x_bar))

        def primal(xs, at, dt):
            xn = xs - tau * (at + dt)
            return torch.clamp_min(xn, 0.0) if nonneg else xn

        x_new = grid_map(primal, x, A_T(y_A), D_T_g(y_D))
        x_bar = grid_map(lambda xn, xs: 2.0 * xn - xs, x_new, x)
        s_new = A(x_new)
        x, sAx_bar = x_new, grid_map(lambda sn, s: 2.0 * sn - s, s_new, sAx)
        sAx = s_new
        if (i + 1) % loss_every == 0:
            losses[i // loss_every] = grid_sum(grid_map(
                lambda sn, bs, d: fidelity_loss(sn, bs, fidelity, fw)
                + reg * tv_norm(d, cfg.norm, huber_delta=cfg.huber_delta),
                s_new, b, D_g(x)))
    return InverseResult(x=x, loss=losses, state=InverseState(
        x, x_bar, y_A, y_D, sAx, sAx_bar))


def reg_discrepancy(
    A: Callable,
    b,
    vol_shape,
    noise_norm: float,
    n_iter: int = 150,
    reg0: float = 1e-2,
    n_bisect: int = 10,
    rtol: float = 0.05,
    device=None,
    **kw,
) -> "tuple[float, InverseResult]":
    """Choose ``reg`` by Morozov's discrepancy principle: the largest
    regularization whose solution still fits the data to the noise level,
    ``||A x_reg - b||_2 ~= noise_norm`` (= ``sigma * sqrt(b.numel())`` for
    i.i.d. Gaussian noise of std ``sigma``).  The residual norm is monotone
    increasing in ``reg``, so a geometric bracket expansion from ``reg0``
    followed by ``n_bisect`` log-space bisections converges fast; every
    solve warm-starts from the previous solution's full CP state
    (``cp_inverse(state=...)``), so later evaluations are cheap
    refinements.  Returns ``(reg, result)`` with ``|residual - noise_norm|
    <= rtol * noise_norm`` (or the closest bracketed value).

    ``**kw`` forwards to :func:`cp_inverse` (``cfg``, ``precond``,
    ``nonneg``, ``op_norm``, ``fused``, ...).  The l2 data term is assumed
    (the principle is defined for Gaussian noise); ``op_norm`` is estimated
    once here when neither it nor ``precond`` is given.
    """
    b = on_device(b, device)
    vol_shape = tuple(vol_shape)
    if not kw.get("precond") and kw.get("op_norm") is None:
        A_T = kw.get("A_T") or exact_transpose(A, vol_shape, b.dtype)
        kw = dict(kw, A_T=A_T,
                  op_norm=float(power_iteration(A, A_T, vol_shape,
                                                dtype=b.dtype,
                                                device=b.device)))
    state = None

    def solve(reg):
        nonlocal state
        res = cp_inverse(A, b, vol_shape, n_iter=n_iter, reg=reg,
                         state=state, **kw)
        state = res.state
        return res, float(torch.sqrt(torch.sum(torch.square(A(res.x) - b))))

    target = float(noise_norm)
    best = None

    def consider(reg_val, res, r):
        nonlocal best
        if best is None or abs(r - target) < best[0]:
            best = (abs(r - target), reg_val, res)

    lo = hi = float(reg0)
    res, r = solve(lo)
    consider(lo, res, r)
    if r < target:  # under-regularized at reg0: expand upward
        for _ in range(12):
            hi *= 10.0
            res, r = solve(hi)
            consider(hi, res, r)
            if r >= target:
                break
        lo = hi / 10.0
    else:           # over-regularized at reg0: expand downward
        for _ in range(12):
            lo /= 10.0
            res, r = solve(lo)
            consider(lo, res, r)
            if r <= target:
                break
        hi = lo * 10.0
    for _ in range(n_bisect):
        if best[0] <= rtol * target:
            break
        mid = float(np.sqrt(lo * hi))
        res, r = solve(mid)
        consider(mid, res, r)
        if r > target:
            hi = mid
        else:
            lo = mid
    return best[1], best[2]


def gaussian_blur_operator(vol_shape, sigma_px: float = 2.0,
                           radius: int = 6) -> Callable:
    """A separable in-plane Gaussian blur as a linear forward operator
    (deblurring example; zero boundary).  It computes in its input's dtype
    on its input's device."""
    r = np.arange(-radius, radius + 1)
    k = np.exp(-0.5 * (r / sigma_px) ** 2)
    taps = [float(v) for v in k / k.sum()]

    def blur(x):
        def conv_axis(v, axis):
            pads = [0, 0] * (v.ndim - 1 - axis) + [radius, radius]
            vp = torch.nn.functional.pad(v, pads)
            out = torch.zeros_like(v)
            for i, tap in enumerate(taps):
                out = out + tap * vp.narrow(axis, i, v.shape[axis])
            return out

        return conv_axis(conv_axis(x, 2), 3)

    return blur
