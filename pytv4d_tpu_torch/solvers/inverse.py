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

Both loops are written once, against an ``ops.space.Space``: a whole
volume's (:func:`cp_inverse`) or a grid of shards' (:func:`cp_inverse_grid`,
``parallel.halo.grid_space``), where the operator runs per shard, the TV
half on the exchanged stencils or on the kernels in their halo mode, and
every sum, norm and relative floor is taken over the whole grid.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple, Optional

import numpy as np
import torch

from ..core.config import TVConfig
from ..core.schemes import num_channels, operator_norm_bound_sq
from ..ops.operators import D, D_T, precond_maps, tv_norm
from ..ops.space import TENSOR, Space, d_zeros, tensor_space
from ..parallel.mesh import is_grid
from ..utils.device import on_device
from ..utils.profiling import A_SPAN, A_T_SPAN, ITER_SPAN, solve_span, span
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
    _check_nonneg_rows(
        A(torch.ones(tuple(vol_shape), dtype=dtype, device=device)), TENSOR,
        what)


def _check_nonneg_rows(row, space: Space, what: str):
    """:func:`check_nonneg_operator` on the field ``A(1)`` of ``space``
    (on a grid: every shard's rows, against the whole grid's scale)."""
    lo = float(space.min(torch.min, row))
    scale = max(1.0, float(space.max(lambda r: torch.max(torch.abs(r)),
                                     row)))
    if lo < -1e-6 * scale:
        raise ValueError(
            f"{what}(precond=True) requires a forward operator with "
            f"nonnegative coefficients (A(ones) has negative entries, so "
            f"A(1) != |A| 1 and the preconditioned steps would violate the "
            f"step condition) — use precond=False with op_norm instead"
        )


def _reciprocal_rows(row, space: Space = TENSOR):
    """``1 / row`` with zero rows (rays that miss the volume) floored
    relative to the live-row scale, so their decoupled duals get a bounded
    step without distorting the live rows.  On a grid the scale is the
    whole grid's largest row, never one shard's."""
    floor = 1e-6 * torch.clamp_min(space.max(torch.max, row), 1e-30)
    return space.map(lambda r: 1.0 / torch.maximum(r, floor), row)


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
    return _power_norm(A_, A_T_, x, TENSOR, n_iter)


def _power_norm(A: Callable, A_T: Callable, x, space: Space, n_iter: int):
    """:func:`power_iteration` from the start field ``x`` of ``space``
    (on a grid the norms are sums over shards)."""
    def norm(v):
        return torch.sqrt(space.sum(lambda a: torch.sum(torch.square(a)), v))

    n0 = norm(x)
    x = space.map(lambda a: a / n0, x)
    n = None
    for _ in range(n_iter):
        y = A_T(A(x))
        n = norm(y)
        x = space.map(lambda a, n=n: a / torch.clamp_min(n, 1e-30), y)
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


@solve_span
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

    :func:`cp_inverse_grid` is the same solve on a grid of shards.
    """
    from ..kernels.dispatch import can_fuse

    b = on_device(b, device)
    dtype, device = b.dtype, b.device
    vol_shape = tuple(int(n) for n in vol_shape)
    validate_fidelity(fidelity, b, fidelity_weight)
    if A_T is None:
        A_T = cached_transpose(A, vol_shape, dtype)
    A_, A_T_ = _bind_operator(A, A_T, vol_shape, dtype)

    def place(a, kind="volume"):
        return None if a is None else torch.as_tensor(a, device=device)

    def maps(col):
        return precond_maps(
            vol_shape, cfg.scheme, cfg.reg_z_over_reg, cfg.reg_time,
            fidelity_colsum=col, grouped=(cfg.norm != "aniso"), dtype=dtype,
            device=device)

    def start(seed):
        return on_device(np.random.default_rng(seed).standard_normal(
            vol_shape), device, dtype)

    fields = _Fields(tensor_space(cfg, shape=vol_shape), A_, A_T_, place,
                     maps, start, _tensor_tv_half,
                     can_fuse(vol_shape, cfg, dtype=dtype))
    return _solve(fields, b, n_iter=n_iter, reg=reg, cfg=cfg,
                  op_norm=op_norm, x_init=x_init, precond=precond,
                  fidelity=fidelity, fidelity_weight=fidelity_weight,
                  nonneg=nonneg, state=state, fused=fused,
                  dual_dtype=dual_dtype, loss_every=loss_every,
                  precond_sums=precond_sums, precond_scale=precond_scale)


class _Fields(NamedTuple):
    """What a solve asks of its fields beyond the loop: the volume's
    ``ops.space.Space`` (with ``cfg``'s D / D_T), the bound pair ``A`` /
    ``A_T`` between volume and data fields, ``place(a, kind)`` (a whole
    array, or a field as it is, as a field of ``kind`` 'volume',
    'd_volume' or 'data' on the solve's device, in its own dtype), the
    preconditioner maps from a ``|A|^T 1`` field, the power method's start
    field from a seed, the TV half on the fused kernels
    (``tv_half(cfg, sigma, tau, reg, nonneg)``) and whether they serve."""
    space: Space
    A: Callable
    A_T: Callable
    place: Callable
    precond_maps: Callable
    start: Callable
    tv_half: Callable
    fusable: bool


class _TVHalf(NamedTuple):
    """The TV half of the fused iteration on a kind of field:
    ``dual(x_bar, y_D_int) -> y_D_int'`` (``kernels.fused.tv_dual``),
    ``primal(x, A^T y_A, y_D_int, out) -> x'`` (``cp_primal`` with
    ``A^T y_A`` in its y_A slot and x in its x0 slot) and ``tv(x)``, the
    TV value of ``D x`` (``tv_norms``)."""
    dual: Callable
    primal: Callable
    tv: Callable


def _tensor_tv_half(cfg, sigma, tau, reg, nonneg) -> _TVHalf:
    from ..kernels.fused import cp_primal, tv_dual, tv_norms

    return _TVHalf(
        lambda x_bar, y: tv_dual(x_bar, y, cfg=cfg, sigma_D=sigma,
                                 reg=reg)[0],
        lambda x, at, y, out: cp_primal(x, x, at, y, cfg=cfg, tau=tau,
                                        nonneg=nonneg, out=out)[0],
        lambda x: torch.sum(tv_norms(x, cfg=cfg)[1]))


def _solve(fields: _Fields, b, *, n_iter, reg, cfg, op_norm, x_init,
           precond, fidelity, fidelity_weight, nonneg, state, fused,
           dual_dtype, loss_every, precond_sums,
           precond_scale) -> InverseResult:
    """:func:`cp_inverse` on ``fields``: the options checked, the steps
    sized, the carry set up, then one of the two loops."""
    from ..kernels.dispatch import as_dtype

    space = fields.space
    vol_shape = space.shape
    first = space.first(b)
    dtype = first.dtype
    if loss_every < 1 or n_iter % loss_every:
        raise ValueError(
            f"loss_every must be a positive divisor of n_iter, got "
            f"loss_every={loss_every} with n_iter={n_iter}"
        )
    if precond:
        if op_norm is not None:
            raise ValueError(
                "op_norm and precond=True are mutually exclusive — the "
                "preconditioned steps come from the operator's exact "
                "row/column sums, not an operator-norm bound"
            )
        if precond_sums is None:
            _check_nonneg_rows(fields.A(fields.place(
                torch.ones(vol_shape, dtype=dtype))), space, "cp_inverse")
        step = None  # per-element maps, built below
    else:
        if op_norm is None:
            op_norm = float(_power_norm(fields.A, fields.A_T,
                                        fields.start(0), space, 12))
        L_sq = op_norm ** 2 + operator_norm_bound_sq(
            cfg.scheme, vol_shape[0], vol_shape[1], cfg.reg_z_over_reg,
            cfg.reg_time,
        )
        step = float(1.0 / np.sqrt(L_sq))  # sigma = tau

    # reg stays a tensor when the caller differentiates through the solve
    # (unrolled hyperparameter gradients, cf. Bertrand et al. 2020)
    reg_grad = isinstance(reg, torch.Tensor) and reg.requires_grad
    if fused is None:
        fused = not precond and not reg_grad and fields.fusable
    if fused and (precond or reg_grad):
        raise ValueError(
            "fused=True is incompatible with precond=True (per-pixel step "
            "maps; the fused kernels take scalar steps) and with a reg that "
            "requires grad (the fused kernels take reg and the steps as "
            "constants) — use fused=False"
        )
    if fused and not fields.fusable:
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

    def cast(f):
        return space.map(lambda t: t.to(dtype), f)

    if np.ndim(fidelity_weight) == 0 and not is_grid(fidelity_weight):
        fw = torch.as_tensor(fidelity_weight, dtype=dtype,
                             device=first.device)
    else:
        fw = cast(fields.place(fidelity_weight, "data"))
    A_, A_T_ = fields.A, fields.A_T
    if state is None:
        x = (fields.place(torch.zeros(vol_shape, dtype=dtype))
             if x_init is None
             else space.map(torch.clone, cast(fields.place(x_init))))
        s0 = A_(x)
        carry = (x, x, space.map(torch.zeros_like, b), None, s0, s0)
    else:
        st = InverseState(*(fields.place(t, kind) for t, kind in zip(
            state, ("volume", "volume", "data", "d_volume", "data",
                    "data"))))
        carry = (st.x, st.x_bar, st.y_A, st.y_D,
                 A_(st.x) if st.s_x is None else st.s_x,
                 A_(st.x_bar) if st.s_x_bar is None else st.s_x_bar)

    if fused:
        run = functools.partial(
            _inverse_run_fused, sigma=step, tau=step,
            dual_dtype=as_dtype(dual_dtype or dtype),
            out_dual_dtype=(dtype if state is None
                            else space.first(carry[3]).dtype),
            tv_half=fields.tv_half)
    else:
        if precond:
            steps = _precond_steps(fields, b, cfg, precond_sums,
                                   precond_scale)
        else:
            steps = (step, step, step)
        run = functools.partial(_inverse_run, steps=steps)
    final, losses = run(A_, A_T_, b, carry, fw, space=space, cfg=cfg,
                        reg=reg if reg_grad else float(reg),
                        fidelity=fidelity,
                        nonneg=bool(nonneg), n_iter=int(n_iter),
                        loss_every=int(loss_every))
    return InverseResult(x=final.x, loss=losses, state=final)


def _precond_steps(fields: _Fields, b, cfg, precond_sums, precond_scale):
    """``(sigma_D map, tau map, sigma_A map)`` of the preconditioned run:
    from the operator's own sums ``A(1)`` / ``A^T(1)``, or from externally
    supplied surrogates, all divided by ``precond_scale``."""
    space = fields.space
    dtype = space.first(b).dtype
    if precond_sums is not None:
        row, col = (space.map(lambda t: t.to(dtype), fields.place(s, kind))
                    for s, kind in zip(precond_sums, ("data", "volume")))
        sig_A = _reciprocal_rows(row, space)
    else:
        col = fields.A_T(space.map(torch.ones_like, b))
        sig_A = _reciprocal_rows(fields.A(fields.place(
            torch.ones(space.shape, dtype=dtype))), space)
    sig, tau_m = fields.precond_maps(col)
    return tuple(space.map(lambda a: a / precond_scale, m)
                 for m in (sig, tau_m, sig_A))


def _inverse_run(A, A_T, b, carry, fw, *, steps, space, cfg, reg, fidelity,
                 nonneg, n_iter, loss_every):
    """The plain CP loop on ``K = [A; D]``: scalar or per-element steps
    ``(sigma_D, tau, sigma_A)``, any dtype, on ``space``'s fields.  One
    forward and one adjoint application per iteration:
    ``A(x_bar) = 2 A(x_new) - A(x)`` comes from the carried projections,
    and the loss reuses the same ``A(x_new)``."""
    sig, tau, sig_A = steps
    x, x_bar, y_A, y_D, sAx, sAx_bar = carry
    if y_D is None:
        shape = space.shape
        y_D = d_zeros(space, x, num_channels(
            cfg.scheme, shape[0], shape[1], cfg.reg_z_over_reg,
            cfg.reg_time))
    first = space.first(b)
    losses = torch.empty(n_iter // loss_every, dtype=first.dtype,
                         device=first.device)

    def primal(xs, at, dt, t):
        xn = xs - t * (at + dt)
        return torch.clamp_min(xn, 0.0) if nonneg else xn

    for i in range(n_iter):
        with span(ITER_SPAN, first.device):
            y_A = space.map(lambda ya, s, bs, sa, w: fidelity_dual_prox(
                ya, s, bs, sa, fidelity, w), y_A, sAx_bar, b, sig_A, fw)
            y_D = space.map(lambda yd, d, sg: dual_prox(
                yd + sg * d, reg, cfg.norm, sg, cfg.huber_delta),
                y_D, space.D(x_bar), sig)
            with span(A_T_SPAN, first.device):
                at = A_T(y_A)
            x_new = space.map(primal, x, at, space.D_T(y_D), tau)
            x_bar = space.map(lambda xn, xs: 2.0 * xn - xs, x_new, x)
            with span(A_SPAN, first.device):
                s_new = A(x_new)
            x, sAx, sAx_bar = x_new, s_new, space.map(
                lambda sn, s: 2.0 * sn - s, s_new, sAx)
            if (i + 1) % loss_every == 0:
                losses[i // loss_every] = space.sum(
                    lambda sn, bs, w, d: fidelity_loss(sn, bs, fidelity, w)
                    + reg * tv_norm(d, cfg.norm,
                                    huber_delta=cfg.huber_delta),
                    s_new, b, fw, space.D(x))
    return InverseState(x, x_bar, y_A, y_D, sAx, sAx_bar), losses


def _inverse_run_fused(A, A_T, b, carry, fw, *, sigma, tau, dual_dtype,
                       out_dual_dtype, tv_half, space, cfg, reg, fidelity,
                       nonneg, n_iter, loss_every):
    """The fused CP loop: per iteration the measurement-space fidelity dual
    prox (torch ops), the TV dual prox of the over-relaxed iterate
    (``tv_half.dual``: B5), ``A_T``, the primal update with ``A^T y_A`` in
    its y_A slot (``tv_half.primal``: B2), and ``A(x_new)``; per sampled
    loss one TV value (``tv_half.tv``: B3).  On a grid of shards each of
    these runs shard by shard, the kernels in their halo mode
    (``parallel.fused_halo.make_sharded_tv_half``).  The dual rides the
    loop in the kernels' channel-contiguous layout and its storage dtype.
    The primal pass writes x' into a second buffer and the two swap,
    because ``x_bar' = 2 x' - x`` still needs x; its fidelity partial (a
    denoising quantity) is discarded."""
    from ..kernels.fused import from_internal_layout, to_internal_layout

    half = tv_half(cfg, sigma, tau, reg, nonneg)
    x, x_bar, y_A, y_D, sAx, sAx_bar = carry
    if y_D is None:
        shape = space.shape
        Nd = num_channels(cfg.scheme, shape[0], shape[1],
                          cfg.reg_z_over_reg, cfg.reg_time)
        y_D_int = space.map(lambda a: a.new_zeros(
            (a.shape[0], a.shape[1], Nd) + tuple(a.shape[2:]),
            dtype=dual_dtype), x)
    else:
        y_D_int = space.map(lambda a: to_internal_layout(a).to(dual_dtype),
                            y_D)
    # the loop owns its volumes: the caller's state is left alone
    x = space.map(lambda a: a.contiguous().clone(), x)
    x_bar = space.map(lambda a: a.contiguous().clone(), x_bar)
    spare = space.map(torch.empty_like, x)
    first = space.first(b)
    losses = torch.empty(n_iter // loss_every, dtype=torch.float32,
                         device=first.device)
    for i in range(n_iter):
        with span(ITER_SPAN, first.device):
            y_A = space.map(lambda ya, s, bs, w: fidelity_dual_prox(
                ya, s, bs, sigma, fidelity, w), y_A, sAx_bar, b, fw)
            y_D_int = half.dual(x_bar, y_D_int)
            with span(A_T_SPAN, first.device):
                at = space.map(lambda a: a.contiguous(), A_T(y_A))
            x_new = half.primal(x, at, y_D_int, spare)
            space.map(lambda xn, xb, xs: torch.mul(xn, 2.0, out=xb).sub_(xs),
                      x_new, x_bar, x)
            with span(A_SPAN, first.device):
                s_new = A(x_new)
            x, spare, sAx, sAx_bar = x_new, x, s_new, space.map(
                lambda sn, s: 2.0 * sn - s, s_new, sAx)
            if (i + 1) % loss_every == 0:
                losses[i // loss_every] = torch.add(
                    space.sum(lambda sn, bs, w: fidelity_loss(
                        sn, bs, fidelity, w), s_new, b, fw),
                    half.tv(x), alpha=reg)
    final = InverseState(
        x, x_bar, y_A, space.map(
            lambda a: from_internal_layout(a).to(out_dual_dtype), y_D_int),
        sAx, sAx_bar)
    return final, losses


def cp_inverse_grid(pair_of, b, vol_shape, *, data_sharding,
                    n_iter: int = 100, reg: float = 1.0,
                    cfg: TVConfig = TVConfig(),
                    op_norm: Optional[float] = None, x_init=None,
                    precond: bool = False, fidelity: str = "l2",
                    fidelity_weight=1.0, nonneg: bool = False,
                    state: Optional[InverseState] = None, fused: bool = None,
                    dual_dtype=None, loss_every: int = 1,
                    precond_setup: Optional[Callable] = None
                    ) -> InverseResult:
    """:func:`cp_inverse` on a grid of shards (``parallel.mesh``), the same
    loop on ``parallel.halo.grid_space``: ``b[iz][it]`` is a shard of the
    data, placed by ``data_sharding`` (its ``parallel.mesh.Sharding``), and
    ``pair_of(it)`` the ``(A, A_T)`` that maps a volume shard of column
    ``it`` to it and back, with no exchange (a projector that batches over
    z and t).  The TV half runs on the exchanged ``D`` / ``D_T``, or,
    where the fused path is taken, on the kernels in their halo mode shard
    by shard (``parallel.fused_halo.make_sharded_tv_half``: B5, B2 and
    B3); the loss, the norms and the scales of every relative floor are
    taken over the whole grid.  ``op_norm=None`` estimates ``||A||`` by the
    power method on the grid, from the whole volume's start vector cut onto
    it.  ``x_init``, ``state`` (an ``InverseState`` of grids or of whole
    arrays, ``y_D`` in ``shard_d_volume``'s layout) and an array
    ``fidelity_weight`` may be whole arrays, which are cut like the volume
    or, in the data space, by ``data_sharding``, or grids.
    ``precond_setup(fields)``, for an operator whose ``A(1)`` / ``A^T(1)``
    underestimate ``|A|``, returns :func:`cp_inverse`'s ``(precond_sums,
    precond_scale)`` from the grid's :class:`_Fields`.  Every other option
    is :func:`cp_inverse`'s.  Returns ``x`` and every state field as
    grids."""
    check_grid_fidelity(fidelity, b, fidelity_weight)
    fields = grid_fields(pair_of, b, vol_shape, cfg, data_sharding)
    sums, scale = (None, 1.0) if precond_setup is None else \
        precond_setup(fields)
    return _solve(fields, b, n_iter=n_iter, reg=reg, cfg=cfg,
                  op_norm=op_norm, x_init=x_init, precond=precond,
                  fidelity=fidelity, fidelity_weight=fidelity_weight,
                  nonneg=nonneg, state=state, fused=fused,
                  dual_dtype=dual_dtype, loss_every=loss_every,
                  precond_sums=sums, precond_scale=scale)


def check_grid_fidelity(fidelity, b, weight):
    """``validate_fidelity`` on a grid of data shards and a weight that is
    a scalar, a whole array or a grid."""
    from ..parallel.mesh import indexed

    for _, _, part in indexed(b):
        validate_fidelity(fidelity, part, 1.0)
    for _, _, w in (indexed(weight) if is_grid(weight)
                    else [(0, 0, weight)]):
        validate_fidelity(fidelity, torch.zeros(()), w)


def grid_fields(pair_of, b, vol_shape, cfg: TVConfig, data_sharding):
    """The :class:`_Fields` of :func:`cp_inverse_grid`: the grid's space
    (``cfg``'s D / D_T; ``cfg`` None for a solver that builds its own
    operators, as ``solvers.tgv.tgv_inverse_on``), the column pairs applied shard by shard, the
    placement of whole arrays, the preconditioner maps of each shard's
    place in the volume (``parallel.halo.grid_precond_maps``), the seeded
    start field and the TV half on the kernels in their halo mode."""
    from ..parallel import entry
    from ..parallel.fused_halo import make_sharded_tv_half
    from ..parallel.halo import grid_precond_maps, grid_space
    from ..parallel.mesh import (
        d_volume_sharding,
        first_shard,
        grid_mesh,
        mesh_sizes,
        shard,
        volume_sharding,
    )

    vol_shape = tuple(int(n) for n in vol_shape)
    dtype = first_shard(b).dtype
    mesh = grid_mesh(b).mesh
    nz, nt = mesh_sizes(mesh)
    shard_time = nt > 1
    local = (vol_shape[0] // nz, vol_shape[1] // nt) + vol_shape[2:]
    binds = [_bind_operator(*pair_of(it), local, dtype) for it in range(nt)]

    def per_shard(i):
        return lambda grid: [None if row is None else
                             [binds[it][i](cell) for it, cell in
                              enumerate(row)] for row in grid]

    shardings = {"volume": volume_sharding(mesh, shard_time),
                 "d_volume": d_volume_sharding(mesh, shard_time),
                 "data": data_sharding}

    def place(a, kind="volume"):
        if a is None or is_grid(a):
            return a
        if not isinstance(a, torch.Tensor):
            a = torch.as_tensor(np.asarray(a))
        return shard(a, shardings[kind])

    def maps(col):
        return grid_precond_maps(
            mesh, vol_shape, shard_time, scheme=cfg.scheme,
            reg_z_over_reg=cfg.reg_z_over_reg, reg_time=cfg.reg_time,
            fidelity_colsum=col, grouped=(cfg.norm != "aniso"), dtype=dtype)

    def start(seed):
        return place(torch.as_tensor(np.random.default_rng(
            seed).standard_normal(vol_shape)).to(dtype))

    def tv_half(cfg, sigma, tau, reg, nonneg):
        return make_sharded_tv_half(mesh, cfg, vol_shape, shard_time,
                                    sigma=sigma, tau=tau, reg=reg,
                                    nonneg=nonneg)

    return _Fields(grid_space(mesh, cfg, vol_shape, shard_time),
                   per_shard(0), per_shard(1), place, maps, start, tv_half,
                   cfg is not None and entry.shards_fuse(
                       local, vol_shape, cfg, dtype, 1))


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
