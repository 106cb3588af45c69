"""TV value + subgradient — the reference's ``tv_<scheme>`` entry points, on
torch tensors (the port of ``pytv4d_tpu/ops/tv.py``).

Parity: ``pytv/tv_CPU.py:47-333`` / ``pytv/tv_GPU.py:47-376``.  G is
exactly the *unweighted* adjoint scatter of ``D_img / grad_norms`` followed
by the scheme normalization: the per-axis sqrt(reg) weights and the
static-mask factor are deliberately NOT reapplied in G (``tv_CPU.py:104-121``
scatters the z/t channels bare), while ``D_img`` already carries one
normalization, so the iso G holds it twice.  :func:`_subgrad_from_D`
reproduces that convention with :func:`ops.operators.dt_channel`.

Nonsmooth convention: where a pixel's gradient norm is 0 the TV is
non-differentiable and the subgradient contribution is set to 0 by replacing
the norm with +inf (``tv_CPU.py:85-86``).  Autograd of ``l21 o D`` would
give NaN there (0/0), which is why :func:`make_tv` is a
``torch.autograd.Function`` whose backward is this subgradient.
"""

from __future__ import annotations

import functools

import torch

from ..core.schemes import scheme_channels
from .operators import (
    D,
    D_T,
    _as_mask,
    compute_huber_norm,
    compute_L11_norm,
    compute_L21_norm,
    dt_channel,
    mask_enabled,
)

__all__ = [
    "tv_and_subgrad",
    "tv_upwind",
    "tv_downwind",
    "tv_central",
    "tv_hybrid",
    "make_tv",
]


def _subgrad_from_D(D_img, grad_norms_safe, scheme, Nz, M, reg_z_over_reg,
                    reg_time):
    """G = normalization * unweighted-adjoint(D_img / grad_norms).

    Mirrors the scatter algebra of ``tv_CPU.py:92-124`` (hybrid), ``:176-187``
    (downwind), ``:239-250`` (upwind), ``:302-325`` (central, incl. the Nz==2 /
    M==2 upwind-fallback branches which the scheme table already encodes).
    """
    chans, norm = scheme_channels(scheme, Nz, M, reg_z_over_reg, reg_time)
    Y = D_img / grad_norms_safe[:, None]
    G = None
    for i, ch in enumerate(chans):
        contrib = dt_channel(Y[:, i], ch.axis, ch.kind)
        G = contrib if G is None else G + contrib
    if G is None:
        G = torch.zeros_like(grad_norms_safe)
    if norm != 1.0:
        G = G * norm
    return G


def tv_and_subgrad(
    img,
    scheme: str = "hybrid",
    mask=None,
    reg_z_over_reg: float = 1.0,
    reg_time: float = 0.0,
    mask_static=False,
    factor_reg_static: float = 0.0,
    weight_time=None,
    return_grad_norms: bool = False,
    norm_type: str = "iso",
    huber_delta: float = 1.0,
):
    """Total variation and a subgradient of ``img`` (``(Nz, M, N_row, N_col)``),
    on the tensor's device.

    Returns ``(tv, G)`` or ``(tv, G, grad_norms)``; ``grad_norms`` has zeros
    already replaced by +inf, as the reference returns it (``tv_CPU.py:86,127``).

    ``mask`` zeroes masked-out pixels before the TV computation
    (``img = where(mask, img, 0)``; the reference's own ``mask`` kwarg raises
    on a real array, SURVEY.md section 2.4.2).

    ``norm_type='aniso'``: the anisotropic L1,1 TV ``sum |D x|`` and the true
    subgradient ``G = D^T sign(D x)`` (full weights); ``grad_norms`` is the
    per-pixel |channel| sum.  ``norm_type='huber'``: the Huber-smoothed
    isotropic TV and its true gradient ``G = D^T(D x / max(|D x|_2, delta))``
    (full weights, no inf convention); ``grad_norms`` is the raw magnitude.
    """
    if mask_enabled(mask):
        img = torch.where(_as_mask(mask, img), img, torch.zeros_like(img))
    Nz, M = img.shape[0], img.shape[1]

    kw = dict(
        reg_z_over_reg=reg_z_over_reg,
        reg_time=reg_time,
        mask_static=mask_static,
        factor_reg_static=factor_reg_static,
        weight_time=weight_time,
    )
    D_img = D(img, scheme, **kw)
    if norm_type == "aniso":
        tv, norms = compute_L11_norm(D_img, return_array=True)
        G = D_T(torch.sign(D_img), scheme, **kw)
    elif norm_type == "huber":
        tv, norms = compute_huber_norm(D_img, huber_delta, return_array=True)
        G = D_T(D_img / torch.clamp_min(norms, huber_delta)[:, None], scheme,
                **kw)
    else:
        tv, norms = compute_L21_norm(D_img, return_array=True)
        norms = torch.where(norms == 0, torch.inf, norms)
        G = _subgrad_from_D(D_img, norms, scheme, Nz, M, reg_z_over_reg,
                            reg_time)
    if return_grad_norms:
        return tv, G, norms
    return tv, G


def _scheme_partial(scheme):
    fn = functools.partial(tv_and_subgrad, scheme=scheme)
    fn.__name__ = f"tv_{scheme}"
    fn.__qualname__ = fn.__name__
    fn.__doc__ = f"tv_and_subgrad(..., scheme={scheme!r}); see :func:`tv_and_subgrad`."
    return fn


tv_upwind = _scheme_partial("upwind")
tv_downwind = _scheme_partial("downwind")
tv_central = _scheme_partial("central")
tv_hybrid = _scheme_partial("hybrid")


class _TV(torch.autograd.Function):
    """The iso TV value; its backward is ``grad_out * G`` with G the
    reference's subgradient (0 at zero-gradient pixels, never NaN)."""

    @staticmethod
    def forward(ctx, img, scheme, reg_z_over_reg, reg_time):
        tv, G = tv_and_subgrad(img, scheme, reg_z_over_reg=reg_z_over_reg,
                               reg_time=reg_time)
        ctx.save_for_backward(G)
        return tv

    @staticmethod
    def backward(ctx, grad_out):
        (G,) = ctx.saved_tensors
        return grad_out * G, None, None, None


@functools.lru_cache(maxsize=None)
def make_tv(
    scheme: str = "hybrid",
    reg_z_over_reg: float = 1.0,
    reg_time: float = 0.0,
):
    """Build ``tv_fn(img) -> scalar``, differentiable with the reference's
    subgradient convention as its backward (the JAX package's custom VJP,
    SURVEY.md section 7 "hard parts" item 4).  Use with ``torch.autograd``
    and ``torch.optim``."""

    def tv_fn(img):
        return _TV.apply(img, scheme, reg_z_over_reg, reg_time)

    tv_fn.__name__ = f"tv_{scheme}_value"
    return tv_fn
