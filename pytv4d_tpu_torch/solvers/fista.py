"""Accelerated dual FISTA for TV denoising: a fourth solver family beyond
the reference's GD/CP recipes (Beck & Teboulle 2009, "Fast gradient-based
algorithms for constrained total variation image denoising and deblurring",
doi 10.1109/TIP.2009.2028250).  The port of ``pytv4d_tpu/solvers/fista.py``,
as an eager PyTorch loop on the tensor's own device (the JAX solver runs no
kernel either).

The denoising problem ``min_x 1/2||x - x0||^2 + reg * ||D x||_{2,1}`` has
the dual ``min_{||y_i|| <= reg} 1/2 ||x0 - D^T y||^2`` (up to a constant);
FISTA on the dual with the ball projection converges O(1/k^2), typically in
far fewer iterations than CP or subgradient descent for pure denoising.
Primal recovery: ``x = x0 - D^T y``.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.config import TVConfig
from ..core.schemes import operator_norm_bound_sq
from ..ops.operators import D, D_T, _safe_sqrt, tv_norm
from ..utils.device import on_device


class FISTAResult(NamedTuple):
    x: torch.Tensor     # denoised image (primal recovery)
    y: torch.Tensor     # dual variable (Nz, Nd, M, N_row, N_col)
    loss: torch.Tensor  # primal objective history (n_iter,), on the device


def _project_dual(y, radius, norm: str):
    """Projection onto the TV-norm dual ball: per-pixel L2 ball (isotropic)
    or the [-radius, radius] box (anisotropic)."""
    if norm == "aniso":
        return torch.clamp(y, -radius, radius)
    norms = _safe_sqrt(torch.sum(torch.square(y), dim=1, keepdim=True))
    return y / torch.clamp_min(norms / radius, 1.0)


def fista(
    x_noisy,
    n_iter: int = 100,
    reg: float = 25.0,
    cfg: TVConfig = TVConfig(),
    L: float = None,
    y_init=None,
    mask_static=None,
    weight_time=None,
    device=None,
) -> FISTAResult:
    """Run ``n_iter`` dual-FISTA iterations on ``x_noisy``'s device: a
    tensor's own; the CUDA device for a numpy array (``RuntimeError`` where
    there is none), or ``device`` where given (``utils.device``).

    ``L`` defaults to the scheme's operator-norm bound ``||D||^2``
    (``core.schemes.operator_norm_bound_sq``).  The loss history reports the
    PRIMAL objective at each iterate for comparability with the other
    solvers.  ``mask_static``/``weight_time`` follow the reference's
    time-channel weighting; pass an explicit ``L`` if a weight plane
    exceeds 1 (the default bound assumes multipliers <= 1).  ``y_init``
    warm-starts the dual (the momentum restarts at 1, as in the JAX solver).
    """
    x_noisy = on_device(x_noisy, device)
    if cfg.norm == "huber":
        raise ValueError(
            "fista supports norm='iso'/'aniso' only (the Huber dual adds a "
            "quadratic term to the ball constraint); use chambolle_pock or "
            "admm for Huber-TV"
        )
    kw = dict(mask_static=mask_static, weight_time=weight_time,
              **cfg.kwargs())
    if L is None:
        L = operator_norm_bound_sq(cfg.scheme, x_noisy.shape[0],
                                   x_noisy.shape[1], cfg.reg_z_over_reg,
                                   cfg.reg_time)
    inv_L = 1.0 / L

    if y_init is None:
        y = torch.zeros_like(D(x_noisy, cfg.scheme, **kw))
    else:
        y = y_init
    w = y
    t = torch.ones((), dtype=x_noisy.dtype, device=x_noisy.device)
    losses = torch.empty(n_iter, dtype=x_noisy.dtype, device=x_noisy.device)
    for i in range(n_iter):
        # gradient of the dual: -D(x0 - D^T w); step 1/L; ball projection
        x_w = x_noisy - D_T(w, cfg.scheme, **kw)
        y_new = _project_dual(w + inv_L * D(x_w, cfg.scheme, **kw), reg,
                              cfg.norm)
        t_new = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * t * t))
        w = y_new + ((t - 1.0) / t_new) * (y_new - y)
        x = x_noisy - D_T(y_new, cfg.scheme, **kw)
        losses[i] = 0.5 * torch.sum(torch.square(x - x_noisy)) + reg * tv_norm(
            D(x, cfg.scheme, **kw), cfg.norm)
        y, t = y_new, t_new
    x = x_noisy - D_T(y, cfg.scheme, **kw)
    return FISTAResult(x=x, y=y, loss=losses)
