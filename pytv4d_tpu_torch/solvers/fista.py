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
from ..core.schemes import num_channels, operator_norm_bound_sq
from ..ops.operators import _safe_sqrt, tv_norm
from ..ops.space import d_zeros, tensor_space
from ..parallel.mesh import is_grid
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

    A grid of shards (``parallel.mesh.shard_volume``) runs the same loop
    on ``parallel.halo.grid_space``'s exchanged stencils; ``x`` and ``y``
    come back as grids, ``y_init`` may be one or a whole dual.
    """
    if cfg.norm == "huber":
        raise ValueError(
            "fista supports norm='iso'/'aniso' only (the Huber dual adds a "
            "quadratic term to the ball constraint); use chambolle_pock or "
            "admm for Huber-TV"
        )
    if is_grid(x_noisy):
        from ..parallel import entry

        space = entry.solver_space(x_noisy, cfg, mask_static, weight_time,
                                   device)
    else:
        x_noisy = on_device(x_noisy, device)
        space = tensor_space(cfg, mask_static, weight_time, x_noisy.shape)
    if L is None:
        L = operator_norm_bound_sq(cfg.scheme, space.shape[0],
                                   space.shape[1], cfg.reg_z_over_reg,
                                   cfg.reg_time)
    inv_L = 1.0 / L

    if y_init is None:
        y = d_zeros(space, x_noisy, num_channels(
            cfg.scheme, space.shape[0], space.shape[1], cfg.reg_z_over_reg,
            cfg.reg_time))
    else:
        y = space.place(y_init, d_volume=True)
    w = y
    first = space.first(x_noisy)
    t = torch.ones((), dtype=first.dtype, device=first.device)
    losses = torch.empty(n_iter, dtype=first.dtype, device=first.device)

    def primal(y):
        return space.map(torch.sub, x_noisy, space.D_T(y))

    for i in range(n_iter):
        # gradient of the dual: -D(x0 - D^T w); step 1/L; ball projection
        y_new = space.map(lambda ws, d: _project_dual(ws + inv_L * d, reg,
                                                      cfg.norm),
                          w, space.D(primal(w)))
        t_new = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * t * t))
        mom = (t - 1.0) / t_new
        w = space.map(lambda yn, ys: yn + mom * (yn - ys), y_new, y)
        x = primal(y_new)
        losses[i] = space.sum(
            lambda xs, x0, d: 0.5 * torch.sum(torch.square(xs - x0))
            + reg * tv_norm(d, cfg.norm), x, x_noisy, space.D(x))
        y, t = y_new, t_new
    return FISTAResult(x=primal(y), y=y, loss=losses)
