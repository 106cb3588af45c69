"""ADMM TV denoising: the third solver family the reference claims support
for (``README.md:26``) but never ships.  The port of
``pytv4d_tpu/solvers/admm.py``, as an eager PyTorch loop on the tensor's own
device (the JAX solver runs no kernel either).

Minimizes ``1/2 ||x - x0||^2 + reg * ||D x||_{2,1}`` via the split
``z = D x``:

- x-update: ``(I + rho D^T D) x = x0 + rho D^T (z - u)`` solved matrix-free
  with conjugate gradients (D^T D is a fixed stencil, so a handful of CG
  iterations suffice);
- z-update: group soft-threshold (prox of the L2,1 norm) per pixel;
- u-update: scaled dual ascent.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.config import TVConfig
from ..core.schemes import num_channels
from ..ops.operators import D, D_T, tv_norm
from ..utils.device import on_device


class ADMMState(NamedTuple):
    x: torch.Tensor   # primal image (Nz, M, N_row, N_col)
    z: torch.Tensor   # split variable (Nz, Nd, M, N_row, N_col)
    u: torch.Tensor   # scaled dual (Nz, Nd, M, N_row, N_col)


class ADMMResult(NamedTuple):
    x: torch.Tensor
    state: ADMMState
    loss: torch.Tensor  # per-iteration loss history (n_iter,), on the device


def _cg_solve(apply_A, b, x0, n_iter: int):
    """Matrix-free CG for SPD ``A`` (fixed iteration count; every scalar
    stays on the device)."""
    x = x0
    r = b - apply_A(x0)
    p = r
    rs = torch.sum(r * r)
    for _ in range(n_iter):
        Ap = apply_A(p)
        alpha = rs / (torch.sum(p * Ap) + 1e-30)
        x = x + alpha * p
        r = r - alpha * Ap
        rs_new = torch.sum(r * r)
        p = r + (rs_new / (rs + 1e-30)) * p
        rs = rs_new
    return x


def group_soft_threshold(v, thresh, norm: str = "iso",
                         huber_delta: float = 1.0):
    """Prox of ``thresh * TV-norm``: group (L2,1) shrinkage per pixel for
    isotropic TV, elementwise soft threshold for anisotropic L1,1, and for
    Huber the scale-or-shrink form (``v/(1+thresh/delta)`` inside the
    quadratic region ``|v| <= delta + thresh``, soft shrink outside:
    continuous at the boundary)."""
    if norm == "aniso":
        return torch.sign(v) * torch.clamp_min(torch.abs(v) - thresh, 0.0)
    norms = torch.sqrt(torch.sum(torch.square(v), dim=1, keepdim=True))
    if norm == "huber":
        shrink = 1.0 - thresh / torch.clamp_min(norms, 1e-30)
        scale = torch.where(norms <= huber_delta + thresh,
                            1.0 / (1.0 + thresh / huber_delta), shrink)
        return v * scale
    scale = torch.clamp_min(1.0 - thresh / torch.clamp_min(norms, 1e-30), 0.0)
    return v * scale


def admm_step(state: ADMMState, x_noisy, *, reg, rho, cg_iter, cfg: TVConfig,
              mask_static=None, weight_time=None):
    """One ADMM iteration: ``(state, x0) -> (state', loss)`` with
    ``loss = 1/2 ||x' - x0||^2 + reg * TV(D x')``."""
    kw = dict(mask_static=mask_static, weight_time=weight_time,
              **cfg.kwargs())
    x, z, u = state

    def apply_A(v):
        return v + rho * D_T(D(v, cfg.scheme, **kw), cfg.scheme, **kw)

    b = x_noisy + rho * D_T(z - u, cfg.scheme, **kw)
    x = _cg_solve(apply_A, b, x, cg_iter)
    D_x = D(x, cfg.scheme, **kw)
    z = group_soft_threshold(D_x + u, reg / rho, cfg.norm, cfg.huber_delta)
    u = u + D_x - z
    loss = 0.5 * torch.sum(torch.square(x - x_noisy)) + reg * tv_norm(
        D_x, cfg.norm, huber_delta=cfg.huber_delta)
    return ADMMState(x, z, u), loss


def init_state(x_noisy, cfg: TVConfig, x_init=None) -> ADMMState:
    """A cold start: ``x = x_noisy``, zero split variable and dual."""
    Nz, M = x_noisy.shape[0], x_noisy.shape[1]
    Nd = num_channels(cfg.scheme, Nz, M, cfg.reg_z_over_reg, cfg.reg_time)
    shape = (Nz, Nd, M) + tuple(x_noisy.shape[2:])
    kw = dict(dtype=x_noisy.dtype, device=x_noisy.device)
    return ADMMState(
        x=x_noisy if x_init is None else x_init,
        z=torch.zeros(shape, **kw),
        u=torch.zeros(shape, **kw),
    )


def admm(
    x_noisy,
    n_iter: int = 100,
    reg: float = 25.0,
    rho: float = 10.0,
    cg_iter: int = 8,
    cfg: TVConfig = TVConfig(),
    state: ADMMState = None,
    mask_static=None,
    weight_time=None,
    device=None,
) -> ADMMResult:
    """Run ``n_iter`` ADMM iterations on ``x_noisy``'s device (``state``
    resumes a run): a tensor's own; the CUDA device for a numpy array
    (``RuntimeError`` where there is none), or ``device`` where given
    (``utils.device``).  The inputs are never modified; the loss history
    stays on the device."""
    x_noisy = on_device(x_noisy, device)
    if state is None:
        state = init_state(x_noisy, cfg)
    state = ADMMState(*state)
    losses = torch.empty(n_iter, dtype=x_noisy.dtype, device=x_noisy.device)
    for i in range(n_iter):
        state, losses[i] = admm_step(
            state, x_noisy, reg=reg, rho=rho, cg_iter=cg_iter, cfg=cfg,
            mask_static=mask_static, weight_time=weight_time,
        )
    return ADMMResult(x=state.x, state=state, loss=losses)
