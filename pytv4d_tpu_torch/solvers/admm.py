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
from ..ops.operators import tv_norm
from ..ops.space import TENSOR, Space, d_zeros, tensor_space
from ..parallel.mesh import is_grid
from ..utils.device import on_device


class ADMMState(NamedTuple):
    x: torch.Tensor   # primal image (Nz, M, N_row, N_col)
    z: torch.Tensor   # split variable (Nz, Nd, M, N_row, N_col)
    u: torch.Tensor   # scaled dual (Nz, Nd, M, N_row, N_col)


class ADMMResult(NamedTuple):
    x: torch.Tensor
    state: ADMMState
    loss: torch.Tensor  # per-iteration loss history (n_iter,), on the device


def _cg_solve(apply_A, b, x0, n_iter: int, space: Space = TENSOR):
    """Matrix-free CG for SPD ``A`` (fixed iteration count; every scalar
    stays on the device) on ``space``'s fields (``ops.space``): on a grid
    every inner product is a sum over shards."""
    def dot(u, v):
        return space.sum(lambda a, c: torch.sum(a * c), u, v)

    x = x0
    r = space.map(torch.sub, b, apply_A(x0))
    p = r
    rs = dot(r, r)
    for _ in range(n_iter):
        Ap = apply_A(p)
        alpha = rs / (dot(p, Ap) + 1e-30)
        x = space.map(lambda xs, ps: xs + alpha * ps, x, p)
        r = space.map(lambda rs_, aps: rs_ - alpha * aps, r, Ap)
        rs_new = dot(r, r)
        beta = rs_new / (rs + 1e-30)
        p = space.map(lambda rs_, ps: rs_ + beta * ps, r, p)
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
              mask_static=None, weight_time=None, space: Space = None):
    """One ADMM iteration: ``(state, x0) -> (state', loss)`` with
    ``loss = 1/2 ||x' - x0||^2 + reg * TV(D x')``, on ``space``'s fields
    (``ops.space``; a tensor's from ``cfg`` and the masks by default)."""
    if space is None:
        space = tensor_space(cfg, mask_static, weight_time)
    x, z, u = state

    def apply_A(v):
        return space.map(lambda a, b: a + rho * b, v, space.D_T(space.D(v)))

    b = space.map(lambda x0, d: x0 + rho * d, x_noisy,
                  space.D_T(space.map(torch.sub, z, u)))
    x = _cg_solve(apply_A, b, x, cg_iter, space)
    D_x = space.D(x)
    z = space.map(lambda d, us: group_soft_threshold(
        d + us, reg / rho, cfg.norm, cfg.huber_delta), D_x, u)
    u = space.map(lambda us, d, zs: us + d - zs, u, D_x, z)
    loss = space.sum(lambda xs, x0, d: 0.5 * torch.sum(torch.square(xs - x0))
                     + reg * tv_norm(d, cfg.norm, huber_delta=cfg.huber_delta),
                     x, x_noisy, D_x)
    return ADMMState(x, z, u), loss


def init_state(x_noisy, cfg: TVConfig, x_init=None,
               space: Space = None) -> ADMMState:
    """A cold start: ``x = x_noisy``, zero split variable and dual;
    ``space`` (``ops.space``) for a grid of shards."""
    space = space or tensor_space(shape=x_noisy.shape)
    Nd = num_channels(cfg.scheme, space.shape[0], space.shape[1],
                      cfg.reg_z_over_reg, cfg.reg_time)
    return ADMMState(
        x=x_noisy if x_init is None else x_init,
        z=d_zeros(space, x_noisy, Nd),
        u=d_zeros(space, x_noisy, Nd),
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
    stays on the device.  A grid of shards (``parallel.mesh.shard_volume``)
    runs the same loop on ``parallel.halo.grid_space``'s exchanged
    stencils; ``x`` and the state come back as grids, and ``state`` may be
    an ``ADMMState`` of grids or of volumes."""
    if is_grid(x_noisy):
        from ..parallel import entry

        space = entry.solver_space(x_noisy, cfg, mask_static, weight_time,
                                   device)
    else:
        x_noisy = on_device(x_noisy, device)
        space = tensor_space(cfg, mask_static, weight_time, x_noisy.shape)
    if state is None:
        state = init_state(x_noisy, cfg, space=space)
    state = ADMMState(space.place(state[0]),
                      *(space.place(a, d_volume=True) for a in state[1:]))
    losses = torch.empty(n_iter, dtype=space.first(x_noisy).dtype,
                         device=space.first(x_noisy).device)
    for i in range(n_iter):
        state, losses[i] = admm_step(
            state, x_noisy, reg=reg, rho=rho, cg_iter=cg_iter, cfg=cfg,
            space=space,
        )
    return ADMMResult(x=state.x, state=state, loss=losses)
