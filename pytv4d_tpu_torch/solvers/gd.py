"""Subgradient-descent TV denoising — the reference's user-loop recipe
(``README.md:107-124``) as an eager PyTorch loop on the tensor's own device
(the port of ``pytv4d_tpu/solvers/gd.py``).

The reference pays three host<->device round trips per iteration (SURVEY.md
section 3.2); here the iterate never leaves the device and the loss and TV
histories come back as one tensor each, written in place on the device with
no host read inside the loop.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.config import TVConfig
from ..ops.space import TENSOR, Space
from ..ops.tv import tv_and_subgrad
from ..parallel.mesh import is_grid
from ..utils.profiling import ITER_SPAN, solve_span, span
from .progress import emit_progress


class GDResult(NamedTuple):
    x: torch.Tensor        # denoised image (Nz, M, N_row, N_col)
    loss: torch.Tensor     # per-iteration loss history (n_iter,)
    tv: torch.Tensor       # per-iteration TV history (n_iter,)


def _update(space: Space, tv_and_G, x, x_noisy, reg, step_size):
    """The subgradient-descent update on ``space``'s fields
    (``README.md:120-123``): ``x <- x - step*((x - x0) + reg*G)``, and the
    loss with the TV of the *pre-update* iterate and the fidelity of the
    post-update one, exactly as the reference loop records it."""
    tv, G = tv_and_G(x)
    x = space.map(lambda xs, x0, g: xs - step_size * ((xs - x0) + reg * g),
                  x, x_noisy, G)
    loss = space.sum(lambda xs, x0: 0.5 * torch.sum(torch.square(xs - x0)),
                     x, x_noisy) + reg * tv
    return x, loss, tv


def eager_step(space: Space, tv_and_G, x_noisy, reg, step_size):
    """:func:`gd_loop`'s step on ``space``'s fields: :func:`_update` on
    ``tv_and_G(x) -> (tv, G)``, the TV and its subgradient."""
    return lambda x: _update(space, tv_and_G, x, x_noisy, reg, step_size)


def fused_step(x_noisy, cfg: TVConfig, tmul, reg, step_size):
    """:func:`gd_loop`'s step on a tensor that the fused kernels take: B3
    (``kernels.fused.tv_norms``), then B4 with its GD epilogue
    (``kernels.fused.tv_gd_step``), which writes x' and the fidelity
    partials and never stores G; on the CPU their plain versions, G and
    then :func:`_update`, so x' is the eager update's to the bit.  The
    loss and TV are :func:`_update`'s, in float32: the TV of the
    pre-update iterate, the fidelity of the post-update one."""
    from ..kernels import fused

    def step(x):
        norms, tv_parts = fused.tv_norms(x, tmul, cfg=cfg)
        x, fid_parts = fused.tv_gd_step(x, x_noisy, norms, tmul, cfg=cfg,
                                        reg=reg, step_size=step_size)
        tv = torch.sum(tv_parts)
        return x, torch.sum(fid_parts) + reg * tv, tv

    return step


def gd_step(x, x_noisy, *, reg, step_size, cfg: TVConfig, mask_static=None,
            weight_time=None):
    """One subgradient-descent update of a tensor (:func:`_update` on
    ``ops.tv.tv_and_subgrad``): ``(x', loss, tv)``."""
    def tv_and_G(v):
        return tv_and_subgrad(
            v, cfg.scheme, mask_static=mask_static, weight_time=weight_time,
            norm_type=cfg.norm, huber_delta=cfg.huber_delta, **cfg.kwargs())

    return _update(TENSOR, tv_and_G, x, x_noisy, reg, step_size)


def gd_loop(space: Space, step, x, *, n_iter, hist_dtype, each=None):
    """``n_iter`` steps from ``x`` on ``space``'s fields (``ops.space``:
    a tensor or a grid of shards), ``step(x) -> (x', loss, tv)``
    (:func:`eager_step` or :func:`fused_step`): ``(x, losses, tvs)``, the
    histories ``hist_dtype`` tensors on the fields' device.
    ``each(i, loss)`` is called after every iteration."""
    device = space.first(x).device
    losses = torch.empty(n_iter, dtype=hist_dtype, device=device)
    tvs = torch.empty(n_iter, dtype=hist_dtype, device=device)
    for i in range(n_iter):
        with span(ITER_SPAN, device):
            x, loss, tv = step(x)
            losses[i] = loss
            tvs[i] = tv
            if each is not None:
                each(i, loss)
    return x, losses, tvs


@solve_span
def subgradient_descent(
    x_noisy,
    n_iter: int = 300,
    reg: float = 25.0,
    step_size: float = 5e-3,
    cfg: TVConfig = TVConfig(),
    x_init=None,
    mask_static=None,
    weight_time=None,
    fused: bool = None,
    progress_every: int = 0,
    progress_fn=None,
) -> GDResult:
    """Run ``n_iter`` subgradient-descent iterations on ``x_noisy``'s device.

    Defaults are the reference's README recipe (``README.md:108-116``:
    reg=25, step=5e-3, 300 iterations).  ``x_init`` defaults to the noisy
    image, as in the recipe.  The inputs are never modified.

    ``fused=None`` takes the fused step (:func:`fused_step`: kernels B3
    and B4, which takes the update and the fidelity in its epilogue, on a
    CUDA tensor; their plain versions on the CPU) when
    ``kernels.dispatch.can_fuse`` allows it — float32 or bfloat16 storage,
    plane-shaped ``mask_static`` / ``weight_time`` — and
    ``ops.tv.tv_and_subgrad`` with the eager update otherwise.
    ``fused=False`` forces the latter.  Either way x updates in its own
    dtype (a bfloat16 x in bfloat16, rounded as the eager ops round).  The
    fused TV is float32, so the fused loss and TV histories are float32.

    ``progress_every=k`` calls ``progress_fn(iteration, loss)`` on the host
    every k iterations (only those iterations sync).

    A grid of shards (``parallel.mesh.shard_volume``) runs the same loop
    shard by shard on the TV of ``parallel.entry.gd_operators``: kernels
    B3 / B4 in their halo mode for CUDA shards they serve
    (``fused=None`` / ``True`` as on a tensor), else ``parallel.halo``'s
    plain stencils; ``x`` comes back as a grid, ``x_init`` may be one.
    """
    from ..kernels.dispatch import can_fuse, t_plane_multiplier

    x0 = x_noisy
    if is_grid(x_noisy):
        from ..parallel import entry

        space, tv_and_G, fused = entry.gd_operators(
            x_noisy, cfg, mask_static, weight_time, fused)
        x = x0 if x_init is None else space.place(x_init)
        step = eager_step(space, tv_and_G, x0, reg, step_size)
    else:
        space = TENSOR
        shape = tuple(x_noisy.shape)
        if fused is None:
            fused = can_fuse(shape, cfg, mask_static=mask_static,
                             dtype=x_noisy.dtype, weight_time=weight_time,
                             for_gd=True)
        x = x0 if x_init is None else x_init
        if fused:
            x0, x = x0.contiguous(), x.contiguous()
            tmul = t_plane_multiplier(shape, cfg, mask_static, weight_time,
                                      dtype=x_noisy.dtype,
                                      device=x_noisy.device)
            if tmul is not None:
                tmul = tmul.float().contiguous()
            step = fused_step(x0, cfg, tmul, reg, step_size)
        else:
            def tv_and_G(x):
                return tv_and_subgrad(
                    x, cfg.scheme, mask_static=mask_static,
                    weight_time=weight_time, norm_type=cfg.norm,
                    huber_delta=cfg.huber_delta, **cfg.kwargs())

            step = eager_step(space, tv_and_G, x0, reg, step_size)

    hist_dtype = torch.float32 if fused else space.first(x_noisy).dtype
    x, losses, tvs = gd_loop(
        space, step, x, n_iter=n_iter, hist_dtype=hist_dtype,
        each=(lambda i, loss: emit_progress(i, loss, progress_every,
                                            progress_fn))
        if progress_every else None)
    return GDResult(x=x, loss=losses, tv=tvs)
