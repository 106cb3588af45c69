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
from ..ops.tv import tv_and_subgrad
from .progress import emit_progress


class GDResult(NamedTuple):
    x: torch.Tensor        # denoised image (Nz, M, N_row, N_col)
    loss: torch.Tensor     # per-iteration loss history (n_iter,)
    tv: torch.Tensor       # per-iteration TV history (n_iter,)


def gd_step(x, x_noisy, *, reg, step_size, cfg: TVConfig, mask_static=None,
            weight_time=None):
    """One subgradient-descent update (``README.md:120-123``):

    ``x <- x - step*((x - x0) + reg*G)``; the returned loss uses the TV of the
    *pre-update* iterate and the fidelity of the post-update one, exactly as
    the reference loop records it.
    """
    tv, G = tv_and_subgrad(
        x, cfg.scheme, mask_static=mask_static, weight_time=weight_time,
        norm_type=cfg.norm, huber_delta=cfg.huber_delta, **cfg.kwargs()
    )
    x_new = x - step_size * ((x - x_noisy) + reg * G)
    loss = 0.5 * torch.sum(torch.square(x_new - x_noisy)) + reg * tv
    return x_new, loss, tv


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

    ``fused=None`` takes the fused TV subgradient
    (``kernels.fused.tv_and_subgrad_fused``: kernels B3/B4 on a CUDA tensor,
    their plain versions on the CPU) when ``kernels.dispatch.can_fuse``
    allows it — float32 or bfloat16 storage, plane-shaped ``mask_static`` /
    ``weight_time`` — and ``ops.tv.tv_and_subgrad`` otherwise.
    ``fused=False`` forces the latter.  The update and the loss are plain
    torch ops either way, in x's dtype (a bfloat16 x updates in bfloat16;
    the fused TV is float32, so the loss and TV histories are float32).

    ``progress_every=k`` calls ``progress_fn(iteration, loss)`` on the host
    every k iterations (only those iterations sync).
    """
    from ..kernels.dispatch import can_fuse, t_plane_multiplier

    shape = tuple(x_noisy.shape)
    if fused is None:
        fused = can_fuse(shape, cfg, mask_static=mask_static,
                         dtype=x_noisy.dtype, weight_time=weight_time,
                         for_gd=True)
    x0 = x_noisy
    x = x0 if x_init is None else x_init
    if fused:
        from ..kernels.fused import tv_and_subgrad_fused

        x0, x = x0.contiguous(), x.contiguous()
        tmul = t_plane_multiplier(shape, cfg, mask_static, weight_time,
                                  dtype=x_noisy.dtype, device=x_noisy.device)
        if tmul is not None:
            tmul = tmul.float().contiguous()

        def tv_and_G(x):
            return tv_and_subgrad_fused(x, cfg, tmul=tmul)
    else:
        def tv_and_G(x):
            return tv_and_subgrad(
                x, cfg.scheme, mask_static=mask_static,
                weight_time=weight_time, norm_type=cfg.norm,
                huber_delta=cfg.huber_delta, **cfg.kwargs())

    hist_dtype = torch.float32 if fused else x_noisy.dtype
    losses = torch.empty(n_iter, dtype=hist_dtype, device=x_noisy.device)
    tvs = torch.empty(n_iter, dtype=hist_dtype, device=x_noisy.device)
    for i in range(n_iter):
        tv, G = tv_and_G(x)
        x = x - step_size * ((x - x0) + reg * G)
        loss = 0.5 * torch.sum(torch.square(x - x0)) + reg * tv
        losses[i] = loss
        tvs[i] = tv
        emit_progress(i, loss, progress_every, progress_fn)
    return GDResult(x=x, loss=losses, tv=tvs)
