"""Denoising front-ends over the solver layer (the port of
``pytv4d_tpu/models/denoise.py``): the reference's worked GD and CP examples
(``README.md:107-158``) as library API, the README's noise recipe, and the
scikit-image-compatible ``denoise_tv_chambolle`` (``README.md:260``).

``TVDenoiser`` fronts all five solvers: ``.gd``, ``.cp``, ``.admm``,
``.fista`` and ``.tgv``.

Where a solve runs (``utils.device``): a tensor stays on its own device; a
numpy array or list goes to the CUDA device, and the call raises where there
is none; ``device="cpu"`` asks for the CPU explicitly.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.config import TVConfig
from ..ops.operators import D, D_T
from ..parallel.mesh import is_grid
from ..solvers.admm import admm
from ..solvers.cp import chambolle_pock, default_tau
from ..solvers.fista import fista
from ..solvers.gd import subgradient_descent
from ..solvers.state import run_until_converged
from ..solvers.tgv import tgv_denoise
from ..utils.device import on_device


def add_noise(img, noise_level: float = 100.0, seed: int = 0) -> np.ndarray:
    """The README's noise recipe (``README.md:112-115``):
    ``img + noise_level * U[0,1)`` with ``np.random.seed(seed)``, as float64
    numpy (the same numbers as the JAX package's ``add_noise``)."""
    np.random.seed(seed)
    img = np.asarray(img, dtype=np.float64)
    return img + noise_level * np.random.rand(*img.shape)


def _to_volume(image, device=None):
    """``(volume, rank)``: a 2D / 3D / 4D image as the canonical 4D
    volume on its device; a grid of shards of a 4D volume
    (``parallel.mesh.shard_volume``) passes through as it is, a
    ``device`` naming another than its shards' raising ``ValueError``."""
    if is_grid(image):
        from ..parallel.entry import layout_of

        layout_of(image, device)
        return image, 4
    image = on_device(image, device)
    if image.ndim == 2:
        return image[None, None], 2
    if image.ndim == 3:  # z-stack
        return image[:, None], 3
    if image.ndim == 4:
        return image, 4
    raise ValueError(f"expected 2D/3D/4D image, got shape {tuple(image.shape)}")


def _from_volume(x, ndim):
    if ndim == 2:
        return x[0, 0]
    if ndim == 3:
        return x[:, 0]
    return x


@dataclasses.dataclass(frozen=True)
class TVDenoiser:
    """TV denoising model: minimize ``1/2 ||x - x0||^2 + reg * TV(x)``.

    Accepts a 2D ``(N, N)``, 3D ``(Nz, N, N)`` or 4D ``(Nz, M, N, N)``
    tensor and returns the same rank; the solve runs on the tensor's
    device.  A numpy array goes to the CUDA device (``RuntimeError`` where
    there is none) unless ``device=`` names another.  A grid of shards of
    a 4D volume runs each solver's grid path (``parallel.entry``) and
    comes back as a grid.
    """

    reg: float = 25.0
    cfg: TVConfig = TVConfig()

    def gd(self, noisy, n_iter: int = 300, step_size: float = 5e-3,
           device=None, **kw):
        x, ndim = _to_volume(noisy, device)
        res = subgradient_descent(x, n_iter=n_iter, reg=self.reg,
                                  step_size=step_size, cfg=self.cfg, **kw)
        return res._replace(x=_from_volume(res.x, ndim))

    def cp(self, noisy, n_iter: int = 300, device=None, **kw):
        x, ndim = _to_volume(noisy, device)
        res = chambolle_pock(x, n_iter=n_iter, reg=self.reg, cfg=self.cfg, **kw)
        return res._replace(x=_from_volume(res.x, ndim))

    def admm(self, noisy, n_iter: int = 100, device=None, **kw):
        x, ndim = _to_volume(noisy, device)
        res = admm(x, n_iter=n_iter, reg=self.reg, cfg=self.cfg, **kw)
        return res._replace(x=_from_volume(res.x, ndim))

    def fista(self, noisy, n_iter: int = 100, device=None, **kw):
        x, ndim = _to_volume(noisy, device)
        res = fista(x, n_iter=n_iter, reg=self.reg, cfg=self.cfg, **kw)
        return res._replace(x=_from_volume(res.x, ndim))

    def tgv(self, noisy, n_iter: int = 300, alpha0: float = None,
            device=None, **kw):
        """Second-order TGV denoising (``solvers.tgv``): ``reg`` plays
        alpha1; ``alpha0`` defaults to ``2 * reg`` (the customary ratio).
        Fixes TV's staircasing on piecewise-linear content."""
        x, ndim = _to_volume(noisy, device)
        res = tgv_denoise(x, n_iter=n_iter, alpha1=self.reg,
                          alpha0=2.0 * self.reg if alpha0 is None else alpha0,
                          **kw)
        return res._replace(x=_from_volume(res.x, ndim))


def _cp_vectorial_run(x0, carry, weight, n_iter: int, cfg: TVConfig,
                      compute_loss: bool):
    """VECTORIAL (channel-coupled) TV CP loop on a channel stack
    ``(C, Nz, M, Nr, Nc)``:

        min_x 1/2 sum_c ||x_c - x0_c||^2
              + weight * sum_pixels sqrt(sum_c sum_d D(x_c)_d^2)

    — scikit-image's multichannel semantics: one joint per-pixel norm over
    channels AND difference directions, so edges are encouraged to align
    across channels.  K = blockdiag(D, ..., D) has the same operator norm
    as one D, so the reference step rule applies unchanged; the dual prox
    pools over the (channel, direction) group.  ``carry=None`` starts
    fresh; pass the returned carry to continue (eps chunking).
    ``compute_loss=False`` skips the objective.  Returns ``(carry,
    losses)``, the losses on the device."""
    kw = cfg.kwargs()
    sigma_D, sigma_A = 0.5, 1.0
    tau = default_tau(cfg, x0.shape[1], x0.shape[2], sigma_A)

    def D_c(v):
        return torch.stack([D(c, cfg.scheme, **kw) for c in v])

    def D_T_c(y):
        return torch.stack([D_T(c, cfg.scheme, **kw) for c in y])

    if carry is None:
        carry = (x0, torch.zeros_like(x0), torch.zeros_like(D_c(x0)))
    x, y_A, y_D = carry
    losses = torch.zeros(n_iter, dtype=x0.dtype, device=x0.device)
    for i in range(n_iter):
        y_A = (y_A + sigma_A * (x - x0)) / (1.0 + sigma_A)
        D_x = D_c(x)
        p = y_D + sigma_D * D_x
        # joint per-pixel norm over channels (axis 0) and directions
        # (axis 2 of the (C, Nz, Nd, M, Nr, Nc) stack)
        nrm = torch.sqrt(torch.sum(torch.square(p), dim=(0, 2), keepdim=True))
        y_D = p / torch.clamp_min(nrm / weight, 1.0)
        x = x - tau * y_A - tau * D_T_c(y_D)
        if compute_loss:
            tv = torch.sum(torch.sqrt(torch.sum(torch.square(D_x),
                                                dim=(0, 2))))
            losses[i] = 0.5 * torch.sum(torch.square(x - x0)) + weight * tv
    return (x, y_A, y_D), losses


def _cp_vectorial(stack, weight, n_iter, cfg: TVConfig, eps=None):
    """Front door of :func:`_cp_vectorial_run`: one fixed-length loop, or
    eps-chunked early stopping (relative objective change per chunk; one
    scalar crosses to the host per chunk)."""
    x0 = stack
    if eps is None:
        (x, _, _), _ = _cp_vectorial_run(x0, None, weight, int(n_iter), cfg,
                                         False)
        return x
    carry = None
    done = 0
    chunk = min(20, int(n_iter))
    while done < n_iter:
        n = min(chunk, int(n_iter) - done)
        carry, losses = _cp_vectorial_run(x0, carry, weight, n, cfg, True)
        done += n
        if bool(torch.abs(losses[0] - losses[-1])
                <= eps * torch.abs(losses[-1])):
            break
    return carry[0]


def denoise_tv_chambolle(
    image,
    weight: float = 0.1,
    eps: float = None,
    max_num_iter: int = 200,
    scheme: str = "hybrid",
    channel_axis: int = None,
    coupled_channels: bool = False,
    device=None,
):
    """scikit-image-compatible TV denoising: minimizes ``1/2 ||x - x0||^2 +
    weight * TV(x)`` with the Chambolle-Pock solver and returns a numpy
    array of the input rank.  A numpy image is solved on the CUDA device
    (``RuntimeError`` where there is none) unless ``device=`` names another;
    a tensor on its own device.

    ``eps`` (scikit-image's stopping tolerance): when given, the solve runs
    in chunks and stops once the relative objective change over a chunk
    falls below ``eps`` (or at ``max_num_iter``).  Default ``None`` runs
    exactly ``max_num_iter`` iterations (scikit-image's own default is
    ``eps=2e-4``).

    ``channel_axis`` (scikit-image convention) marks an axis of channels:
    2D multichannel ``(H, W, C)``-style or 3D z-stack multichannel.  By
    default channels are INDEPENDENT (per-channel TV): 2D multichannel
    rides a decoupled z axis, 3D z-stack multichannel the time axis with
    ``reg_time=0``.  ``coupled_channels=True`` switches to scikit-image's
    VECTORIAL TV: one joint per-pixel norm over channels and directions
    (edges align across channels; :func:`_cp_vectorial`).
    """
    if coupled_channels and channel_axis is None:
        raise ValueError("coupled_channels=True requires channel_axis")

    img = on_device(image, device)

    def solve(vol, cfg):
        if eps is None:
            return chambolle_pock(vol, n_iter=max_num_iter, reg=weight,
                                  cfg=cfg)
        return run_until_converged(
            chambolle_pock, vol, tol=eps, chunk=min(20, max_num_iter),
            max_iter=max_num_iter, reg=weight, cfg=cfg,
        )

    if channel_axis is None:
        vol, ndim = _to_volume(img)
        res = solve(vol, TVConfig(scheme=scheme))
        return _from_volume(res.x, ndim).cpu().numpy()

    ch_first = torch.movedim(img, channel_axis, 0)
    if coupled_channels:
        if ch_first.ndim == 3:   # (C, H, W) -> channel stack of 2D volumes
            stack = ch_first[:, None, None]
        elif ch_first.ndim == 4:  # (C, Nz, H, W) -> z-coupled volumes
            stack = ch_first[:, :, None]
        else:
            raise ValueError(
                f"channel_axis given but image has rank {img.ndim}; "
                f"expected 3 or 4"
            )
        x = _cp_vectorial(stack.contiguous(), weight, max_num_iter,
                          TVConfig(scheme=scheme), eps=eps)
        out = x.reshape(ch_first.shape)
        return torch.movedim(out, 0, channel_axis).cpu().numpy()
    if ch_first.ndim == 3:       # 2D multichannel: channels -> decoupled z
        vol = ch_first[:, None].contiguous()  # (C, 1, H, W)
        res = solve(vol, TVConfig(scheme=scheme, reg_z_over_reg=0.0))
        out = res.x[:, 0]
    elif ch_first.ndim == 4:     # 3D z-stack multichannel: channels -> t
        vol = torch.movedim(ch_first, 0, 1).contiguous()
        res = solve(vol, TVConfig(scheme=scheme))
        out = torch.movedim(res.x, 1, 0)
    else:
        raise ValueError(
            f"channel_axis given but image has rank {img.ndim}; expected 3 "
            f"(2D multichannel) or 4 (3D z-stack multichannel)"
        )
    return torch.movedim(out, 0, channel_axis).cpu().numpy()
