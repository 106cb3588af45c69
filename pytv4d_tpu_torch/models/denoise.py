"""Denoising front-ends over the solver layer (the port of
``pytv4d_tpu/models/denoise.py``): the reference's worked GD and CP examples
(``README.md:107-158``) as library API, the README's noise recipe, and the
scikit-image-compatible ``denoise_tv_chambolle`` (``README.md:260``).

The subgradient-descent, Chambolle-Pock and TGV-2 solvers are ported:
``TVDenoiser`` has ``.gd``, ``.cp`` and ``.tgv``, and no ``.admm`` /
``.fista`` yet (ROADMAP.md queue A).

Where a solve runs (``utils.device``): a tensor stays on its own device; a
numpy array or list goes to the CUDA device, and the call raises where there
is none; ``device="cpu"`` asks for the CPU explicitly.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.config import TVConfig
from ..solvers.cp import chambolle_pock
from ..solvers.gd import subgradient_descent
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
    there is none) unless ``device=`` names another.
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
    weight * TV(x)`` with ``max_num_iter`` Chambolle-Pock iterations and
    returns a numpy array of the input rank.  A numpy image is solved on
    the CUDA device (``RuntimeError`` where there is none) unless
    ``device=`` names another; a tensor on its own device.

    ``channel_axis`` marks an axis of independent channels (per-channel TV):
    2D multichannel rides a decoupled z axis, 3D z-stack multichannel the
    time axis with ``reg_time=0``.  ``eps`` early stopping and
    ``coupled_channels=True`` (vectorial TV) are not ported yet.
    """
    if coupled_channels and channel_axis is None:
        raise ValueError("coupled_channels=True requires channel_axis")
    if eps is not None:
        raise NotImplementedError(
            "denoise_tv_chambolle(eps=...) needs run_until_converged, which "
            "is not ported yet (ROADMAP.md queue A: solvers/state.py)")
    if coupled_channels:
        raise NotImplementedError(
            "coupled_channels=True (vectorial TV) is not ported yet "
            "(ROADMAP.md queue A: vectorial TV in models/denoise.py)")

    img = on_device(image, device)

    def solve(vol, cfg):
        return chambolle_pock(vol, n_iter=max_num_iter, reg=weight, cfg=cfg)

    if channel_axis is None:
        vol, ndim = _to_volume(img)
        res = solve(vol, TVConfig(scheme=scheme))
        return _from_volume(res.x, ndim).cpu().numpy()

    ch_first = torch.movedim(img, channel_axis, 0)
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
