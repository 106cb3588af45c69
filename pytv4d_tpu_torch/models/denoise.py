"""Denoising front-ends over the solver layer (the port of
``pytv4d_tpu/models/denoise.py``): the reference's worked GD and CP examples
(``README.md:107-158``) as library API, the README's noise recipe, and the
scikit-image-compatible ``denoise_tv_chambolle`` (``README.md:260``).

The subgradient-descent and Chambolle-Pock solvers are ported:
``TVDenoiser`` has ``.gd`` and ``.cp``, and no ``.admm`` / ``.fista`` /
``.tgv`` yet (ROADMAP.md queue A).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.config import TVConfig
from ..solvers.cp import chambolle_pock
from ..solvers.gd import subgradient_descent


def add_noise(img, noise_level: float = 100.0, seed: int = 0) -> np.ndarray:
    """The README's noise recipe (``README.md:112-115``):
    ``img + noise_level * U[0,1)`` with ``np.random.seed(seed)``, as float64
    numpy (the same numbers as the JAX package's ``add_noise``)."""
    np.random.seed(seed)
    img = np.asarray(img, dtype=np.float64)
    return img + noise_level * np.random.rand(*img.shape)


def _to_volume(image):
    image = torch.as_tensor(image)
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
    tensor (or numpy array) and returns the same rank; the solve runs on
    the tensor's device.
    """

    reg: float = 25.0
    cfg: TVConfig = TVConfig()

    def gd(self, noisy, n_iter: int = 300, step_size: float = 5e-3, **kw):
        x, ndim = _to_volume(noisy)
        res = subgradient_descent(x, n_iter=n_iter, reg=self.reg,
                                  step_size=step_size, cfg=self.cfg, **kw)
        return res._replace(x=_from_volume(res.x, ndim))

    def cp(self, noisy, n_iter: int = 300, **kw):
        x, ndim = _to_volume(noisy)
        res = chambolle_pock(x, n_iter=n_iter, reg=self.reg, cfg=self.cfg, **kw)
        return res._replace(x=_from_volume(res.x, ndim))


def denoise_tv_chambolle(
    image,
    weight: float = 0.1,
    eps: float = None,
    max_num_iter: int = 200,
    scheme: str = "hybrid",
    channel_axis: int = None,
    coupled_channels: bool = False,
):
    """scikit-image-compatible TV denoising: minimizes ``1/2 ||x - x0||^2 +
    weight * TV(x)`` with ``max_num_iter`` Chambolle-Pock iterations and
    returns a numpy array of the input rank.

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

    def solve(vol, cfg):
        return chambolle_pock(torch.as_tensor(vol), n_iter=max_num_iter,
                              reg=weight, cfg=cfg)

    if channel_axis is None:
        vol, ndim = _to_volume(image)
        res = solve(vol, TVConfig(scheme=scheme))
        return _from_volume(res.x, ndim).cpu().numpy()

    img = np.asarray(image)
    ch_first = np.moveaxis(img, channel_axis, 0)
    if ch_first.ndim == 3:       # 2D multichannel: channels -> decoupled z
        vol = np.ascontiguousarray(ch_first[:, None])  # (C, 1, H, W)
        res = solve(vol, TVConfig(scheme=scheme, reg_z_over_reg=0.0))
        out = res.x.cpu().numpy()[:, 0]
    elif ch_first.ndim == 4:     # 3D z-stack multichannel: channels -> t
        vol = np.ascontiguousarray(np.moveaxis(ch_first, 0, 1))
        res = solve(vol, TVConfig(scheme=scheme))
        out = np.moveaxis(res.x.cpu().numpy(), 1, 0)
    else:
        raise ValueError(
            f"channel_axis given but image has rank {img.ndim}; expected 3 "
            f"(2D multichannel) or 4 (3D z-stack multichannel)"
        )
    return np.moveaxis(out, 0, channel_axis)
