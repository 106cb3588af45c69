"""Image-quality metrics (MSE, NRMSE, PSNR, SSIM), computed on the inputs'
device.  The port of ``pytv4d_tpu/utils/metrics.py``.

scikit-image-compatible semantics (``skimage.metrics``: mean_squared_error,
normalized_root_mse, peak_signal_noise_ratio, structural_similarity with its
default uniform 7x7 window, sample covariance and edge crop), without a
scikit-image dependency.  The reductions run where the data is; only the
final scalar comes to the host.

For float images ``data_range=None`` infers ``truth.max() - truth.min()``
instead of scikit-image's legacy "assume the full dtype range", as the JAX
package does.  Pass ``data_range`` explicitly for strict parity.

Where they compute (``utils.device``): a tensor on its own device; a numpy
array on the CUDA device unless ``device=`` names another.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from .device import on_device

__all__ = ["mse", "nrmse", "psnr", "ssim"]


def _as_float_pair(a, b, device):
    a = on_device(a, device)
    b = on_device(b, device)
    if a.shape != b.shape:
        raise ValueError(f"shape mismatch: {tuple(a.shape)} vs "
                         f"{tuple(b.shape)}")
    dt = torch.promote_types(torch.promote_types(a.dtype, b.dtype),
                             torch.float32)
    return a.to(dt), b.to(dt)


def _infer_data_range(truth, data_range, device):
    if data_range is not None:
        return float(data_range)
    t = on_device(truth, device)
    if not (t.dtype.is_floating_point or t.dtype.is_complex):
        info = torch.iinfo(t.dtype)
        return float(info.max) - float(info.min)
    rng = float(t.max() - t.min())
    if rng == 0.0:
        raise ValueError(
            "data_range cannot be inferred from a constant float image; "
            "pass data_range explicitly")
    return rng


def mse(image_true, image_test, device=None) -> float:
    """Mean squared error (skimage ``mean_squared_error``)."""
    a, b = _as_float_pair(image_true, image_test, device)
    return float(torch.mean((a - b) ** 2))


def nrmse(image_true, image_test, normalization: str = "euclidean",
          device=None) -> float:
    """Normalized root MSE (skimage ``normalized_root_mse`` conventions:
    'euclidean' divides by sqrt(mean(truth^2)), 'min-max' by the truth
    range, 'mean' by the truth mean)."""
    a, b = _as_float_pair(image_true, image_test, device)
    rmse = torch.sqrt(torch.mean((a - b) ** 2))
    if normalization == "euclidean":
        denom = torch.sqrt(torch.mean(a ** 2))
    elif normalization == "min-max":
        denom = a.max() - a.min()
    elif normalization == "mean":
        denom = torch.mean(a)
    else:
        raise ValueError(f"unknown normalization {normalization!r}")
    return float(rmse / denom)


def psnr(image_true, image_test, data_range=None, device=None) -> float:
    """Peak signal-to-noise ratio in dB (skimage
    ``peak_signal_noise_ratio``; see the module docstring for the float
    ``data_range`` inference).  Returns ``inf`` for identical images."""
    dr = _infer_data_range(image_true, data_range, device)
    a, b = _as_float_pair(image_true, image_test, device)
    err = torch.mean((a - b) ** 2)
    return float(10.0 * torch.log10((dr * dr) / err))


def _ssim_map_2d(x, y, data_range, win_size, k1, k2):
    """Per-slice SSIM maps.  x, y: (B, Nr, Nc) float; returns
    (B, Nr-win+1, Nc-win+1), the 'valid' region, which equals
    scikit-image's uniform_filter output after its (win_size-1)//2 crop."""
    def box(a):
        # valid-mode box mean over the trailing two axes
        return F.avg_pool2d(a[:, None], win_size, stride=1)[:, 0]

    ux, uy = box(x), box(y)
    uxx, uyy, uxy = box(x * x), box(y * y), box(x * y)
    np_ = win_size * win_size
    cov_norm = np_ / (np_ - 1.0)  # sample covariance, as scikit-image
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    c1 = (k1 * data_range) ** 2
    c2 = (k2 * data_range) ** 2
    return ((2.0 * ux * uy + c1) * (2.0 * vxy + c2)) / (
        (ux * ux + uy * uy + c1) * (vx + vy + c2))


def ssim(image_true, image_test, data_range=None, win_size: int = 7,
         k1: float = 0.01, k2: float = 0.03, return_map: bool = False,
         device=None):
    """Structural similarity (skimage ``structural_similarity`` defaults:
    uniform ``win_size`` x ``win_size`` window, sample covariance,
    ``(win_size-1)//2`` edge crop before the mean).

    Accepts a 2D image or any array whose trailing two axes are (row, col),
    e.g. the canonical ``(Nz, M, N_row, N_col)`` volume: SSIM is computed
    per 2D slice and averaged.  ``return_map=True`` returns the per-pixel
    SSIM map(s) over the valid region (a tensor) instead of the mean."""
    if win_size % 2 != 1 or win_size < 3:
        raise ValueError("win_size must be an odd integer >= 3")
    dr = _infer_data_range(image_true, data_range, device)
    a, b = _as_float_pair(image_true, image_test, device)
    if a.ndim < 2 or a.shape[-1] < win_size or a.shape[-2] < win_size:
        raise ValueError(
            f"trailing image axes {tuple(a.shape[-2:])} smaller than "
            f"win_size={win_size}")
    lead = tuple(a.shape[:-2])
    s = _ssim_map_2d(a.reshape((-1,) + tuple(a.shape[-2:])),
                     b.reshape((-1,) + tuple(b.shape[-2:])), dr, win_size,
                     k1, k2)
    if return_map:
        return s.reshape(lead + tuple(s.shape[-2:]))
    return float(torch.mean(s))
