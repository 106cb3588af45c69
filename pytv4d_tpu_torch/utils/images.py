"""Test images — reference parity for ``pytv.utils.cameraman``
(``pytv/utils.py:46-55``: 256x256 int64 grayscale, value range 7-253).

The cameraman asset is read in place from the JAX package's vendored copy,
``pytv4d_tpu/media/cameraman.npy`` (found by path, so nothing of that
package is imported); ``$PYTV4D_CAMERAMAN`` takes precedence when set.  A
deterministic synthetic phantom stands in where neither exists (flagged by
:func:`has_real_cameraman`).  The images are numpy arrays: callers move
them to a device with ``torch.as_tensor(..., device=...)``.
"""

from __future__ import annotations

import os

import numpy as np

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_VENDORED = os.path.join(_REPO, "pytv4d_tpu", "media", "cameraman.npy")


def _find_asset():
    for path in (os.environ.get("PYTV4D_CAMERAMAN", ""), _VENDORED):
        if path and os.path.isfile(path):
            return path
    return None


def has_real_cameraman() -> bool:
    """True when the actual cameraman asset is available."""
    return _find_asset() is not None


def cameraman() -> np.ndarray:
    """The 256x256 grayscale cameraman standard image (``pytv/utils.py:46-55``),
    or a deterministic synthetic stand-in when the asset is unavailable."""
    path = _find_asset()
    if path is not None:
        return np.load(path)
    return synthetic_phantom(256)


def synthetic_phantom(n: int = 256, seed: int = 0) -> np.ndarray:
    """Deterministic piecewise-smooth int64 test image in [7, 253]: flat
    regions and sharp edges, like the real cameraman (the same image as the
    JAX package's ``synthetic_phantom``)."""
    yy, xx = np.mgrid[0:n, 0:n].astype(np.float64) / n - 0.5
    img = 120.0 + 80.0 * xx + 40.0 * yy
    ellipses = [
        # (cy, cx, ry, rx, angle, value)
        (0.0, 0.0, 0.42, 0.36, 0.0, 60.0),
        (-0.1, 0.05, 0.25, 0.18, 0.4, -45.0),
        (0.15, -0.12, 0.12, 0.2, -0.3, 70.0),
        (0.22, 0.18, 0.08, 0.06, 0.0, -80.0),
        (-0.25, -0.2, 0.05, 0.09, 0.8, 50.0),
    ]
    for cy, cx, ry, rx, ang, val in ellipses:
        c, s = np.cos(ang), np.sin(ang)
        u = (xx - cx) * c + (yy - cy) * s
        v = -(xx - cx) * s + (yy - cy) * c
        img = np.where((u / rx) ** 2 + (v / ry) ** 2 <= 1.0, img + val, img)
    rng = np.random.default_rng(seed)
    img = img + rng.normal(0.0, 2.0, size=(n, n))
    return np.clip(img, 7, 253).astype(np.int64)


def as_volume(img2d: np.ndarray, Nz: int = 1, M: int = 1) -> np.ndarray:
    """Tile a 2D image into the canonical ``(Nz, M, N_row, N_col)`` layout."""
    return np.broadcast_to(img2d, (Nz, M) + img2d.shape).copy()
