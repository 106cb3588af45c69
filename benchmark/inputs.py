"""The benchmark's inputs, made from ``--seed`` alone: piecewise-constant
phantoms of moving ellipsoids, the README's uniform noise, and a CT
sinogram projected by the reference's own pair with Gaussian noise.

The few shape parameters of a phantom come from ``numpy``'s generator; the
volume-sized draws are made on the device by a ``torch.Generator`` seeded
with the same seed, in a few large calls.  Every seed gives the same sizes:
only the values change."""

from __future__ import annotations

import numpy as np
import torch

SEED_MOD = 2 ** 63


def seed_of(seed: int) -> int:
    """Any whole number as a seed both generators take."""
    return int(seed) % SEED_MOD


def phantom(shape, seed: int, *, n_shapes: int, lo: float, hi: float,
            extent: float, device, dtype=torch.float32):
    """``(Nz, M, N, N)``: zero outside ``n_shapes`` ellipsoids in (z, row,
    col) whose centres drift from frame to frame; each holds a value drawn
    from ``[lo, hi)``, later ones over earlier ones.  Centres lie within
    ``extent`` of the in-plane middle (a fraction of ``N / 2``)."""
    Nz, M, N, _ = shape
    rng = np.random.default_rng(seed_of(seed))
    vol = torch.zeros(shape, dtype=dtype, device=device)
    z = torch.arange(Nz, dtype=torch.float32, device=device)
    t = torch.arange(M, dtype=torch.float32, device=device)
    i = torch.arange(N, dtype=torch.float32, device=device)
    for _ in range(n_shapes):
        cz = rng.uniform(0.2, 0.8) * Nz
        az = rng.uniform(0.15, 0.6) * max(Nz, 1)
        cr, cc = (N / 2 + rng.uniform(-0.5, 0.5, 2) * extent * N / 2)
        ar, ac = rng.uniform(0.04, 0.3, 2) * N * extent
        vr, vc = rng.uniform(-0.01, 0.01, 2) * N
        val = float(rng.uniform(lo, hi))
        rz = ((z - cz) / az) ** 2                                  # (Nz,)
        rr = ((i[None, :] - cr - vr * t[:, None]) / ar) ** 2       # (M, N)
        rc = ((i[None, :] - cc - vc * t[:, None]) / ac) ** 2       # (M, N)
        inside = (rz[:, None, None, None] + rr[None, :, :, None]
                  + rc[None, :, None, :]) <= 1.0
        vol.masked_fill_(inside, val)
        del inside
    return vol


def generator(seed: int, device):
    return torch.Generator(device=device).manual_seed(seed_of(seed))


def noisy_volume(shape, seed: int, cfg: dict, device, dtype=torch.float32):
    """The denoising input: the phantom (values in ``cfg['phantom']``) plus
    ``noise_level * U[0, 1)`` (``README.md:112-115``)."""
    ph = cfg["phantom"]
    vol = phantom(shape, seed, n_shapes=ph["n_shapes"], lo=ph["lo"],
                  hi=ph["hi"], extent=ph["extent"], device=device,
                  dtype=dtype)
    noise = torch.rand(shape, generator=generator(seed, device),
                       dtype=dtype, device=device)
    vol.add_(noise, alpha=float(cfg["noise_level"]))
    return vol


def sinogram(pair, shape, seed: int, cfg: dict, device):
    """The CT input: the phantom projected by the reference pair in float64,
    plus Gaussian noise of ``noise_frac`` times the largest line integral,
    returned as float32."""
    ph = cfg["phantom"]
    vol = phantom(shape, seed, n_shapes=ph["n_shapes"], lo=ph["lo"],
                  hi=ph["hi"], extent=ph["extent"], device=device,
                  dtype=torch.float64)
    sino = pair.A(vol)
    del vol
    noise = torch.randn(sino.shape, generator=generator(seed, device),
                        dtype=torch.float64, device=device)
    sino += noise * (float(cfg["noise_frac"]) * float(torch.max(sino)))
    return sino.to(torch.float32)
