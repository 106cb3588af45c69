"""The benchmark's plain reference for parallel-beam CT: the Fourier-slice
projector pair evaluated by explicit (non-uniform) DFT matrices in complex
arithmetic, and the Chambolle-Pock solve on ``K = [A; D]`` with a TV prior.

The projector (the "spectral" parallel-beam model): a slice is a sum of
point masses at pixel centres ``x = i - c0``, ``c0 = (N - 1) / 2``.  For an
angle ``t`` with ``|sin t| >= |cos t|`` the slice's spectrum is taken on
the padded grid ``Np = 2 N`` along columns and evaluated along rows at the
slice frequencies, then synthesised at detector cells ``s_j = j - (S-1)/2``:

    F[r, k]  = sum_c v[r, c] exp(-2 pi i c k / Np),        k = 0 .. N
    G[t, k]  = sum_r F[r, k] exp(+2 pi i k cot(t) x_r / Np)
    p[t, j]  = Re sum_k G[t, k] w_k / (Np |sin t|)
                 * exp(i (-2 pi k s_j / (Np sin t) + 2 pi k c0 / Np))

with ``w_0 = w_N = 1`` and 2 elsewhere (the half spectrum of a real
slice).  Angles with ``|sin t| < |cos t|`` swap rows and columns, with
``tan t`` for ``cot t`` and ``+2 pi k s_j / (Np cos t)`` for the detector
phase.  The adjoint is the conjugate transpose of each factor.  All of it
runs in complex128 from float64 phases.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .tv import Gradient, _l21


class ParallelBeam:
    """``A`` (``(Nz, M, N, N) -> (Nz, M, n_angles, n_det)``) and its exact
    transpose ``A_T``, in float64, on ``device``."""

    def __init__(self, N: int, angles, n_det: int, device):
        ang = np.asarray(angles, dtype=np.float64)
        self.N, self.n_det, self.n_angles = N, n_det, ang.size
        Np, c0 = 2 * N, (N - 1) / 2.0
        f64 = dict(dtype=torch.float64, device=device)
        k = torch.arange(N + 1, **f64)
        idx = torch.arange(N, **f64)
        w = torch.full_like(k, 2.0)
        w[0] = w[-1] = 1.0
        s = torch.arange(n_det, **f64) - (n_det - 1) / 2.0
        x = idx - c0
        # the DFT on the grid: (N, K)
        self.W = torch.polar(torch.ones(N, N + 1, **f64),
                             -2.0 * math.pi * idx[:, None] * k[None, :] / Np)
        vert = np.abs(np.sin(ang)) >= np.abs(np.cos(ang))
        self.parts = []
        for is_vert in (True, False):
            sel = np.nonzero(vert == is_vert)[0]
            if not sel.size:
                continue
            th = torch.as_tensor(ang[sel], **f64)
            if is_vert:
                slope, den, sign = torch.cos(th) / torch.sin(th), \
                    torch.sin(th), -1.0
            else:
                slope, den, sign = torch.sin(th) / torch.cos(th), \
                    torch.cos(th), 1.0
            # P[t, n, k]: the non-uniform DFT along the other axis
            P = torch.polar(
                torch.ones(sel.size, N, N + 1, **f64),
                2.0 * math.pi / Np * slope[:, None, None] * x[None, :, None]
                * k[None, None, :])
            # E[t, k, j]: the detector synthesis
            mag = (w[None, :] / (Np * torch.abs(den))[:, None])[:, :, None]
            E = torch.polar(
                mag.expand(sel.size, N + 1, n_det).contiguous(),
                sign * 2.0 * math.pi / Np * (k[None, :, None]
                                             / den[:, None, None])
                * s[None, None, :]
                + 2.0 * math.pi * c0 / Np * k[None, :, None])
            self.parts.append((is_vert, torch.as_tensor(sel, device=device),
                               P, E))

    def A(self, vol):
        lead = vol.shape[:-2]
        v = vol.reshape(-1, self.N, self.N).to(torch.complex128)
        out = torch.empty((v.shape[0], self.n_angles, self.n_det),
                          dtype=torch.float64, device=vol.device)
        for is_vert, sel, P, E in self.parts:
            # F[b, n, k]: n the axis the NUDFT runs over
            F = v @ self.W if is_vert else (v.transpose(1, 2) @ self.W)
            G = torch.einsum("bnk,tnk->btk", F, P)
            out[:, sel] = torch.einsum("btk,tkj->btj", G, E).real
        return out.reshape(tuple(lead) + (self.n_angles, self.n_det))

    def A_T(self, sino):
        lead = sino.shape[:-2]
        y = sino.reshape(-1, self.n_angles, self.n_det).to(torch.complex128)
        vol = torch.zeros((y.shape[0], self.N, self.N), dtype=torch.float64,
                          device=sino.device)
        for is_vert, sel, P, E in self.parts:
            G = torch.einsum("btj,tkj->btk", y[:, sel], E.conj())
            F = torch.einsum("btk,tnk->bnk", G, P.conj())
            part = (F @ self.W.conj().T).real
            vol += part if is_vert else part.transpose(1, 2)
        return vol.reshape(tuple(lead) + (self.N, self.N))


def power_norm(pair: ParallelBeam, vol_shape, n_iter: int = 12, seed: int = 0):
    """``||A||_2`` by ``n_iter`` steps of the power method on ``A^T A`` from
    a standard normal start drawn with ``seed`` on the pair's device."""
    dev = pair.W.device
    g = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn(vol_shape, generator=g, dtype=torch.float64, device=dev)
    x /= torch.linalg.vector_norm(x)
    n = None
    for _ in range(n_iter):
        y = pair.A_T(pair.A(x))
        n = torch.linalg.vector_norm(y)
        x = y / n
    return float(torch.sqrt(n))


def cp_inverse(pair: ParallelBeam, b, vol_shape, *, n_iter: int, reg: float,
               grad: Gradient, op_norm: float, nonneg: bool):
    """Chambolle-Pock on ``1/2 ||A x - b||^2 + reg TV(x)`` (over ``x >= 0``
    when ``nonneg``) from ``x = 0`` and zero duals, with
    ``sigma = tau = 1 / sqrt(op_norm^2 + ||D||^2)`` and over-relaxation:

        y_A <- (y_A + s (A x_bar - b)) / (1 + s)
        y_D <- p / max(1, |p| / reg),  p = y_D + s D x_bar
        x'  <- x - s (A^T y_A + D^T y_D)  (then max(x', 0))
        x_bar <- 2 x' - x
        loss = 1/2 ||A x' - b||^2 + reg * TV(x')

    in float64.  Returns ``(x, losses)``."""
    s = 1.0 / math.sqrt(op_norm ** 2 + grad.bound_sq)
    b = b.to(torch.float64)
    x = torch.zeros(vol_shape, dtype=torch.float64, device=b.device)
    x_bar = x.clone()
    y_A = torch.zeros_like(b)
    y_D = x.new_zeros((vol_shape[0], grad.Nd) + tuple(vol_shape[1:]))
    losses = torch.zeros(n_iter, dtype=torch.float64, device=b.device)
    Ax_bar = pair.A(x_bar)
    for i in range(n_iter):
        y_A = (y_A + s * (Ax_bar - b)) / (1.0 + s)
        p = y_D + s * grad.apply(x_bar)
        y_D = p / torch.clamp_min(_l21(p)[:, None] / reg, 1.0)
        x_new = x - s * (pair.A_T(y_A) + grad.apply_T(y_D))
        if nonneg:
            x_new = torch.clamp_min(x_new, 0.0)
        x_bar = 2.0 * x_new - x
        Ax_new = pair.A(x_new)
        Ax_bar = pair.A(x_bar)
        x = x_new
        losses[i] = 0.5 * torch.sum(torch.square(Ax_new - b)) \
            + reg * torch.sum(_l21(grad.apply(x)))
    return x, losses
