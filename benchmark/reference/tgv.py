"""Plain TGV-2 denoising of a 4D volume, the benchmark's reference, written
from Bredies, Kunisch & Pock, "Total Generalized Variation", SIAM J. Imaging
Sci. 3(3):492-526 (2010), and Chambolle & Pock's primal-dual iteration
(J. Math. Imaging Vis. 40:120-145, 2011, Algorithm 1), and from nothing of
the program:

    min_{x, w}  1/2 ||x - x0||^2 + a1 ||D x - w||_1 + a0 ||E w||_1

on ``(Nz, M, N_row, N_col)`` volumes with all four axes (z, t, row, col)
coupled: ``w`` and the dual ``p`` are ``(Nz, 4, M, N_row, N_col)``, the dual
``q`` of ``E w`` is ``(Nz, 10, M, N_row, N_col)``.  One iteration from
``x = x_bar = x0`` and zero ``w``, ``w_bar``, ``p``, ``q``:

    p <- P_a1(p + sigma (D x_bar - w_bar))
    q <- P_a0(q + sigma E w_bar)
    x' = (x - tau D^T p + tau x0) / (1 + tau),   x_bar = 2 x' - x
    w' = w + tau (p - E^T q),                    w_bar = 2 w' - w
    loss = 1/2 ||x' - x0||^2 + a1 N(D x' - w') + a0 N(E w')

Where this departs from the paper, it follows the definitions the
benchmark's configuration states:

- ``D`` is the forward difference along each axis with the difference at an
  axis's last slot zero; ``E`` is the symmetrised backward difference of
  ``w``, ``E_ii = b_i w_i`` and ``E_ij = (b_j w_i + b_i w_j) / 2``, with the
  difference at an axis's first slot zero.  The paper's discretisation, with
  these boundary rules made explicit.
- ``E w`` is held as its 10 distinct entries, diagonals first, then
  ``(i, j)`` with ``i < j``, and its pointwise norm is the 2-norm of those
  entries: an off-diagonal entry counts once, where the paper's Frobenius
  norm of the symmetric matrix counts it twice.  ``q``'s projection is onto
  the ball of the same norm.
- ``norm`` picks the pointwise norm of both terms: ``'iso'`` the 2-norm (the
  paper's), ``'aniso'`` the 1-norm of the entries (the projection a clip),
  ``'huber'`` Huber's function of the 2-norm with threshold ``delta`` (the
  dual prox shrinks by ``1 + sigma delta / a`` before the projection).
- ``sigma = s / L`` and ``tau = 1 / (s L)`` with ``L^2 = 32``, the bound
  ``max(2 ||D||^2, 2 + ||E||^2) = max(2 * 16, 2 + 10)`` on ``||K||^2`` for
  ``K = [[D, -I], [0, E]]`` with four coupled axes, not its exact norm.

The state is kept whole and each pass is computed in blocks of z-planes
with a halo of one, so the (96, 16, 512, 512) volume fits one card in
float32 beside its state; the objective takes its channels one at a time.
"""

from __future__ import annotations

import math

import torch

AXES = (0, 1, 2, 3)                 # z, t, row, col of an x-like volume
PAIRS = [(i, i) for i in range(4)] + [(i, j) for i in range(4)
                                      for j in range(i + 1, 4)]
NORM_BOUND_SQ = 32.0


def steps(split: float = 1.0):
    """``(sigma, tau)``."""
    L = math.sqrt(NORM_BOUND_SQ)
    return split / L, 1.0 / (split * L)


def fwd(v, axis):
    """``d[i] = v[i+1] - v[i]`` at slots ``0 .. L-2``, zero at ``L-1``."""
    L = v.shape[axis]
    out = torch.zeros_like(v)
    torch.sub(v.narrow(axis, 1, L - 1), v.narrow(axis, 0, L - 1),
              out=out.narrow(axis, 0, L - 1))
    return out


def fwd_T(d, axis):
    """The adjoint of :func:`fwd`: ``d[i-1] - d[i]``, each term where its
    slot is one :func:`fwd` writes."""
    L = d.shape[axis]
    out = torch.zeros_like(d)
    out.narrow(axis, 0, L - 1).sub_(d.narrow(axis, 0, L - 1))
    out.narrow(axis, 1, L - 1).add_(d.narrow(axis, 0, L - 1))
    return out


def bwd(v, axis):
    """``d[i] = v[i] - v[i-1]`` at slots ``1 .. L-1``, zero at ``0``."""
    L = v.shape[axis]
    out = torch.zeros_like(v)
    torch.sub(v.narrow(axis, 1, L - 1), v.narrow(axis, 0, L - 1),
              out=out.narrow(axis, 1, L - 1))
    return out


def bwd_T(d, axis):
    """The adjoint of :func:`bwd`: ``d[i] - d[i+1]``, each term where its
    slot is one :func:`bwd` writes."""
    L = d.shape[axis]
    out = torch.zeros_like(d)
    out.narrow(axis, 1, L - 1).add_(d.narrow(axis, 1, L - 1))
    out.narrow(axis, 0, L - 1).sub_(d.narrow(axis, 1, L - 1))
    return out


def E_channel(w, c):
    """Channel ``c`` of ``E w`` (``PAIRS[c]``) of a w-like ``w``."""
    i, j = PAIRS[c]
    if i == j:
        return bwd(w[:, i], AXES[i])
    return 0.5 * (bwd(w[:, i], AXES[j]) + bwd(w[:, j], AXES[i]))


def D(x):
    return torch.stack([fwd(x, a) for a in AXES], dim=1)


def D_T(p):
    return sum(fwd_T(p[:, i], a) for i, a in enumerate(AXES))


def E(w):
    return torch.stack([E_channel(w, c) for c in range(len(PAIRS))], dim=1)


def E_T(q):
    """``E^T q``, a w-like volume: field ``i`` gathers ``b_i^T`` of its
    diagonal channel and half of ``b_j^T`` of each channel ``(i, j)``."""
    out = [torch.zeros_like(q[:, 0]) for _ in AXES]
    for c, (i, j) in enumerate(PAIRS):
        if i == j:
            out[i] += bwd_T(q[:, c], AXES[i])
        else:
            out[i] += 0.5 * bwd_T(q[:, c], AXES[j])
            out[j] += 0.5 * bwd_T(q[:, c], AXES[i])
    return torch.stack(out, dim=1)


def _prox(v, radius, norm, shrink):
    """The projection onto the dual ball of ``radius`` over the channels
    (axis 1), after Huber's shrink; in place."""
    if norm == "aniso":
        return v.clamp_(-radius, radius)
    if norm == "huber":
        v.mul_(shrink)
    n = torch.linalg.vector_norm(v, dim=1, keepdim=True)
    return v.div_(n.div_(radius).clamp_min_(1.0))


def _value(acc, norm, delta):
    """A group's pointwise norm summed over the voxels, from the sum of
    its channels' ``|.|`` (aniso) or squares (iso, huber), in float64."""
    if norm != "aniso":
        n = torch.sqrt(acc)
        acc = (torch.where(n <= delta, n * n / (2.0 * delta), n - delta / 2.0)
               if norm == "huber" else n)
    return torch.sum(acc, dtype=torch.float64)


def _blocks(Nz: int, block: int):
    """``(z0, z1, lo, hi, a, b)``: a block of planes, the slab ``lo:hi`` it
    reads with a halo of one, and the block's rows ``a:b`` in that slab."""
    for z0 in range(0, Nz, block):
        z1 = min(z0 + block, Nz)
        lo, hi = max(0, z0 - 1), min(Nz, z1 + 1)
        yield z0, z1, lo, hi, z0 - lo, z1 - lo


def objective(x, w, x0, alpha1, alpha0, norm="iso", delta=1.0,
              block: int = 8):
    """``1/2 ||x - x0||^2 + a1 N(D x - w) + a0 N(E w)`` as a float64 scalar,
    taking the channels one at a time."""
    term = torch.abs if norm == "aniso" else torch.square
    fid = n1 = n0 = 0.0
    for z0, z1, lo, hi, a, b in _blocks(x.shape[0], block):
        xs, ws = x[lo:hi], w[lo:hi]
        fid += 0.5 * float(torch.sum(torch.square(x[z0:z1] - x0[z0:z1]),
                                     dtype=torch.float64))
        acc = sum(term(fwd(xs, ax)[a:b] - w[z0:z1, i])
                  for i, ax in enumerate(AXES))
        n1 += float(_value(acc, norm, delta))
        acc = sum(term(E_channel(ws, c)[a:b]) for c in range(len(PAIRS)))
        n0 += float(_value(acc, norm, delta))
    return fid + alpha1 * n1 + alpha0 * n0


def tgv_denoise(x0, *, n_iter: int, alpha1: float, alpha0: float,
                norm: str = "iso", huber_delta: float = 1.0,
                sigma_tau_split: float = 1.0, dtype=None, block: int = 8):
    """The iteration of the module docstring, in ``dtype`` (``x0``'s by
    default).  Returns ``(x, w, losses)``, the losses float64, one an
    iteration."""
    if norm not in ("iso", "aniso", "huber"):
        raise ValueError(f"unknown norm {norm!r}")
    dtype = dtype or x0.dtype
    x0 = x0.to(dtype)
    Nz, rest = x0.shape[0], tuple(x0.shape[1:])
    n, nq = len(AXES), len(PAIRS)
    sigma, tau = steps(sigma_tau_split)
    shr1 = 1.0 / (1.0 + sigma * huber_delta / alpha1)
    shr0 = 1.0 / (1.0 + sigma * huber_delta / alpha0)
    x, xb = x0.clone(), x0.clone()
    w, wb, p = (x0.new_zeros((Nz, n) + rest) for _ in range(3))
    q = x0.new_zeros((Nz, nq) + rest)
    losses = torch.zeros(n_iter, dtype=torch.float64)
    for it in range(n_iter):
        # the duals: p and q at a voxel read only themselves there
        for z0, z1, lo, hi, a, b in _blocks(Nz, block):
            xbs, wbs = xb[lo:hi], wb[lo:hi]
            arg = torch.stack([fwd(xbs, ax)[a:b] for ax in AXES], dim=1)
            arg.sub_(wb[z0:z1]).mul_(sigma).add_(p[z0:z1])
            p[z0:z1] = _prox(arg, alpha1, norm, shr1)
            arg = torch.stack([E_channel(wbs, c)[a:b] for c in range(nq)],
                              dim=1)
            arg.mul_(sigma).add_(q[z0:z1])
            q[z0:z1] = _prox(arg, alpha0, norm, shr0)
        # the primal and its extrapolation from the new duals
        for z0, z1, lo, hi, a, b in _blocks(Nz, block):
            dtp = D_T(p[lo:hi])[a:b]
            x_new = (x[z0:z1] - tau * dtp + tau * x0[z0:z1]) / (1.0 + tau)
            torch.sub(2.0 * x_new, x[z0:z1], out=xb[z0:z1])
            x[z0:z1] = x_new
            w_new = w[z0:z1] - tau * (E_T(q[lo:hi])[a:b] - p[z0:z1])
            torch.sub(2.0 * w_new, w[z0:z1], out=wb[z0:z1])
            w[z0:z1] = w_new
        losses[it] = objective(x, w, x0, alpha1, alpha0, norm, huber_delta,
                               block)
    return x, w, losses
