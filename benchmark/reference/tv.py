"""Plain TV operators and the two denoising solvers of the benchmark's
reference, written from the reference library's definitions
(eboigne/PyTV-4D ``tv_operators_CPU.py`` and the README's GD and CP
recipes, ``README.md:107-158``) and from nothing of the program.

Volumes are ``(Nz, M, N_row, N_col)``.  A scheme is a list of channels, each
a one-dimensional difference along one axis: ``'f'`` (``d[i] = v[i+1] -
v[i]`` at slots ``0 .. L-2``), ``'b'`` (``v[i] - v[i-1]`` at ``1 .. L-1``) or
``'c'`` (``v[i+1] - v[i-1]`` at ``1 .. L-2``); every other slot is zero.
The z channels carry ``sqrt(reg_z_over_reg)``, the t channels
``sqrt(reg_time)``, and the whole gradient the scheme's normalisation.

The solvers keep their state whole and compute each iteration in blocks of
z-planes with a halo, so a (96, 16, 512, 512) volume in float64 fits one
card beside its state.
"""

from __future__ import annotations

import math

import torch

Z, T, ROW, COL = 0, 1, 2, 3


def channels(scheme: str, Nz: int, M: int, reg_z_over_reg: float = 1.0,
             reg_time: float = 0.0):
    """``([(axis, kind, weight), ...], normalisation)`` of a scheme."""
    z_on = Nz > 1 and reg_z_over_reg > 0
    t_on = M > 1 and reg_time > 0
    wz = math.sqrt(reg_z_over_reg) if z_on else 0.0
    wt = math.sqrt(reg_time) if t_on else 0.0
    if scheme in ("upwind", "downwind"):
        k = "f" if scheme == "upwind" else "b"
        ch = [(ROW, k, 1.0), (COL, k, 1.0)]
        ch += [(Z, k, wz)] if z_on else []
        ch += [(T, k, wt)] if t_on else []
        return ch, 1.0
    if scheme == "central":
        ch = [(ROW, "c", 1.0), (COL, "c", 1.0)]
        ch += [(Z, "f" if Nz == 2 else "c", wz)] if z_on else []
        ch += [(T, "f" if M == 2 else "c", wt)] if t_on else []
        return ch, 0.5
    if scheme == "hybrid":
        ch = [(ROW, "f", 1.0), (COL, "f", 1.0), (ROW, "b", 1.0),
              (COL, "b", 1.0)]
        ch += [(Z, "f", wz), (Z, "b", wz)] if z_on else []
        ch += [(T, "f", wt), (T, "b", wt)] if t_on else []
        return ch, 1.0 / math.sqrt(2.0)
    raise ValueError(f"unknown scheme {scheme!r}")


def norm_bound_sq(scheme, Nz, M, reg_z_over_reg=1.0, reg_time=0.0) -> float:
    """``||D||^2 <= norm^2 * sum_c 4 w_c^2`` (each two-tap difference has
    norm at most 2): the README's 8 for the hybrid scheme on one frame."""
    ch, nrm = channels(scheme, Nz, M, reg_z_over_reg, reg_time)
    return nrm * nrm * sum(4.0 * w * w for _, _, w in ch)


def _parts(L: int, kind: str):
    """``(n, slot, hi, lo)``: a channel's ``n`` differences
    ``v[hi + i] - v[lo + i]`` land in slots ``slot .. slot + n - 1``."""
    if kind == "c":
        return L - 2, 1, 2, 0
    return L - 1, 0 if kind == "f" else 1, 1, 0


def diff_into(out, v, axis: int, kind: str):
    """``out <- diff(v)``: one unweighted difference channel of ``v``, zero
    outside its slots (``out`` shaped like ``v``)."""
    L = v.shape[axis]
    n, slot, hi, lo = _parts(L, kind)
    torch.sub(v.narrow(axis, hi, n), v.narrow(axis, lo, n),
              out=out.narrow(axis, slot, n))
    out.narrow(axis, 0, slot).zero_()
    out.narrow(axis, slot + n, L - slot - n).zero_()
    return out


def diff_T_add(acc, y, axis: int, kind: str, scale: float = 1.0):
    """``acc += scale * diff^T(y)``: reads the channel's slots only."""
    n, slot, hi, lo = _parts(y.shape[axis], kind)
    t = y.narrow(axis, slot, n)
    acc.narrow(axis, hi, n).add_(t, alpha=scale)
    acc.narrow(axis, lo, n).sub_(t, alpha=scale)
    return acc


class Gradient:
    """``D`` and ``D^T`` of one scheme instance on a volume of ``Nz``
    z-planes and ``M`` frames.  ``apply`` gives ``(Nz', Nd, M, Nr, Nc)``; on
    a slab of planes its first and last planes are right only where they
    are the volume's own, and likewise ``apply_T``'s."""

    def __init__(self, scheme, Nz, M, reg_z_over_reg=1.0, reg_time=0.0):
        self.chans, self.norm = channels(scheme, Nz, M, reg_z_over_reg,
                                         reg_time)
        self.Nd = len(self.chans)
        self.bound_sq = norm_bound_sq(scheme, Nz, M, reg_z_over_reg,
                                      reg_time)

    def apply(self, v, out=None):
        if out is None:
            out = v.new_empty(v.shape[:1] + (self.Nd,) + v.shape[1:])
        scaled = {}
        for c, (a, k, w) in enumerate(self.chans):
            s = w * self.norm
            if s not in scaled:
                scaled[s] = v * s
            diff_into(out[:, c], scaled[s], a, k)
        return out

    def apply_T(self, y, out=None, weighted: bool = True):
        """``D^T y``; with ``weighted`` false ``norm * sum_c diff^T(y_c)``,
        the scatter the reference's subgradient takes (``tv_CPU.py``: the
        channel weights are not applied again, the normalisation is)."""
        shape = y.shape[:1] + y.shape[2:]
        acc = y.new_zeros(shape) if out is None else out.zero_()
        for c, (a, k, w) in enumerate(self.chans):
            diff_T_add(acc, y[:, c], a, k,
                       (w if weighted else 1.0) * self.norm)
        return acc


def _blocks(Nz: int, block: int):
    for z0 in range(0, Nz, block):
        yield z0, min(z0 + block, Nz)


def _slab(Nz, z0, z1, halo):
    """``(lo, hi, a, b)``: the planes ``lo:hi`` a block reads with its halo,
    and the block's rows ``a:b`` inside that slab."""
    lo, hi = max(0, z0 - halo), min(Nz, z1 + halo)
    return lo, hi, z0 - lo, z0 - lo + (z1 - z0)


def _l21(Dv):
    return torch.linalg.vector_norm(Dv, dim=1)


class _Buffers:
    """Scratch volumes by shape, reused across blocks and iterations."""

    def __init__(self, like):
        self.like, self.bufs = like, {}

    def __call__(self, shape):
        shape = tuple(shape)
        if shape not in self.bufs:
            self.bufs[shape] = self.like.new_empty(shape)
        return self.bufs[shape]


def cp_denoise(x0, *, n_iter: int, reg: float, grad: Gradient,
               sigma_D: float = 0.5, sigma_A: float = 1.0, block: int = 8):
    """The README's Chambolle-Pock loop on ``1/2 ||x - x0||^2 + reg TV(x)``
    from ``x = x0`` and zero duals, with ``tau = 1 / (||D||^2 + sigma_A)``:

        y_A <- (y_A + sigma_A (x - x0)) / (1 + sigma_A)
        y_D <- p / max(1, |p| / reg),  p = y_D + sigma_D D x
        x   <- x - tau y_A - tau D^T y_D
        loss = 1/2 ||x' - x0||^2 + reg * TV(x)   (TV of the iterate before)

    in ``x0``'s dtype.  Returns ``(x, losses)``."""
    Nz, rest = x0.shape[0], tuple(x0.shape[1:])
    tau = 1.0 / (grad.bound_sq + sigma_A)
    x = x0.clone()
    y_A = torch.zeros_like(x0)
    y_D = x0.new_zeros((Nz, grad.Nd) + rest)
    buf = _Buffers(x0)
    losses = torch.zeros(n_iter, dtype=torch.float64, device=x0.device)
    for i in range(n_iter):
        tv = x0.new_zeros((), dtype=torch.float64)
        for z0, z1 in _blocks(Nz, block):
            lo, hi, a, b = _slab(Nz, z0, z1, 1)
            Dx = grad.apply(x[lo:hi], buf((hi - lo, grad.Nd) + rest))[a:b]
            tv += torch.sum(_l21(Dx), dtype=torch.float64)
            y_A[z0:z1].add_(x[z0:z1] - x0[z0:z1], alpha=sigma_A) \
                .div_(1.0 + sigma_A)
            p = torch.add(y_D[z0:z1], Dx, alpha=sigma_D, out=Dx)
            scale = torch.linalg.vector_norm(p, dim=1, keepdim=True) \
                .div_(reg).clamp_min_(1.0)
            torch.div(p, scale, out=y_D[z0:z1])
        fid = x0.new_zeros((), dtype=torch.float64)
        for z0, z1 in _blocks(Nz, block):
            lo, hi, a, b = _slab(Nz, z0, z1, 1)
            DTy = grad.apply_T(y_D[lo:hi], buf((hi - lo,) + rest))[a:b]
            x[z0:z1].sub_(y_A[z0:z1], alpha=tau).sub_(DTy, alpha=tau)
            fid += 0.5 * torch.sum(torch.square(x[z0:z1] - x0[z0:z1]),
                                   dtype=torch.float64)
        losses[i] = fid + reg * tv
    return x, losses


def gd_denoise(x0, *, n_iter: int, reg: float, step: float, grad: Gradient,
               block: int = 8):
    """The README's subgradient-descent loop from ``x = x0``:

        G    = norm * sum_c diff^T(D x / |D x|)   (0 where |D x| = 0)
        x   <- x - step ((x - x0) + reg G)
        loss = 1/2 ||x' - x0||^2 + reg * TV(x)    (TV of the iterate before)

    in ``x0``'s dtype.  Returns ``(x, losses)``."""
    Nz, rest = x0.shape[0], tuple(x0.shape[1:])
    x = x0.clone()
    x_new = torch.empty_like(x0)
    buf = _Buffers(x0)
    losses = torch.zeros(n_iter, dtype=torch.float64, device=x0.device)
    for i in range(n_iter):
        tv = x0.new_zeros((), dtype=torch.float64)
        fid = x0.new_zeros((), dtype=torch.float64)
        for z0, z1 in _blocks(Nz, block):
            lo, hi, a, b = _slab(Nz, z0, z1, 2)
            Dx = grad.apply(x[lo:hi], buf((hi - lo, grad.Nd) + rest))
            nrm = _l21(Dx)
            tv += torch.sum(nrm[a:b], dtype=torch.float64)
            Dx.div_(nrm.masked_fill_(nrm == 0, torch.inf).unsqueeze(1))
            G = grad.apply_T(Dx, buf((hi - lo,) + rest), weighted=False)[a:b]
            t = torch.sub(x[z0:z1], x0[z0:z1]).add_(G, alpha=reg)
            torch.add(x[z0:z1], t, alpha=-step, out=x_new[z0:z1])
            fid += 0.5 * torch.sum(torch.square(x_new[z0:z1] - x0[z0:z1]),
                                   dtype=torch.float64)
        losses[i] = fid + reg * tv
        x, x_new = x_new, x
    return x, losses
