"""The control of the bfloat16 CP cell: the reference's CP loop
(``reference/tv.py::cp_denoise``, written out again here) in float32 on the
cell's bfloat16 input, with x and the two duals rounded through
``torch.float8_e4m3fn`` after each iteration: the precision below the
cell's stated bfloat16, which its limits must refuse.  A limits file
selects it by ``{"entry": "denoise_fp8_control"}``; ``reference()`` is the
denoising entry's float64 solve."""

from __future__ import annotations

import torch

from ..reference import tv as ref_tv
from . import denoise

FORMAT = torch.float8_e4m3fn


def _round(t):
    return t.copy_(t.to(FORMAT))


def cp_denoise_rounded(x0, *, n_iter: int, reg: float, grad, sigma_D: float,
                       sigma_A: float, block: int = 8):
    """``reference.tv.cp_denoise`` with x, y_A and y_D rounded through
    :data:`FORMAT` at the end of each iteration, in ``x0``'s dtype."""
    Nz, rest = x0.shape[0], tuple(x0.shape[1:])
    tau = 1.0 / (grad.bound_sq + sigma_A)
    x = x0.clone()
    y_A = torch.zeros_like(x0)
    y_D = x0.new_zeros((Nz, grad.Nd) + rest)
    buf = ref_tv._Buffers(x0)
    losses = torch.zeros(n_iter, dtype=torch.float64, device=x0.device)
    for i in range(n_iter):
        tv = x0.new_zeros((), dtype=torch.float64)
        for z0, z1 in ref_tv._blocks(Nz, block):
            lo, hi, a, b = ref_tv._slab(Nz, z0, z1, 1)
            Dx = grad.apply(x[lo:hi], buf((hi - lo, grad.Nd) + rest))[a:b]
            tv += torch.sum(ref_tv._l21(Dx), dtype=torch.float64)
            y_A[z0:z1].add_(x[z0:z1] - x0[z0:z1], alpha=sigma_A) \
                .div_(1.0 + sigma_A)
            p = torch.add(y_D[z0:z1], Dx, alpha=sigma_D, out=Dx)
            scale = torch.linalg.vector_norm(p, dim=1, keepdim=True) \
                .div_(reg).clamp_min_(1.0)
            torch.div(p, scale, out=y_D[z0:z1])
        fid = x0.new_zeros((), dtype=torch.float64)
        for z0, z1 in ref_tv._blocks(Nz, block):
            lo, hi, a, b = ref_tv._slab(Nz, z0, z1, 1)
            DTy = grad.apply_T(y_D[lo:hi], buf((hi - lo,) + rest))[a:b]
            x[z0:z1].sub_(y_A[z0:z1], alpha=tau).sub_(DTy, alpha=tau)
            fid += 0.5 * torch.sum(torch.square(x[z0:z1] - x0[z0:z1]),
                                   dtype=torch.float64)
        losses[i] = fid + reg * tv
        for z0, z1 in ref_tv._blocks(Nz, block):
            for t in (x, y_A, y_D):
                _round(t[z0:z1])
    return x, losses


class Runner(denoise.Runner):
    def solve(self):
        cp = self.config["cp"]
        x, losses = cp_denoise_rounded(
            self.noisy.float(), n_iter=self.n_iter, reg=self.config["reg"],
            grad=self.grad, sigma_D=cp["sigma_D"], sigma_A=cp["sigma_A"])
        float(losses[-1])
        return x, losses


def prepare(config, traffic, seed, device):
    return Runner(config, traffic, seed, device)
