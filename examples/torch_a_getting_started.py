"""Getting started with pytv4d_tpu_torch: the PyTorch/CUDA twin of
``examples/a_getting_started.py`` (the reference's
``examples/a_getting_started.ipynb`` flow).

Covers: TV values + subgradients, GD vs Chambolle-Pock vs ADMM denoising of
the cameraman image, and the operator forms.  Runs on the CUDA device
(``--device cpu`` for the CPU; no fallback):

    python examples/torch_a_getting_started.py [--device cpu]
"""

# Allow running from a repo checkout without installation.
import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse

import numpy as np
import torch

import pytv4d_tpu_torch as pytv
from pytv4d_tpu_torch.core.config import TVConfig
from pytv4d_tpu_torch.models import TVDenoiser, add_noise

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda)")
dev = torch.device(parser.parse_args().device)
if dev.type == "cuda" and not torch.cuda.is_available():
    raise RuntimeError("no CUDA device; pass --device cpu to run on the CPU")

# ---- TV of a random 4D volume (README.md:80-92) --------------------------
np.random.seed(0)
img = np.random.rand(20, 4, 100, 100).astype(np.float32)
x = torch.as_tensor(img, device=dev)
tv, G = pytv.tv_hybrid(x)
print(f"TV (hybrid) = {float(tv):.1f}; subgradient shape {tuple(G.shape)}")

# time-coupled 4D TV: opt-in via reg_time (tv_operators_CPU.py:113)
tv_t, _ = pytv.tv_hybrid(x, reg_time=1.0)
print(f"TV with time coupling = {float(tv_t):.1f}")

# ---- Denoising (README.md:107-158) ---------------------------------------
truth = pytv.utils.cameraman()
noisy = add_noise(truth.reshape((1, 1) + truth.shape), noise_level=100, seed=0)
noisy = noisy.astype(np.float32)

model = TVDenoiser(reg=25.0, cfg=TVConfig(scheme="hybrid"))

gd = model.gd(noisy[0, 0], n_iter=300, step_size=5e-3, device=dev)
print(f"subgradient descent: final loss {float(gd.loss[-1]):.1f}")

cp = model.cp(noisy[0, 0], n_iter=300, device=dev)
print(f"Chambolle-Pock:      final loss {float(cp.loss[-1]):.1f}  (converges lower)")

ad = model.admm(noisy[0, 0], n_iter=60, device=dev)
print(f"ADMM:                final loss {float(ad.loss[-1]):.1f}")

# ---- Operator forms for custom proximal solvers (README.md:200-222) ------
D_img = pytv.D_hybrid(x, reg_time=2 ** -5)
D_T_D = pytv.D_T_hybrid(D_img, reg_time=2 ** -5)
l21 = pytv.compute_L21_norm(D_img)
print(f"D: {tuple(D_img.shape)}  D_T D: {tuple(D_T_D.shape)}  "
      f"L21 = {float(l21):.1f}")

# ---- Differentiable TV for torch.optim-style optimizers ------------------
tv_fn = pytv.make_tv("hybrid", reg_time=0.5)
xg = x.clone().requires_grad_(True)
(grad,) = torch.autograd.grad(tv_fn(xg), xg)
print(f"torch.autograd of TV matches the subgradient convention; |grad| = "
      f"{float(grad.abs().sum()):.1f}")

# ---- Beyond the reference (docs/solvers.md is the full picker) ------------
# robust + certified: TV-L1 fidelity for impulsive noise, nonnegativity,
# and a duality-gap certificate instead of a loss-delta heuristic
cp_l1 = model.cp(noisy[0, 0], n_iter=100, fidelity="l1",
                 fidelity_weight=0.02, nonneg=True, device=dev)
from pytv4d_tpu_torch.solvers import pd_gap

# the state keeps the 4D layout
gap = float(pd_gap(cp.state, torch.as_tensor(noisy, device=dev), reg=25.0))
print(f"TV-L1 denoise loss {float(cp_l1.loss[-1]):.1f}; l2 solve duality "
      f"gap {gap:.2e} (certified suboptimality bound)")

# staircasing-free second-order TGV on the same image
tgv = model.tgv(noisy[0, 0], n_iter=100, device=dev)
print(f"TGV-2:               final loss {float(tgv.loss[-1]):.1f}")
print("OK")
