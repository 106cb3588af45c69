"""Second-order TGV: fixing TV's staircasing, for denoising and CT: the
PyTorch/CUDA twin of ``examples/e_tgv.py``.

First-order TV assumes piecewise-CONSTANT images; on smooth gradients it
produces the classic staircase artifact.  TGV-2 (Bredies, Kunisch & Pock
2010) adds an auxiliary vector field w that tracks the gradient, penalizing
``a1 ||D x - w|| + a0 ||E w||`` — piecewise-LINEAR content becomes free.

Two experiments (both assert TGV beats TV in RMSE):
1. Denoising a noisy linear ramp: ``tgv_denoise`` vs Chambolle-Pock TV.
   On an NVIDIA Hopper GPU the 2D mode is one launch of the whole-solve
   kernel (``kernels/tgv_resident.py``).
2. CT reconstruction of a ramp-filled disk from 16 noisy projection
   angles: ``models.ct.tgv_reconstruct`` vs ``cp_reconstruct``.

Runs on the CUDA device (``--device cpu`` for the CPU; no fallback):

    python examples/torch_e_tgv.py [--device cpu]
"""

# Allow running from a repo checkout without installation.
import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse

import numpy as np
import torch

from pytv4d_tpu_torch.models import TVDenoiser
from pytv4d_tpu_torch.models.ct import cp_reconstruct, radon, tgv_reconstruct

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda)")
dev = torch.device(parser.parse_args().device)
if dev.type == "cuda" and not torch.cuda.is_available():
    raise RuntimeError("no CUDA device; pass --device cpu to run on the CPU")

# ---- 1. denoising a noisy ramp ------------------------------------------
N = 64
rng = np.random.default_rng(0)
ramp = np.linspace(0, 100, N)[None, :] * np.ones((N, 1))
noisy = (ramp + 10 * rng.standard_normal((N, N))).astype(np.float32)

den = TVDenoiser(reg=8.0)
tv = den.cp(noisy, n_iter=400, device=dev)
tgv = den.tgv(noisy, n_iter=800, device=dev)  # alpha1=reg, alpha0=2*reg

err_tv = float(np.sqrt(np.mean((tv.x.cpu().numpy() - ramp) ** 2)))
err_tgv = float(np.sqrt(np.mean((tgv.x.cpu().numpy() - ramp) ** 2)))
print(f"ramp denoising RMSE: TV {err_tv:.2f} (staircased), TGV {err_tgv:.2f}")
assert err_tgv < err_tv

# ---- 2. TGV-CT ------------------------------------------------------------
N = 24
yy = np.linspace(-1, 1, N)[:, None] * np.ones((1, N))
xx = np.ones((N, 1)) * np.linspace(-1, 1, N)[None, :]
disk = (xx ** 2 + yy ** 2) <= 0.81
truth = np.where(disk, 0.5 + 0.5 * yy, 0.0)[None, None].astype(np.float32)

angles = np.linspace(0, np.pi, 16, endpoint=False)
sino = radon(truth, angles, device=dev)
sino += torch.as_tensor(0.4 * rng.standard_normal(tuple(sino.shape)),
                        dtype=torch.float32, device=dev)

rec_tv = cp_reconstruct(sino, angles, truth.shape, n_iter=1500, reg=1.2,
                        op_norm=float(N))
rec_tgv = tgv_reconstruct(sino, angles, truth.shape, n_iter=1500,
                          alpha1=1.2, alpha0=2.4, op_norm=float(N))

mask = disk[None, None]
err_tv = float(np.sqrt(np.mean((rec_tv.x.cpu().numpy() - truth)[mask] ** 2)))
err_tgv = float(np.sqrt(np.mean((rec_tgv.x.cpu().numpy() - truth)[mask]
                                ** 2)))
print(f"CT of a ramp disk, 16 angles, RMSE: TV {err_tv:.4f}, "
      f"TGV {err_tgv:.4f}")
assert err_tgv < err_tv
print("TGV example OK")
print("OK")
