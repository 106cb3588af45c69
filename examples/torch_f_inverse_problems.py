"""Generic TV-regularized inverse problems, one solver, many operators: the
PyTorch/CUDA twin of ``examples/f_inverse_problems.py``.

``solvers.cp_inverse`` solves ``min_x 1/2||A x - b||^2 + reg TV(x)`` for ANY
linear ``A`` written in torch ops: the adjoint defaults to the recorded
vjp of ``A`` (exact by construction), and ``precond=True`` replaces the
operator-norm step rule with exact Pock-Chambolle diagonal preconditioning
(several-fold fewer iterations; no power method).

Five problems, same call:
1. Gaussian deblurring (``gaussian_blur_operator``);
2. inpainting (a masking operator — the hole is filled by TV);
3. CT with diagonal preconditioning (``models.ct.cp_reconstruct``);
4. photon-count CT with the Poisson log-likelihood (``fidelity='kl'``,
   per-ray count weights, nonnegative attenuation);
5. salt-and-pepper denoising with the robust TV-L1 model
   (``fidelity='l1'``);
then reg by the discrepancy principle and by gradient descent through the
unrolled solve (``torch.autograd`` in a ``reg`` tensor).  Runs on the CUDA
device (``--device cpu`` for the CPU; no fallback):

    python examples/torch_f_inverse_problems.py [--device cpu]
"""

# Allow running from a repo checkout without installation.
import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse

import numpy as np
import torch

from pytv4d_tpu_torch.models.ct import cp_reconstruct, radon
from pytv4d_tpu_torch.solvers import cp_inverse, gaussian_blur_operator
from pytv4d_tpu_torch.utils import synthetic_phantom

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda)")
dev = torch.device(parser.parse_args().device)
if dev.type == "cuda" and not torch.cuda.is_available():
    raise RuntimeError("no CUDA device; pass --device cpu to run on the CPU")


def on(a):
    return torch.as_tensor(a, dtype=torch.float32, device=dev)


def host(t):
    return t.detach().cpu().numpy()


# ---- 1. deblurring --------------------------------------------------------
truth = np.zeros((1, 1, 32, 32), np.float32)
truth[0, 0, 8:24, 10:26] = 1.0
A = gaussian_blur_operator(truth.shape, sigma_px=1.5, radius=4)
b = A(on(truth))
res = cp_inverse(A, b, truth.shape, n_iter=400, reg=2e-4, x_init=b)
err_blur = float(np.mean((host(b) - truth) ** 2))
err_rec = float(np.mean((host(res.x) - truth) ** 2))
print(f"deblurring MSE: blurred {err_blur:.4f} -> TV-recovered {err_rec:.4f}")
assert err_rec < 0.5 * err_blur

# ---- 2. inpainting --------------------------------------------------------
mask = np.ones_like(truth)
mask[0, 0, 12:20, 14:22] = 0.0           # the hole
mask_t = on(mask)
b = on(truth) * mask_t
res = cp_inverse(lambda x: x * mask_t, b, truth.shape, n_iter=600, reg=0.2,
                 x_init=b)
hole_err = float(np.max(np.abs(host(res.x) - truth)[mask == 0]))
print(f"inpainting: max error inside the hole {hole_err:.3f}")
assert hole_err < 0.2

# ---- 3. CT with diagonal preconditioning ----------------------------------
phantom = (synthetic_phantom(32).astype(np.float32) / 255.0)[None, None]
angles = np.linspace(0, np.pi, 24, endpoint=False)
rng = np.random.default_rng(0)
sino = host(radon(phantom, angles, device=dev))
sino += 0.2 * rng.standard_normal(sino.shape).astype(np.float32)

# the solves take the projector that made the data, radon's ('auto' would
# take the spectral pair on the card)
plain = cp_reconstruct(on(sino), angles, phantom.shape, n_iter=600, reg=0.3,
                       op_norm=32.0, method="gather")
fast = cp_reconstruct(on(sino), angles, phantom.shape, n_iter=100, reg=0.3,
                      precond=True, method="gather")
print(f"TV-CT loss: 600 plain iterations {float(plain.loss[-1]):.2f}, "
      f"100 preconditioned {float(fast.loss[-1]):.2f}")
assert float(fast.loss[-1]) < float(plain.loss[-1])

# ---- 4. photon-count CT: Poisson fidelity ----------------------------------
# counts ~ Poisson(I0 exp(-A x)); fit the post-log sinogram under the KL
# (Poisson log-likelihood) fidelity, weighting each ray by its counts
# (high-count rays are trusted more) — the physically correct low-dose model.
# Attenuation is scaled to physical levels (max line integral ~2, i.e.
# ~13% transmission) so the counts carry signal.
I0 = 2e4
mu = 0.08 * phantom
sino_clean = host(radon(mu, angles, device=dev))
counts = np.maximum(rng.poisson(I0 * np.exp(-sino_clean)), 1)
b_log = on(np.maximum(-np.log(counts / I0), 0.0))
kl = cp_reconstruct(b_log, angles, mu.shape, n_iter=150, reg=5e-4,
                    fidelity="kl", fidelity_weight=on(counts / counts.mean()),
                    nonneg=True, precond=True, method="gather")
rmse_kl = float(np.sqrt(np.mean((host(kl.x) - mu) ** 2)))
rel_kl = rmse_kl / float(np.sqrt((mu ** 2).mean()))
print(f"Poisson-count TV-CT: relative rmse {rel_kl:.3f}, min x "
      f"{float(kl.x.min()):.4f} (nonneg)")
assert rel_kl < 0.2 and float(kl.x.min()) >= 0.0

# ---- 5. impulsive noise: the TV-L1 model -----------------------------------
# least squares smears salt-and-pepper outliers; the L1 fidelity rejects them
sp = phantom.copy()
flips = rng.random(sp.shape) < 0.15
sp[flips] = rng.choice([0.0, 1.5], size=int(flips.sum()))
x_l1 = cp_inverse(lambda x: x, on(sp), sp.shape, n_iter=400,
                  reg=0.9, fidelity="l1", op_norm=1.0).x
x_l2 = cp_inverse(lambda x: x, on(sp), sp.shape, n_iter=400,
                  reg=0.25, op_norm=1.0).x
e1 = float(np.sqrt(np.mean((host(x_l1) - phantom) ** 2)))
e2 = float(np.sqrt(np.mean((host(x_l2) - phantom) ** 2)))
print(f"salt-and-pepper rmse: TV-L1 {e1:.4f} vs TV-L2 {e2:.4f}")
assert e1 < e2

# ---- 6. automatic regularization: Morozov's discrepancy principle ----------
# when the noise level is known, pick reg so the residual matches it —
# no manual sweep; each trial warm-starts from the previous solution
from pytv4d_tpu_torch.solvers import reg_discrepancy

sigma_n = 0.15
noise = sigma_n * rng.standard_normal(sino.shape).astype(np.float32)
b_noisy = on(host(radon(phantom, angles, device=dev)) + noise)
reg_auto, res_auto = reg_discrepancy(
    lambda x: radon(x, angles), b_noisy, phantom.shape,
    noise_norm=float(np.linalg.norm(noise)), n_iter=100)
resid = float(torch.sqrt(torch.sum((radon(res_auto.x, angles) - b_noisy)
                                   ** 2)))
print(f"discrepancy principle: reg {reg_auto:.2e}, residual {resid:.2f} "
      f"vs noise norm {float(np.linalg.norm(noise)):.2f}")

# ---- 7. gradient-based reg tuning: differentiate THROUGH the solver --------
# with a reference image available, reg can be learned by gradient descent
# on the reconstruction error — torch.autograd flows through the unrolled
# CP iterations (a reg tensor that requires grad; safe-sqrt keeps the
# gradients finite)
truth_t = on(phantom)


def recon_mse(reg):
    res = cp_inverse(lambda x: radon(x, angles), b_noisy, phantom.shape,
                     n_iter=60, reg=reg, op_norm=32.0)
    return torch.mean(torch.square(res.x - truth_t))


reg_t, lr = 0.05, 0.5
trail = []
for _ in range(8):
    reg = torch.tensor(reg_t, device=dev, requires_grad=True)
    v = recon_mse(reg)
    (g,) = torch.autograd.grad(v, reg)
    trail.append(float(v.detach()))
    reg_t = max(1e-4, reg_t - lr * float(g))
print(f"gradient-tuned reg: {reg_t:.3f}, recon MSE {trail[0]:.5f} -> "
      f"{trail[-1]:.5f}")
assert trail[-1] < trail[0]
print("inverse-problems example OK")
print("OK")
