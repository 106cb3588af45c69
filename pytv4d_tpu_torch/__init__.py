"""pytv4d_tpu_torch — the PyTorch/CUDA port of pytv4d_tpu.

Total variation of 2D/3D/4D ``(Nz, M, N_row, N_col)`` volumes — the value
and subgradient (``ops.tv``, and the reference's ``tv_CPU`` / ``tv_GPU`` /
``tv_operators_CPU`` / ``tv_operators_GPU`` modules) — TV denoising with the Chambolle-Pock
(plain and diagonally preconditioned), subgradient-descent, ADMM and dual
FISTA solvers, checkpointing and tolerance-based stopping
(``solvers.state``), second-order TGV denoising (``solvers.tgv``),
TV-regularized linear inverse problems (``solvers.inverse``) and
parallel-, fan- and cone-beam CT reconstruction with FBP, FDK and SART
(``models.ct``), and the CP and GD solvers
on a (z, t) grid of shards (``parallel``), on any torch device.  On an
NVIDIA Hopper GPU the CP step (denoising and inverse), the TV subgradient
and the TGV step each run as two hand-written CUDA kernels, and the
in-plane TGV solve as one; a whole CP or GD solve of a small volume in one
launch (``kernels.resident``) and a z-marching CP pass A
(``kernels.zstream``) are there to call directly (``kernels``, sources in
``csrc/``, built with nvcc on first use); on the CPU they run their plain PyTorch versions.  The
JAX package ``pytv4d_tpu`` is the reference it is tested against; this
package imports torch and never jax.

A tensor is computed on its own device.  A numpy array goes to the CUDA
device, and the call raises where there is none; ``device="cpu"`` asks for
the CPU (``utils.device``).

    import numpy as np
    from pytv4d_tpu_torch.models import TVDenoiser, add_noise
    from pytv4d_tpu_torch.utils import cameraman

    noisy = add_noise(cameraman(), 100, seed=0).astype(np.float32)
    res = TVDenoiser(reg=25).cp(noisy, n_iter=300)   # on the GPU
    res = TVDenoiser(reg=25).gd(noisy, n_iter=300)
    res = TVDenoiser(reg=25).tgv(noisy, n_iter=300)

    from pytv4d_tpu_torch.models import cp_reconstruct, radon
    sino = radon(vol, angles)                 # (Nz, M, n_angles, n_det)
    res = cp_reconstruct(sino, angles, vol.shape, n_iter=30, reg=0.05,
                         nonneg=True)

The reference's own module layout (``pytv/__init__.py:43-63``) is here
too, so ``import pytv4d_tpu_torch as pytv`` serves its call sites:
``tv_CPU`` / ``tv_operators_CPU`` (NumPy in and out, computed on the
CPU), ``tv_GPU`` / ``tv_operators_GPU`` (on the CUDA device), ``tests``,
``run_CPU_tests``, ``run_GPU_tests`` and ``cameraman``.
"""

__version__ = "0.1.0"

from . import (
    core,
    interop,
    kernels,
    models,
    ops,
    parallel,
    solvers,
    tests,
    tv_CPU,
    tv_GPU,
    tv_operators_CPU,
    tv_operators_GPU,
    utils,
)
from .core.config import TVConfig
from .core.schemes import SCHEMES, num_channels, operator_norm_bound_sq
from .models.denoise import TVDenoiser, add_noise, denoise_tv_chambolle
from .ops.api import (
    D,
    D_T,
    D_central,
    D_downwind,
    D_hybrid,
    D_T_central,
    D_T_downwind,
    D_T_hybrid,
    D_T_upwind,
    D_upwind,
    compute_L21_norm,
    tv_and_subgrad,
    tv_central,
    tv_downwind,
    tv_hybrid,
    tv_upwind,
)
from .ops.tv import make_tv
from .solvers.admm import ADMMResult, ADMMState, admm
from .solvers.cp import (
    CPPrecondState,
    CPResult,
    CPState,
    chambolle_pock,
    chambolle_pock_precond,
)
from .solvers.fista import FISTAResult, fista
from .solvers.gd import GDResult, subgradient_descent
from .solvers.inverse import InverseResult, InverseState, cp_inverse
from .solvers.tgv import TGVResult, TGVState, tgv_denoise
from .testing import run_CPU_tests, run_GPU_tests
from .utils.images import cameraman
