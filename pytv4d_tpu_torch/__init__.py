"""pytv4d_tpu_torch — the PyTorch/CUDA port of pytv4d_tpu.

Total-variation denoising of 2D/3D/4D ``(Nz, M, N_row, N_col)`` volumes with
the Chambolle-Pock solver, on any torch device: on an NVIDIA Hopper GPU the
solver's step runs as two hand-written CUDA kernels (``kernels.fused``,
sources in ``csrc/``, built with nvcc on first use); on the CPU it runs
their plain PyTorch versions.  The JAX package ``pytv4d_tpu`` is the
reference it is tested against; this package imports torch and never jax.

    import torch
    from pytv4d_tpu_torch.models import TVDenoiser, add_noise
    from pytv4d_tpu_torch.utils import cameraman

    noisy = torch.as_tensor(add_noise(cameraman(), 100, seed=0),
                            dtype=torch.float32, device="cuda")
    res = TVDenoiser(reg=25).cp(noisy, n_iter=300)
"""

from . import core, interop, kernels, models, ops, solvers, utils
from .core.config import TVConfig
from .core.schemes import SCHEMES, num_channels, operator_norm_bound_sq
from .models.denoise import TVDenoiser, add_noise, denoise_tv_chambolle
from .ops.operators import D, D_T, compute_L21_norm
from .solvers.cp import CPResult, CPState, chambolle_pock
