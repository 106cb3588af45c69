"""The fused CP step and TV subgradient: CUDA kernels (``csrc/cp_fused.cu``,
``csrc/tv_fused.cu``) for CUDA tensors, their plain PyTorch versions for CPU
tensors.  Importing this package needs
neither a GPU nor nvcc: the kernels are built on their first launch."""

from . import build, dispatch, fused
from .dispatch import can_fuse, t_plane_multiplier
from .fused import (
    cp_dual,
    cp_dual_plain,
    cp_primal,
    cp_primal_plain,
    cp_step_fused,
    cp_step_fused_internal,
    fits_kernel,
    tv_and_subgrad_fused,
    tv_norms,
    tv_norms_plain,
    tv_subgrad,
    tv_subgrad_plain,
)
