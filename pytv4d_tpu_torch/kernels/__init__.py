"""The fused CP step (with its pass A for inverse problems, its z-marching
pass A and the boundary kernels of its sharded form), the TV subgradient,
the whole CP and GD solves and the TGV-2 step and whole solve:
CUDA kernels (``csrc/cp_zstream.cu``, ``csrc/cp_boundary.cu``,
``csrc/resident.cu``, ``csrc/resident_onchip.cu``,
``csrc/tgv_stream.cu``, ``csrc/tgv_resident.cu``, ``csrc/tgv_onchip.cu``;
the boundary passes of ``csrc/cp_boundary.cu``, the z-marching pass A of
``csrc/cp_zstream.cu``, the on-chip whole solves of
``csrc/resident_onchip.cu``, CP passes A and B (on an unsharded volume)
and the TV subgradient (also on a shard) from ``csrc/specialised.cu``, the
TV norms and the pass A for inverse problems (both also on a shard) from
``csrc/specialised_tv.cu``, CP passes A and B on a shard from
``csrc/specialised_cp.cu``, specialised per channel table,
``kernels.tables``) for CUDA tensors, their
plain PyTorch versions for CPU tensors.  Importing this package needs
neither a GPU nor nvcc: the kernels are built on their first launch."""

from . import (
    build,
    dispatch,
    fused,
    resident,
    tables,
    tgv_resident,
    tgv_stream,
    zstream,
)
from .dispatch import can_fuse, t_plane_multiplier
from .fused import (
    cp_dual,
    cp_dual_boundary,
    cp_dual_boundary_plain,
    cp_dual_plain,
    cp_primal,
    cp_primal_boundary,
    cp_primal_boundary_plain,
    cp_primal_plain,
    cp_step_fused,
    cp_step_fused_internal,
    fits_kernel,
    tv_and_subgrad_fused,
    tv_dual,
    tv_dual_plain,
    tv_gd_step,
    tv_gd_step_plain,
    tv_norms,
    tv_norms_plain,
    tv_subgrad,
    tv_subgrad_plain,
)
from .resident import (
    make_resident_cp_solver,
    make_resident_gd_solver,
    resident_cp_plain,
    resident_fits,
    resident_gd_plain,
    resident_variant,
)
from .tgv_resident import (
    tgv_resident_fits,
    tgv_resident_plain,
    tgv_resident_solve,
    tgv_resident_variant,
)
from .tgv_stream import (
    stream_fits,
    tgv_pq,
    tgv_pq_plain,
    tgv_stream_step,
    tgv_xw,
    tgv_xw_plain,
)
from .zstream import cp_dual_zstream, cp_dual_zstream_plain
