"""The (z, t)-sharded paths: the mesh of shards, the plain halo-exchange
operators and CP solver, and the CP / GD solvers on the fused kernels (the
port of ``pytv4d_tpu/parallel``'s ``mesh``, ``halo`` and ``fused_halo``).
All shards of a mesh share one device."""

from . import fused_halo, halo, mesh
from .fused_halo import (
    make_sharded_cp_solver_fused,
    make_sharded_gd_solver_fused,
)
from .halo import (
    make_sharded_cp_solver,
    sharded_cp_step,
    sharded_D,
    sharded_D_T,
    sharded_tv_and_subgrad,
)
from .mesh import (
    T_AXIS,
    Z_AXIS,
    Mesh,
    gather_d_volume,
    gather_volume,
    make_mesh,
    plane_from_left,
    plane_from_right,
    shard_d_volume,
    shard_volume,
)
