"""The (z, t)-sharded paths: the mesh of shards, the plain halo-exchange
operators and CP solver, the CP / GD solvers on the fused kernels, the
sharded TGV solvers and the processes that share a mesh (the port of
``pytv4d_tpu/parallel``'s ``mesh``, ``halo``, ``fused_halo``,
``tgv_sharded`` and ``multihost``).  The shards of one process share its
device."""

from . import fused_halo, halo, mesh, multihost, tgv_sharded
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
    Sharding,
    d_volume_sharding,
    d_volume_spec,
    gather_d_volume,
    gather_volume,
    grid_mesh,
    is_grid,
    make_mesh,
    plane_from_left,
    plane_from_right,
    planes_from_left,
    planes_from_right,
    shard,
    shard_d_volume,
    shard_volume,
    volume_sharding,
    volume_spec,
)
from .tgv_sharded import make_sharded_tgv_stream_solver, tgv_denoise_sharded
