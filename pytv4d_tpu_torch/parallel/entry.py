"""The entry points on a grid of shards.

The JAX package's entry points take an array placed on a mesh, and GSPMD
partitions the whole call.  Torch has no partitioner, so the port's entry
points recognise a grid (``parallel.mesh.is_grid``: what ``shard``,
``shard_volume`` and ``shard_d_volume`` return) and ask this module for
what differs on one.  The solvers' loops are their own: ``solvers``' CP
step, GD, ADMM and FISTA, and ``solvers.tgv.run_plain``, each run on an
``ops.space.Space``; :func:`solver_space` is a grid's
(``parallel.halo.grid_space``: the exchanged stencils, the arithmetic shard
by shard, every inner product and loss a sum over shards in (iz, it)
order).  Besides, this module holds ``ops.api``'s ``D``, ``D_T``,
``compute_L21_norm`` and ``tv_and_subgrad`` of a grid, the choice of the
fused kernels (:func:`use_kernels`: B1/B2 in their halo or interior modes
with B8, B3/B4 in their halo mode, where the shards are on a CUDA device
and ``kernels.dispatch.can_fuse`` takes them), the TV that GD runs on
(:func:`gd_operators`), CP's call of the fused sharded solver
(:func:`chambolle_pock_fused`) and whether a grid's shards take the fused
kernels (:func:`shards_fuse`; an inverse problem's solve itself is
``solvers.inverse.cp_inverse_grid``).

Each computes what the same call on the gathered volume computes: the
result's fields come back as grids in the input's layout, its loss
histories as one tensor on the shards' device.  A grid's tensors are
already on their device, so nothing is placed: a ``device=`` that names
another raises ``ValueError``.  A grid spread over processes
(``parallel.multihost``) runs the same code.
"""

from __future__ import annotations

import torch

from ..core.config import TVConfig
from ..core.schemes import num_channels
from ..ops.operators import compute_L21_norm, mask_enabled
from ..ops.space import Space
from .fused_halo import (
    make_sharded_cp_solver_fused,
    make_sharded_tv_and_subgrad_fused,
)
from .halo import grid_space, sharded_D, sharded_D_T, sharded_tv_and_subgrad
from .mesh import first_shard, grid_map, grid_mesh, grid_sum


def layout_of(grid, device=None, t_axis: int = 1):
    """``parallel.mesh.grid_mesh`` of ``grid``; ``ValueError`` where
    ``device`` names another device than its shards'."""
    lay = grid_mesh(grid, t_axis)
    if device is not None:
        want, have = torch.device(device), lay.mesh.device
        if want.type != have.type or (want.index is not None
                                      and have.index is not None
                                      and want.index != have.index):
            raise ValueError(
                f"the grid's shards are on {have} and a grid is not moved; "
                f"device={device!r} names another device")
    return lay


def _plane_or_none(mask_static):
    return mask_static if mask_enabled(mask_static) else None


def shards_fuse(local, global_shape, cfg, dtype, depth, mask_static=None,
                weight_time=None) -> bool:
    """``kernels.dispatch.can_fuse`` for a shard of shape ``local`` of a
    ``global_shape`` volume: the features on its storage dtype, the
    shard's extent with ``depth`` halo planes a side (two for the
    subgradient pass, one for the inverse problem's passes), the channel
    table of the whole volume."""
    from ..kernels.dispatch import can_fuse

    if len(local) != 4:
        return False
    ext = (local[0] + 2 * depth, local[1] + 2 * depth) + tuple(local[2:])
    return can_fuse(ext, cfg, mask_static=mask_static, dtype=dtype,
                    weight_time=weight_time,
                    table_dims=tuple(global_shape[:2]))


def use_kernels(grid, cfg, mask_static, weight_time, fused, want=False):
    """Whether a solve on ``grid`` runs the fused kernels: ``fused=None``
    takes them for CUDA shards that they serve (or where ``want``: an
    option only they serve), ``fused=True`` where they serve (on the CPU
    their plain versions), ``ValueError`` where they do not."""
    first = first_shard(grid)
    fits = shards_fuse(tuple(first.shape), grid_mesh(grid).shape, cfg,
                       first.dtype, 2, _plane_or_none(mask_static),
                       weight_time)
    if fused is None:
        return fits and (first_shard(grid).is_cuda or want)
    if fused and not fits:
        raise ValueError(
            "fused=True cannot serve this grid: the fused kernels take "
            "float32 or bfloat16 shards of a rank-4 volume with the 'iso', "
            "'aniso' or 'huber' norm and plane-shaped masks "
            "(kernels.dispatch.can_fuse)")
    return bool(fused)


def solver_space(grid, cfg, mask_static=None, weight_time=None,
                 device=None) -> Space:
    """The ``ops.space.Space`` a solver loop runs ``grid`` on
    (``parallel.halo.grid_space`` of its own mesh, ``cfg``'s D / D_T with
    plane-shaped masks; ``ValueError`` for a ``device`` that is not the
    shards')."""
    lay = layout_of(grid, device)
    return grid_space(lay.mesh, cfg, lay.shape, lay.shard_time,
                      _plane_or_none(mask_static), weight_time)


# ------------------------------------------------------------- ops.api


def _op_cfg(scheme, reg_z_over_reg, reg_time, factor_reg_static=0.0,
            norm="iso", huber_delta=1.0):
    return TVConfig(scheme=scheme, reg_z_over_reg=reg_z_over_reg,
                    reg_time=reg_time, factor_reg_static=factor_reg_static,
                    norm=norm, huber_delta=huber_delta)


def D(grid, scheme="hybrid", reg_z_over_reg=1.0, reg_time=0.0,
      mask_static=False, factor_reg_static=0.0, weight_time=None,
      device=None):
    """``ops.operators.D`` of a volume grid: a grid of
    ``(nz, Nd, m, Nr, Nc)`` shards (``parallel.mesh.shard_d_volume``'s
    layout)."""
    lay = layout_of(grid, device)
    cfg = _op_cfg(scheme, reg_z_over_reg, reg_time, factor_reg_static)
    return sharded_D(lay.mesh, cfg, lay.shape, lay.shard_time,
                     mask_static=_plane_or_none(mask_static),
                     weight_time=weight_time)(grid)


def D_T(grid, scheme="hybrid", reg_z_over_reg=1.0, reg_time=0.0,
        mask_static=False, factor_reg_static=0.0, weight_time=None,
        device=None):
    """``ops.operators.D_T`` of a difference-volume grid
    (``shard_d_volume``'s layout): a volume grid."""
    from ..core.schemes import scheme_channels

    lay = layout_of(grid, device, t_axis=2)
    Nz, Nd, M = lay.shape[:3]
    vol_shape = (Nz, M) + tuple(lay.shape[3:])
    chans, _ = scheme_channels(scheme, Nz, M, reg_z_over_reg, reg_time)
    if Nd != len(chans):
        raise ValueError(
            f"D_img has {Nd} channels but scheme {scheme!r} with Nz={Nz}, "
            f"M={M}, reg_z_over_reg={reg_z_over_reg}, reg_time={reg_time} "
            f"expects {len(chans)}")
    cfg = _op_cfg(scheme, reg_z_over_reg, reg_time, factor_reg_static)
    return sharded_D_T(lay.mesh, cfg, vol_shape, lay.shard_time,
                       mask_static=_plane_or_none(mask_static),
                       weight_time=weight_time)(grid)


def L21_norm(grid, return_array: bool = False, device=None):
    """``ops.operators.compute_L21_norm`` of a difference-volume grid: the
    sum of the shards' norms, and the grid of per-voxel norms with
    ``return_array``."""
    layout_of(grid, device, t_axis=2)
    parts = grid_map(lambda d: compute_L21_norm(d, return_array=True), grid)
    total = grid_sum(grid_map(lambda p: p[0], parts))
    if return_array:
        return total, grid_map(lambda p: p[1], parts)
    return total


def tv_and_subgrad(grid, scheme="hybrid", mask=None, reg_z_over_reg=1.0,
                   reg_time=0.0, mask_static=None, factor_reg_static=0.0,
                   weight_time=None, return_grad_norms=False,
                   norm_type="iso", huber_delta=1.0, device=None):
    """``ops.api.tv_and_subgrad`` of a volume grid: ``(tv, G[, norms])``
    with ``G`` and the norms grids.  CUDA shards that the fused kernels
    serve take one B3 and one B4 launch each, in their halo mode; any
    other grid takes ``parallel.halo.sharded_tv_and_subgrad``.  A full
    ``mask`` is not cut with the volume: it raises ``ValueError``."""
    if mask_enabled(mask):
        raise ValueError(
            "a grid of shards takes no full mask (it is not cut with the "
            "volume); zero the masked voxels of each shard first")
    lay = layout_of(grid, device)
    cfg = _op_cfg(scheme, reg_z_over_reg, reg_time, factor_reg_static,
                  norm_type, huber_delta)
    mask_static = _plane_or_none(mask_static)
    kw = dict(shard_time=lay.shard_time, mask_static=mask_static,
              weight_time=weight_time, return_grad_norms=return_grad_norms)
    if use_kernels(grid, cfg, mask_static, weight_time, None):
        fn = make_sharded_tv_and_subgrad_fused(
            lay.mesh, cfg, lay.shape, dtype=first_shard(grid).dtype, **kw)
    else:
        fn = sharded_tv_and_subgrad(lay.mesh, cfg, lay.shape, **kw)
    return fn(grid)


# ------------------------------------------------------------- solvers


def chambolle_pock_fused(x_noisy, space: Space, *, n_iter, reg, sigma_D,
                         sigma_A, tau, cfg, state, mask_static, weight_time,
                         dual_dtype, return_dual, each, fidelity,
                         fidelity_weight, nonneg):
    """``solvers.chambolle_pock`` of a volume grid on the fused kernels:
    ``parallel.fused_halo.make_sharded_cp_solver_fused``, with its own
    choice of the overlapped step.  ``state`` is a ``CPState`` of grids
    (``y_D`` in ``shard_d_volume``'s layout) or of volumes; ``y_D`` rides
    the kernels' internal layout and is converted back only for
    ``return_dual``."""
    from ..kernels.fused import from_internal_layout, to_internal_layout
    from ..solvers.cp import CPResult, CPState

    lay = layout_of(x_noisy)
    dtype = first_shard(x_noisy).dtype
    if state is None:
        Nd = num_channels(cfg.scheme, lay.shape[0], lay.shape[1],
                          cfg.reg_z_over_reg, cfg.reg_time)
        out_dual_dtype = dtype
        x, y_A = x_noisy, grid_map(torch.zeros_like, x_noisy)
        y_int = grid_map(lambda a: a.new_zeros(
            (a.shape[0], a.shape[1], Nd) + tuple(a.shape[2:]),
            dtype=dual_dtype or dtype), x_noisy)
    else:
        st = CPState(*state)
        x, y_A = space.place(st.x), space.place(st.y_A)
        y_D = space.place(st.y_D, d_volume=True)
        out_dual_dtype = first_shard(y_D).dtype
        y_int = grid_map(to_internal_layout, y_D)
    solve = make_sharded_cp_solver_fused(
        lay.mesh, cfg, lay.shape, reg=reg, n_iter=n_iter, sigma_D=sigma_D,
        sigma_A=sigma_A, tau=tau, shard_time=lay.shard_time,
        mask_static=_plane_or_none(mask_static), weight_time=weight_time,
        fidelity=fidelity, fidelity_weight=fidelity_weight, nonneg=nonneg,
        dual_dtype=dual_dtype, dtype=dtype)
    x, y_A, y_int, losses = solve(x_noisy, x, y_A, y_int, each)
    y_D = (grid_map(lambda a: from_internal_layout(a).to(out_dual_dtype),
                    y_int) if return_dual else None)
    return CPResult(x=x, state=CPState(x, y_A, y_D), loss=losses)


def gd_operators(grid, cfg, mask_static, weight_time, fused):
    """What ``solvers.subgradient_descent`` runs a grid on:
    ``(space, tv_and_G, fused)``, the TV and subgradient from
    :func:`make_sharded_tv_and_subgrad_fused` (B3 and B4 in their halo
    mode, one launch each a shard) where :func:`use_kernels` says, else
    from ``parallel.halo.sharded_tv_and_subgrad``."""
    lay = layout_of(grid)
    mask_static = _plane_or_none(mask_static)
    fused = use_kernels(grid, cfg, mask_static, weight_time, fused)
    kw = dict(shard_time=lay.shard_time, mask_static=mask_static,
              weight_time=weight_time)
    if fused:
        tv_and_G = make_sharded_tv_and_subgrad_fused(
            lay.mesh, cfg, lay.shape, dtype=first_shard(grid).dtype, **kw)
    else:
        tv_and_G = sharded_tv_and_subgrad(lay.mesh, cfg, lay.shape, **kw)
    return (grid_space(lay.mesh, None, lay.shape, lay.shard_time), tv_and_G,
            fused)
