"""The explicit halo-exchange path: D / D_T / tv / CP over a (z, t) grid of
shards, in plain PyTorch per shard.

The port of ``pytv4d_tpu/parallel/halo.py``.  Each shard owns a contiguous
block of z-slices (and optionally time frames), takes ONE boundary plane per
direction per operator application from its neighbours
(``parallel.mesh.planes_from_left`` / ``planes_from_right``) and the norms
and losses are sums of per-shard scalars, taken in a fixed (iz, it) order
(``parallel.mesh.grid_sum``).  A grid spread over processes runs the same
code: its exchange and sums cross the processes there.

Correctness contract (SURVEY.md section 7 "hard parts" item 2): the sharded
operators are *slot-exact* with the single-device path.  Boundary slots that
are zero globally are zeroed on the owning shard, so the adjointness oracle
``<Y, D X> == <D^T Y, X>`` holds on the sharded path to fp precision, and
solver iterates compare with the unsharded solver's up to the order of the
loss sum.

Every function here maps grids of shards (``shards[iz][it]``,
``parallel.mesh.shard_volume``) to grids of shards: where the JAX package
runs one function per device under ``shard_map``, the port loops over the
grid.  No kernel runs here; ``parallel.fused_halo`` is the path on the fused
kernels.
"""

from __future__ import annotations

import torch

from ..core.config import TVConfig
from ..core.schemes import BWD, FWD, channel_weight, scheme_channels
from ..ops.operators import _sl, d_channel, dt_channel, tv_norm
from ..ops.space import Space
from .mesh import (
    Mesh,
    check_divisible,
    d_volume_sharding,
    first_shard,
    grid_like,
    grid_map,
    grid_max,
    grid_min,
    grid_size,
    grid_sum,
    indexed,
    is_grid,
    mesh_sizes,
    planes_from_left,
    planes_from_right,
    shard,
    volume_sharding,
)

__all__ = [
    "sharded_D",
    "sharded_D_T",
    "sharded_tv_and_subgrad",
    "sharded_cp_step",
    "make_sharded_cp_solver",
    "grid_space",
    "broadcast_map",
    "grid_precond_maps",
]


def _axis_size(shards, axis: int) -> int:
    """Number of shards along tensor axis ``axis`` (rows and columns are
    never sharded)."""
    return grid_size(shards, axis) if axis < 2 else 1


def _zero_slot(d, axis: int, slot: int):
    d[_sl(d.ndim, axis, slot, slot + 1 if slot != -1 else None)] = 0
    return d


def sharded_d_channel(shards, axis: int, kind: str):
    """One difference channel on every shard: a 1-plane halo from the
    neighbour and the global-boundary slot zeroed on the shard that owns it.
    The local stencil where the axis is not sharded."""
    n = _axis_size(shards, axis)
    if n == 1:
        return grid_map(lambda x: d_channel(x, axis, kind), shards)
    lo = planes_from_left(shards, axis) if kind != FWD else None
    hi = planes_from_right(shards, axis) if kind != BWD else None
    out = []
    for iz, it, x in indexed(shards):
        first, last = (iz, it)[axis] == 0, (iz, it)[axis] == n - 1
        nd = x.ndim
        if kind == FWD:
            ext = torch.cat([x, hi[iz][it]], axis)
            d = ext[_sl(nd, axis, 1, None)] - ext[_sl(nd, axis, None, -1)]
            out.append(_zero_slot(d, axis, -1) if last else d)
        elif kind == BWD:
            ext = torch.cat([lo[iz][it], x], axis)
            d = ext[_sl(nd, axis, 1, None)] - ext[_sl(nd, axis, None, -1)]
            out.append(_zero_slot(d, axis, 0) if first else d)
        else:
            ext = torch.cat([lo[iz][it], x, hi[iz][it]], axis)
            d = ext[_sl(nd, axis, 2, None)] - ext[_sl(nd, axis, None, -2)]
            if first:
                d = _zero_slot(d, axis, 0)
            out.append(_zero_slot(d, axis, -1) if last else d)
    return grid_like(shards, out)


def sharded_dt_channel(ys, axis: int, kind: str):
    """Adjoint scatter of one channel on every shard.  The invalid slot is
    zeroed *before* the exchange, so what crosses a shard edge is exact."""
    n = _axis_size(ys, axis)
    if n == 1:
        return grid_map(lambda y: dt_channel(y, axis, kind), ys)

    def valid(iz, it, y):
        first, last = (iz, it)[axis] == 0, (iz, it)[axis] == n - 1
        if (kind != BWD and last) or (kind != FWD and first):
            y = y.clone()
            if kind != BWD and last:
                _zero_slot(y, axis, -1)
            if kind != FWD and first:
                _zero_slot(y, axis, 0)
        return y

    yv = grid_like(ys, [valid(*cell) for cell in indexed(ys)])
    lo = planes_from_left(yv, axis) if kind != BWD else None
    hi = planes_from_right(yv, axis) if kind != FWD else None
    out = []
    for iz, it, y in indexed(yv):
        nd = y.ndim
        if kind == FWD:
            ext = torch.cat([lo[iz][it], y], axis)
            out.append(ext[_sl(nd, axis, None, -1)] - y)
        elif kind == BWD:
            ext = torch.cat([y, hi[iz][it]], axis)
            out.append(y - ext[_sl(nd, axis, 1, None)])
        else:
            left = torch.cat([lo[iz][it], y], axis)
            right = torch.cat([y, hi[iz][it]], axis)
            out.append(left[_sl(nd, axis, None, -1)]
                       - right[_sl(nd, axis, 1, None)])
    return grid_like(ys, out)


def _table(cfg: TVConfig, global_shape):
    """The channel table from the GLOBAL ``(Nz, M)``: a shard may hold one
    z-slice of a 3D volume, and the channels must not change per shard."""
    return scheme_channels(cfg.scheme, global_shape[0], global_shape[1],
                           cfg.reg_z_over_reg, cfg.reg_time)


def _local_D(shards, cfg: TVConfig, global_shape, tmul=None):
    """D on every shard: ``(nz, Nd, m, Nr, Nc)`` per shard.  ``tmul``: the
    (Nr, Nc) multiplier of the time channels (:func:`_t_multiplier`)."""
    chans, norm = _table(cfg, global_shape)
    outs = []
    for ch in chans:
        d = sharded_d_channel(shards, ch.axis, ch.kind)
        w = channel_weight(ch, cfg.reg_z_over_reg, cfg.reg_time)
        if w != 1.0:
            d = grid_map(lambda a: a * w, d)
        if ch.weight == "t" and tmul is not None:
            d = grid_map(lambda a: a * tmul, d)
        outs.append(d)

    def stack(*ds):
        D_img = torch.stack(ds, dim=1)
        return D_img * norm if norm != 1.0 else D_img

    return grid_map(stack, *outs)


def _local_D_T(ys, cfg: TVConfig, global_shape, weighted: bool = True,
               tmul=None):
    """D_T on every shard from public-layout shards ``(nz, Nd, m, Nr, Nc)``;
    ``weighted=False`` leaves the per-axis weights and ``tmul`` out, as
    the isotropic subgradient does (``ops.tv._subgrad_from_D``).  ``tmul``
    multiplies the time channels before the scatter (the exact transpose
    of :func:`_local_D`'s)."""
    chans, norm = _table(cfg, global_shape)
    out = None
    for i, ch in enumerate(chans):
        w = channel_weight(ch, cfg.reg_z_over_reg, cfg.reg_time)
        if weighted and w != 1.0:
            y = grid_map(lambda a: a[:, i] * w, ys)
        else:
            y = grid_map(lambda a: a[:, i], ys)
        if weighted and ch.weight == "t" and tmul is not None:
            y = grid_map(lambda a: a * tmul, y)
        contrib = sharded_dt_channel(y, ch.axis, ch.kind)
        out = contrib if out is None else grid_map(torch.add, out, contrib)
    return grid_map(lambda a: a * norm, out) if norm != 1.0 else out


def _t_multiplier(cfg: TVConfig, global_shape, mask_static, weight_time):
    """``fn(dtype, device)``: the (Nr, Nc) time-channel multiplier of a
    plane-shaped ``mask_static`` / ``weight_time``
    (``kernels.dispatch.t_plane_multiplier``), None without them.  A mesh
    cuts z and t only, so every shard takes the same plane; a field that
    varies over z or t raises ``ValueError``."""
    from ..kernels.dispatch import _is_plane, t_plane_multiplier
    from ..ops.operators import mask_enabled

    for name, a in (("mask_static", mask_static if mask_enabled(mask_static)
                     else None), ("weight_time", weight_time)):
        if a is not None and not _is_plane(a, global_shape):
            raise ValueError(
                f"a grid of shards takes a plane-shaped {name} (broadcastable "
                f"to (1, 1, {global_shape[-2]}, {global_shape[-1]})); a field "
                f"over z or t is not cut with the volume")
    made = {}

    def fn(dtype, device):
        key = (dtype, device)
        if key not in made:
            made[key] = t_plane_multiplier(tuple(global_shape), cfg,
                                           mask_static, weight_time,
                                           dtype=dtype, device=device)
        return made[key]

    return fn


def _check_grid(shards, mesh: Mesh, global_shape, shard_time, t_axis=1):
    """The grid is the mesh's and its shards tile ``global_shape``."""
    nz, nt = mesh_sizes(mesh, shard_time)
    check_divisible(global_shape, nz, nt)
    if len(shards) != nz or any(row is not None and len(row) != nt
                                for row in shards):
        raise ValueError(f"expected a {nz} x {nt} grid of shards "
                         f"(parallel.mesh.shard_volume)")
    local = (global_shape[0] // nz, global_shape[1] // nt)
    first = first_shard(shards)
    got = (first.shape[0], first.shape[t_axis])
    if got != local:
        raise ValueError(f"shards of {tuple(global_shape)} on this mesh hold "
                         f"{local} (z, t) planes, got {got}")


def sharded_D(mesh: Mesh, cfg: TVConfig, global_shape,
              shard_time: bool = True, mask_static=None, weight_time=None):
    """Build ``D`` on a sharded volume: shards of x in, shards of
    ``(Nz, Nd, M, Nr, Nc)`` out (``parallel.mesh.gather_d_volume``).
    ``mask_static`` / ``weight_time``: planes, as ``ops.operators.D``'s
    (with ``cfg.factor_reg_static``)."""
    tmul = _t_multiplier(cfg, global_shape, mask_static, weight_time)

    def fn(x):
        _check_grid(x, mesh, global_shape, shard_time)
        first = first_shard(x)
        return _local_D(x, cfg, global_shape, tmul(first.dtype, first.device))

    return fn


def sharded_D_T(mesh: Mesh, cfg: TVConfig, global_shape,
                shard_time: bool = True, mask_static=None, weight_time=None):
    """Build ``D_T`` on a sharded difference volume
    (``parallel.mesh.shard_d_volume``): shards of x's layout out.
    ``mask_static`` / ``weight_time`` as :func:`sharded_D`'s."""
    tmul = _t_multiplier(cfg, global_shape, mask_static, weight_time)

    def fn(y):
        _check_grid(y, mesh, global_shape, shard_time, t_axis=2)
        first = first_shard(y)
        return _local_D_T(y, cfg, global_shape,
                          tmul=tmul(first.dtype, first.device))

    return fn


def broadcast_map(fn, *args):
    """``grid_map`` of ``fn`` over the arguments that are grids; every
    other argument (a Python number, a tensor that broadcasts against a
    shard) goes to each shard as it is."""
    at = [i for i, a in enumerate(args) if is_grid(a)]
    if len(at) == len(args):
        return grid_map(fn, *args)
    if not at:  # nothing to cut: the same value for every shard
        return fn(*args)

    def call(*cells):
        full = list(args)
        for i, c in zip(at, cells):
            full[i] = c
        return fn(*full)

    return grid_map(call, *(args[i] for i in at))


def grid_space(mesh: Mesh, cfg, global_shape, shard_time: bool = True,
               mask_static=None, weight_time=None) -> Space:
    """The ``ops.space.Space`` of a grid of shards on ``mesh``: D / D_T of
    ``cfg`` (:func:`sharded_D`, :func:`sharded_D_T`; none where ``cfg`` is
    None), the exchanged one-channel stencils, :func:`broadcast_map`,
    ``grid_sum``, ``grid_max`` and ``grid_min``; ``place`` cuts a whole
    volume (or, with ``d_volume``, a difference volume) on the mesh and
    leaves a grid as it is."""
    D = D_T = None
    if cfg is not None:
        D = sharded_D(mesh, cfg, global_shape, shard_time, mask_static,
                      weight_time)
        D_T = sharded_D_T(mesh, cfg, global_shape, shard_time, mask_static,
                          weight_time)

    def over(reduce):
        return lambda fn, *args: reduce(broadcast_map(fn, *args))

    def place(a, d_volume=False):
        if a is None or is_grid(a):
            return a
        sharding = d_volume_sharding if d_volume else volume_sharding
        return shard(a, sharding(mesh, shard_time))

    return Space(D, D_T, sharded_d_channel, sharded_dt_channel,
                 broadcast_map, over(grid_sum), over(grid_max),
                 over(grid_min), first_shard, place, tuple(global_shape))


def grid_precond_maps(mesh: Mesh, global_shape, shard_time: bool = True, *,
                      scheme: str = "hybrid", reg_z_over_reg: float = 1.0,
                      reg_time: float = 0.0, sigma_A_rows: float = 1.0,
                      fidelity_colsum=None, grouped: bool = False,
                      dtype=torch.float32):
    """``ops.operators.precond_maps`` of the whole volume on the grid:
    ``(sigma_D, tau)`` grids, each shard's maps built from its own place in
    the volume (a window of the shard and up to two planes a side, whose
    maps at the shard's voxels are the whole volume's), never cut from a
    whole-volume map, so that a grid of one process of several holds only
    its rows.  ``fidelity_colsum``: a grid of ``|A|^T 1`` shards, or None
    for the scalar ``sigma_A_rows``."""
    from ..ops.operators import precond_parts

    nz, nt = mesh_sizes(mesh, shard_time)
    check_divisible(global_shape, nz, nt)
    Nz, M = global_shape[0], global_shape[1]
    lz, lt = Nz // nz, M // nt
    rows = (mesh.local_rows() if mesh.process_count > 1 else range(nz))

    def window(start, n, length):
        lo, hi = max(0, start - 2), min(length, start + n + 2)
        return lo, hi, start - lo

    def maps(iz, it):
        z0, z1, cz = window(iz * lz, lz, Nz)
        t0, t1, ct = window(it * lt, lt, M)
        sig, col = precond_parts(
            (z1 - z0, t1 - t0) + tuple(global_shape[2:]), scheme,
            reg_z_over_reg, reg_time, grouped=grouped, dtype=dtype,
            device=mesh.device, table_dims=(Nz, M))
        return (sig[cz:cz + lz, :, ct:ct + lt].contiguous(),
                col[cz:cz + lz, ct:ct + lt].contiguous())

    parts = [[maps(iz, it) for it in range(nt)] if iz in rows else None
             for iz in range(nz)]
    sig, col = ([None if row is None else [part[k] for part in row]
                 for row in parts] for k in range(2))
    fid = (sigma_A_rows if fidelity_colsum is None else fidelity_colsum)

    def tau(c, f):
        den = c + f
        return 1.0 / torch.where(den > 0, den, 1.0)

    return sig, broadcast_map(tau, col, fid)


def sharded_tv_and_subgrad(mesh: Mesh, cfg: TVConfig, global_shape,
                           shard_time: bool = True, mask_static=None,
                           weight_time=None, return_grad_norms=False):
    """tv + subgradient on a sharded volume: local stencils + plane halos,
    the tv a sum of the shards' (``ops.tv.tv_and_subgrad``'s three norms;
    ``mask_static`` / ``weight_time`` planes as :func:`sharded_D`'s).
    ``fn(x_shards) -> (tv, G_shards)``, and the grid of per-voxel norms
    third with ``return_grad_norms`` (``ops.tv.tv_and_subgrad``'s
    conventions)."""
    tmul_of = _t_multiplier(cfg, global_shape, mask_static, weight_time)

    def norms(d):
        return tv_norm(d, "iso", return_array=True)[1]

    def fn(x):
        _check_grid(x, mesh, global_shape, shard_time)
        first = first_shard(x)
        tmul = tmul_of(first.dtype, first.device)
        D_img = _local_D(x, cfg, global_shape, tmul)
        parts = grid_map(lambda d: tv_norm(
            d, cfg.norm, return_array=True, huber_delta=cfg.huber_delta),
            D_img)
        tv = grid_sum(grid_map(lambda p: p[0], parts))
        if cfg.norm == "aniso":
            # the true subgradient D^T sign(D x), full weights
            G = _local_D_T(grid_map(torch.sign, D_img), cfg, global_shape,
                           tmul=tmul)
        elif cfg.norm == "huber":
            # the true smooth gradient D^T(D x / max(n, delta)), full weights
            Y = grid_map(lambda d: d / torch.clamp_min(
                norms(d), cfg.huber_delta)[:, None], D_img)
            G = _local_D_T(Y, cfg, global_shape, tmul=tmul)
        else:
            def unit(d):
                n = norms(d)
                return d / torch.where(n == 0, torch.inf, n)[:, None]

            G = _local_D_T(grid_map(unit, D_img), cfg, global_shape,
                           weighted=False)
        if not return_grad_norms:
            return tv, G
        if cfg.norm == "iso":
            return tv, G, grid_map(lambda p: torch.where(
                p[1] == 0, torch.inf, p[1]), parts)
        return tv, G, grid_map(lambda p: p[1], parts)

    return fn


def sharded_cp_step(mesh: Mesh, cfg: TVConfig, global_shape, *, reg, sigma_D,
                    sigma_A, tau, shard_time: bool = True,
                    fidelity: str = "l2", fidelity_weight: float = 1.0,
                    nonneg: bool = False, mask_static=None, weight_time=None):
    """One Chambolle-Pock iteration on grids of shards: ``solvers.cp.cp_step``
    on :func:`grid_space`, so the only exchange is the 1-plane halos inside
    D / D_T and one sum of scalars for the loss (the ``fidelity`` /
    ``nonneg`` family is pointwise, so it shards untouched: the weight must
    be a scalar; ``mask_static`` / ``weight_time`` planes as
    :func:`sharded_D`'s).  ``fn(x, y_A, y_D, x_noisy) -> (x, y_A, y_D,
    loss)``, ``y_D`` in the public layout
    (``parallel.mesh.shard_d_volume``)."""
    from ..solvers.cp import CPState, cp_step

    space = grid_space(mesh, cfg, global_shape, shard_time, mask_static,
                       weight_time)

    def fn(x, y_A, y_D, x_noisy):
        _check_grid(x, mesh, global_shape, shard_time)
        st, loss = cp_step(CPState(x, y_A, y_D), x_noisy, reg=reg,
                           sigma_D=sigma_D, sigma_A=sigma_A, tau=tau, cfg=cfg,
                           fidelity=fidelity, fidelity_weight=fidelity_weight,
                           nonneg=nonneg, space=space)
        return (*st, loss)

    return fn


def make_sharded_cp_solver(mesh: Mesh, cfg: TVConfig, global_shape, *, reg,
                           n_iter, sigma_D=0.5, sigma_A=1.0, tau=None,
                           shard_time: bool = True, fidelity: str = "l2",
                           fidelity_weight: float = 1.0,
                           nonneg: bool = False, mask_static=None,
                           weight_time=None):
    """``n_iter`` sharded CP steps:
    ``solve(x_noisy, x, y_A, y_D) -> (x, y_A, y_D, losses)`` on grids of
    shards made with ``parallel.mesh.shard_volume`` / ``shard_d_volume``;
    the loss history is one tensor on the mesh's device.  ``solve``'s
    optional ``each(i, loss)`` is called after every iteration."""
    from ..solvers.cp import default_tau
    from ..solvers.fidelity import validate_fidelity

    validate_fidelity(fidelity, torch.zeros(()), fidelity_weight)
    if tau is None:
        tau = default_tau(cfg, global_shape[0], global_shape[1], sigma_A)
    step = sharded_cp_step(mesh, cfg, global_shape, reg=reg, sigma_D=sigma_D,
                           sigma_A=sigma_A, tau=tau, shard_time=shard_time,
                           fidelity=fidelity, fidelity_weight=fidelity_weight,
                           nonneg=nonneg, mask_static=mask_static,
                           weight_time=weight_time)

    def solve(x_noisy, x, y_A, y_D, each=None):
        losses = []
        for i in range(n_iter):
            x, y_A, y_D, loss = step(x, y_A, y_D, x_noisy)
            losses.append(loss)
            if each is not None:
                each(i, loss)
        return x, y_A, y_D, torch.stack(losses)

    return solve
