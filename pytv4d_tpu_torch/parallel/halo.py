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
from .mesh import (
    Mesh,
    check_divisible,
    first_shard,
    grid_like,
    grid_map,
    grid_size,
    grid_sum,
    indexed,
    mesh_sizes,
    planes_from_left,
    planes_from_right,
)

__all__ = [
    "sharded_D",
    "sharded_D_T",
    "sharded_tv_and_subgrad",
    "sharded_cp_step",
    "make_sharded_cp_solver",
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


def _local_D(shards, cfg: TVConfig, global_shape):
    """D on every shard: ``(nz, Nd, m, Nr, Nc)`` per shard."""
    chans, norm = _table(cfg, global_shape)
    outs = []
    for ch in chans:
        d = sharded_d_channel(shards, ch.axis, ch.kind)
        w = channel_weight(ch, cfg.reg_z_over_reg, cfg.reg_time)
        outs.append(grid_map(lambda a: a * w, d) if w != 1.0 else d)

    def stack(*ds):
        D_img = torch.stack(ds, dim=1)
        return D_img * norm if norm != 1.0 else D_img

    return grid_map(stack, *outs)


def _local_D_T(ys, cfg: TVConfig, global_shape, weighted: bool = True):
    """D_T on every shard from public-layout shards ``(nz, Nd, m, Nr, Nc)``;
    ``weighted=False`` leaves the per-axis weights out, as the isotropic
    subgradient does (``ops.tv._subgrad_from_D``)."""
    chans, norm = _table(cfg, global_shape)
    out = None
    for i, ch in enumerate(chans):
        w = channel_weight(ch, cfg.reg_z_over_reg, cfg.reg_time)
        if weighted and w != 1.0:
            y = grid_map(lambda a: a[:, i] * w, ys)
        else:
            y = grid_map(lambda a: a[:, i], ys)
        contrib = sharded_dt_channel(y, ch.axis, ch.kind)
        out = contrib if out is None else grid_map(torch.add, out, contrib)
    return grid_map(lambda a: a * norm, out) if norm != 1.0 else out


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
              shard_time: bool = True):
    """Build ``D`` on a sharded volume: shards of x in, shards of
    ``(Nz, Nd, M, Nr, Nc)`` out (``parallel.mesh.gather_d_volume``)."""
    def fn(x):
        _check_grid(x, mesh, global_shape, shard_time)
        return _local_D(x, cfg, global_shape)

    return fn


def sharded_D_T(mesh: Mesh, cfg: TVConfig, global_shape,
                shard_time: bool = True):
    """Build ``D_T`` on a sharded difference volume
    (``parallel.mesh.shard_d_volume``): shards of x's layout out."""
    def fn(y):
        _check_grid(y, mesh, global_shape, shard_time, t_axis=2)
        return _local_D_T(y, cfg, global_shape)

    return fn


def sharded_tv_and_subgrad(mesh: Mesh, cfg: TVConfig, global_shape,
                           shard_time: bool = True):
    """tv + subgradient on a sharded volume: local stencils + plane halos,
    the tv a sum of the shards' (``ops.tv.tv_and_subgrad``'s three norms).
    ``fn(x_shards) -> (tv, G_shards)``."""
    def fn(x):
        _check_grid(x, mesh, global_shape, shard_time)
        D_img = _local_D(x, cfg, global_shape)
        tv = grid_sum(grid_map(
            lambda d: tv_norm(d, cfg.norm, huber_delta=cfg.huber_delta),
            D_img))
        if cfg.norm == "aniso":
            # the true subgradient D^T sign(D x), full weights
            return tv, _local_D_T(grid_map(torch.sign, D_img), cfg,
                                  global_shape)

        def norms(d):
            return tv_norm(d, "iso", return_array=True)[1]

        if cfg.norm == "huber":
            # the true smooth gradient D^T(D x / max(n, delta)), full weights
            Y = grid_map(lambda d: d / torch.clamp_min(
                norms(d), cfg.huber_delta)[:, None], D_img)
            return tv, _local_D_T(Y, cfg, global_shape)

        def unit(d):
            n = norms(d)
            return d / torch.where(n == 0, torch.inf, n)[:, None]

        return tv, _local_D_T(grid_map(unit, D_img), cfg, global_shape,
                              weighted=False)

    return fn


def sharded_cp_step(mesh: Mesh, cfg: TVConfig, global_shape, *, reg, sigma_D,
                    sigma_A, tau, shard_time: bool = True,
                    fidelity: str = "l2", fidelity_weight: float = 1.0,
                    nonneg: bool = False):
    """One Chambolle-Pock iteration on grids of shards: the only exchange is
    the 1-plane halos inside D / D_T and one sum of scalars for the loss
    (``solvers.cp.cp_step``; the ``fidelity`` / ``nonneg`` family is
    pointwise, so it shards untouched: the weight must be a scalar).
    ``fn(x, y_A, y_D, x_noisy) -> (x, y_A, y_D, loss)``, ``y_D`` in the
    public layout (``parallel.mesh.shard_d_volume``)."""
    from ..solvers.cp import dual_prox
    from ..solvers.fidelity import fidelity_dual_prox, fidelity_loss

    def fn(x, y_A, y_D, x_noisy):
        _check_grid(x, mesh, global_shape, shard_time)
        y_A = grid_map(lambda ya, xs, x0: fidelity_dual_prox(
            ya, xs, x0, sigma_A, fidelity, fidelity_weight), y_A, x, x_noisy)
        D_x = _local_D(x, cfg, global_shape)
        y_D = grid_map(lambda yd, d: dual_prox(
            yd + sigma_D * d, reg, cfg.norm, sigma_D, cfg.huber_delta),
            y_D, D_x)
        dty = _local_D_T(y_D, cfg, global_shape)

        def primal(xs, ya, dt):
            xs = xs - tau * ya - tau * dt
            return torch.clamp_min(xs, 0.0) if nonneg else xs

        x = grid_map(primal, x, y_A, dty)
        loss = grid_sum(grid_map(
            lambda xs, x0, d: fidelity_loss(xs, x0, fidelity, fidelity_weight)
            + reg * tv_norm(d, cfg.norm, huber_delta=cfg.huber_delta),
            x, x_noisy, D_x))
        return x, y_A, y_D, loss

    return fn


def make_sharded_cp_solver(mesh: Mesh, cfg: TVConfig, global_shape, *, reg,
                           n_iter, sigma_D=0.5, sigma_A=1.0, tau=None,
                           shard_time: bool = True, fidelity: str = "l2",
                           fidelity_weight: float = 1.0,
                           nonneg: bool = False):
    """``n_iter`` sharded CP steps:
    ``solve(x_noisy, x, y_A, y_D) -> (x, y_A, y_D, losses)`` on grids of
    shards made with ``parallel.mesh.shard_volume`` / ``shard_d_volume``;
    the loss history is one tensor on the mesh's device."""
    from ..solvers.cp import default_tau
    from ..solvers.fidelity import validate_fidelity

    validate_fidelity(fidelity, torch.zeros(()), fidelity_weight)
    if tau is None:
        tau = default_tau(cfg, global_shape[0], global_shape[1], sigma_A)
    step = sharded_cp_step(mesh, cfg, global_shape, reg=reg, sigma_D=sigma_D,
                           sigma_A=sigma_A, tau=tau, shard_time=shard_time,
                           fidelity=fidelity, fidelity_weight=fidelity_weight,
                           nonneg=nonneg)

    def solve(x_noisy, x, y_A, y_D):
        losses = []
        for _ in range(n_iter):
            x, y_A, y_D, loss = step(x, y_A, y_D, x_noisy)
            losses.append(loss)
        return x, y_A, y_D, torch.stack(losses)

    return solve
