"""Sharded TGV-2 over the (z, t) mesh.

The port of ``pytv4d_tpu/parallel/tgv_sharded.py``.

``axes='2d'`` TGV (``solvers.tgv``) couples pixels only within a
(N_row, N_col) slice, so the volume shards over (z, t) with no exchange at
all: each shard solves its slices on its own (the same per-slice problem as
the unsharded solve, so the same iterates) and the only sum over shards is
the separable objective's.  On a CUDA device each shard is one launch of the
whole-solve kernel B7 (``kernels.tgv_resident``).

``axes='3d'`` / ``'4d'`` couple z (and t) across shard edges:
:func:`make_sharded_tgv_stream_solver` runs the streaming kernels B6
(``kernels.tgv_stream``: passes PQ and XW) shard by shard with ghost-plane
halos, on a mesh that does not cut time for ``'4d'``.  Every neighbour
plane comes through ``parallel.mesh``'s ``planes_from_left`` /
``planes_from_right``.

:func:`tgv_denoise_grid` is ``solvers.tgv_denoise`` of a grid: it picks
between these two and ``solvers.tgv.run_plain``, the plain loop, on
``parallel.halo.grid_space`` (a grid of any cut, one plane exchanged per
cut axis).
"""

from __future__ import annotations

import torch

from .halo import _check_grid, grid_space
from .mesh import (
    T_AXIS,
    Z_AXIS,
    first_shard,
    grid_like,
    grid_map,
    grid_mesh,
    grid_sum,
    indexed,
    mesh_sizes,
    planes_from_left,
    planes_from_right,
)


def tgv_denoise_sharded(
    x,
    mesh,
    n_iter: int = 300,
    alpha1: float = 25.0,
    alpha0: float = 50.0,
    sigma_tau_split: float = 1.0,
    compute_loss: bool = True,
    fused: bool = None,
    shard_time: bool = True,
    norm: str = "iso",
    huber_delta: float = 1.0,
    loss_every: int = 0,
    state=None,
):
    """``axes='2d'`` TGV-2 denoising of a grid of shards on ``mesh``.

    ``x`` is placed with ``parallel.mesh.shard_volume``; returns a
    ``TGVResult`` whose ``x`` is a grid of the same layout, whose ``w``
    is a grid of ``(Nz, 2, M, Nr, Nc)`` shards
    (``parallel.mesh.shard_d_volume``'s layout) and whose ``state`` is a
    ``TGVState`` of such grids.  ``fused``, ``loss_every`` and ``state``
    (a ``TGVState`` of grids) follow ``solvers.tgv.tgv_denoise``, shard by
    shard (None: the kernel for a CUDA shard).  The loss history is the
    sum of the shards' in (iz, it) order (none with ``compute_loss=False``
    and no ``loss_every``)."""
    from ..solvers.tgv import TGVResult, TGVState, tgv_denoise

    if mesh.shape[T_AXIS] == 1:  # pure-z mesh: nothing to shard over t
        shard_time = False
    nz, nt = mesh_sizes(mesh, shard_time)
    local = first_shard(x).shape
    _check_grid(x, mesh, (local[0] * nz, local[1] * nt) + tuple(local[2:]),
                shard_time)
    states = (grid_map(lambda xs: None, x) if state is None
              else grid_map(lambda *f: TGVState(*f), *state))
    res = grid_map(lambda xs, st: tgv_denoise(
        xs, n_iter=n_iter, alpha1=alpha1, alpha0=alpha0,
        sigma_tau_split=sigma_tau_split, axes="2d",
        compute_loss=compute_loss, fused=fused, norm=norm,
        huber_delta=huber_delta, loss_every=loss_every, state=st),
        x, states)
    loss = (grid_sum(grid_map(lambda r: r.loss, res))
            if compute_loss or loss_every else indexed(res)[0][2].loss)
    st = TGVState(*(grid_map(lambda r, i=i: r.state[i], res)
                    for i in range(len(TGVState._fields))))
    return TGVResult(x=st.x, w=st.w, loss=loss, state=st)


def _z_halo_lo(grid, ghost: str):
    """Every shard's exchanged LOW boundary plane along axis 0 (the left
    neighbour's last plane: the z-1 value at the shard's low edge).
    ``ghost`` chooses the global-boundary substitute: 'edge' (the edge plane
    itself, which makes the one-sided difference there exactly zero) or
    'zero' (the exchange's zeros, right for a dual whose coefficient at the
    global boundary is zero)."""
    lo = planes_from_left(grid, 0)
    if ghost == "edge":
        for iz, it, a in indexed(grid):
            if iz == 0:
                lo[iz][it] = a[:1]
    return lo


def _z_halo_hi(grid, ghost: str):
    """HIGH-side counterpart of :func:`_z_halo_lo` (the right neighbour's
    first plane: the z+1 value at the shard's high edge)."""
    hi = planes_from_right(grid, 0)
    if ghost == "edge":
        for iz, it, a in indexed(grid):
            if iz == len(grid) - 1:
                hi[iz][it] = a[-1:]
    return hi


def _extend_z(grid, ghost_lo: str, ghost_hi: str):
    """One exchanged halo plane per side along axis 0 (ghosts as in
    :func:`_z_halo_lo`), concatenated onto every shard."""
    return grid_map(lambda lo, a, hi: torch.cat([lo, a, hi]),
                    _z_halo_lo(grid, ghost_lo), grid,
                    _z_halo_hi(grid, ghost_hi))


def _pad_z(a):
    """``a`` with a zero plane on each side along axis 0 (each element
    written once)."""
    out = a.new_empty((a.shape[0] + 2,) + tuple(a.shape[1:]))
    out[0].zero_()
    out[-1].zero_()
    out[1:-1] = a
    return out


def _win_lo(a, lo=None):
    """The 3-plane window around the low edge: [halo or zeros, plane 0, 1].
    The zeros fill slots the kept (middle) output never reads."""
    pad = torch.zeros_like(a[:1]) if lo is None else lo
    return torch.cat([pad, a[:2]])


def _win_hi(a, hi=None):
    """The 3-plane window around the high edge: [L-2, L-1, halo or zeros]."""
    pad = torch.zeros_like(a[:1]) if hi is None else hi
    return torch.cat([a[-2:], pad])


def _merge(full, lo3, hi3):
    """The edge planes of ``full`` (whose own edge outputs used gated reads)
    replaced in place by the windows' middle slots."""
    full[:1] = lo3[1:2]
    full[-1:] = hi3[1:2]
    return full


def make_sharded_tgv_stream_solver(
    mesh,
    global_shape,
    axes: str = "4d",
    *,
    alpha1: float,
    alpha0: float,
    n_iter: int,
    sigma_tau_split: float = 1.0,
    dtype: str = "float32",
    shard_time: bool = True,
    norm: str = "iso",
    huber_delta: float = 1.0,
    overlap: bool = False,
    loss_every: int = 0,
):
    """Sharded coupled TGV-2 (``axes='3d'`` / ``'4d'``): the streaming
    kernels shard by shard over a z-sharded mesh, with ghost-plane halos.

    Per iteration: exchange one xb / wb boundary plane, run pass PQ on the
    halo-extended block, exchange the new duals' boundary planes, run pass
    XW, then apply the two global-edge corrections the extended kernels
    cannot see (their z gates fire at ghost planes, which are dropped): the
    last global plane's D^T must not include the z dual's own-slot term,
    and the first global plane's E^T must not include the z-adjoint
    own-slot terms.

    ``overlap=True`` (requires z sharded with >= 3 local planes): each pass
    takes its boundary planes FIRST, then runs the kernel on the unextended
    block, whose interior planes need no halo, and recomputes the two edge
    planes with 3-plane window calls (middle slot = the true edge plane, so
    no gate fires there).  The same numbers, at about (L+6)/(L+2) the plane
    work of the ghost path for L local planes; worth it when the exchange
    is a transfer between cards, so the ghost path stays the default.

    ``'3d'`` does not couple time, so the mesh may shard t too; ``'4d'``
    requires t unsharded.  Returns ``solve(x0, state=None) -> TGVResult``,
    ``x0`` a grid from ``parallel.mesh.shard_volume``, ``x`` a grid of the
    same layout, ``w`` a grid of ``(Nz, n, M, Nr, Nc)`` shards and
    ``state`` a ``solvers.tgv.TGVState`` of grids, which ``state``
    resumes from.  The loss is empty (the streaming kernels fuse no loss)
    unless ``loss_every=k`` samples the objective, a sum over shards,
    after every k-th iteration.  On a CUDA device every pass launches its
    kernel or raises; on the CPU it runs the kernel's plain version."""
    from ..kernels.dispatch import as_dtype
    from ..kernels.tgv_stream import tgv_pq, tgv_xw
    from ..solvers.tgv import (
        MODE_AXES,
        TGVResult,
        TGVState,
        _init_state,
        _q_pairs,
        loss_dtype,
        tgv_objective,
        tgv_steps,
    )

    if axes not in ("3d", "4d"):
        raise ValueError(
            f"make_sharded_tgv_stream_solver is for the coupled modes "
            f"('3d'/'4d'); axes='2d' shards with zero communication via "
            f"tgv_denoise_sharded — got {axes!r}"
        )
    if Z_AXIS not in mesh.shape:
        raise ValueError(
            f"mesh must have a '{Z_AXIS}' axis (parallel.mesh.make_mesh); "
            f"got axes {tuple(mesh.shape)}"
        )
    nz, nt = mesh_sizes(mesh, shard_time)
    if axes == "4d" and nt > 1:
        raise ValueError(
            "axes='4d' couples time across shards; use a z-only mesh "
            "(shard_time=False or t=1)"
        )
    Nz_g, M_g, Nr, Nc = global_shape
    if Nz_g % nz or M_g % nt:
        raise ValueError(
            f"global shape {tuple(global_shape)} not divisible by mesh "
            f"(z={nz}, t={nt})"
        )
    local = (Nz_g // nz, M_g // nt, Nr, Nc)
    overlap = bool(overlap)
    if overlap and (nz == 1 or local[0] < 3):
        raise ValueError(
            "overlap=True requires a z-sharded mesh and >= 3 local z "
            "planes (the interior must be nonempty while the halo "
            "exchange is in flight)"
        )
    if norm not in ("iso", "aniso", "huber"):
        raise ValueError(f"norm must be 'iso', 'aniso' or 'huber', got "
                         f"{norm!r}")
    if loss_every and (loss_every < 0 or n_iter % loss_every):
        raise ValueError(
            f"loss_every must be a positive divisor of n_iter, got "
            f"loss_every={loss_every} with n_iter={n_iter}")

    dt = as_dtype(dtype)
    _, tau = tgv_steps(axes, sigma_tau_split)
    pq_kw = dict(mode=axes, alpha1=float(alpha1), alpha0=float(alpha0),
                 sigma_tau_split=float(sigma_tau_split), norm=norm,
                 huber_delta=float(huber_delta))
    xw_kw = dict(mode=axes, sigma_tau_split=float(sigma_tau_split))
    n = len(MODE_AXES[axes])
    pairs = _q_pairs(n)
    # z is field / axis 0 in both coupled modes
    q_zz_chan = pairs.index((0, 0))
    q_z_off = [(c, j) for c, (i, j) in enumerate(pairs) if i == 0 and j != 0]

    def edge_corrections(iz, x2, xb2, w2, wb2, p2, q2):
        """The global-edge fixes both paths share, in place (the kernels'
        own-slot z gates never fire at the true global edge planes): the
        last global plane's D^T must not include -p_z[L-1]; the first
        global plane's E^T must not include the z-adjoint own-slot terms
        q_zz (field z) and 0.5 q_zj (field j)."""
        if iz == nz - 1:
            corr_x = (tau / (1.0 + tau)) * p2[-1:, 0]
            x2[-1:] -= corr_x
            xb2[-1:] -= 2.0 * corr_x
        if iz == 0:
            extra = [torch.zeros_like(w2[:1, 0]) for _ in range(n)]
            extra[0] = q2[:1, q_zz_chan]
            for c, j in q_z_off:
                extra[j] = extra[j] + 0.5 * q2[:1, c]
            corr_w = tau * torch.stack(extra, dim=1)
            w2[:1] += corr_w
            wb2[:1] += 2.0 * corr_w

    def ghost_step(x, xb, w, wb, p, q, x0_pad):
        # pass PQ on the halo-extended block: edge ghosts make the one-sided
        # z differences exactly zero at the global boundary, so the global
        # stencil is reproduced with no gate of the kernel's own
        pq_ext = grid_map(lambda xe, we, pe, qe: tgv_pq(xe, we, pe, qe,
                                                        **pq_kw),
                          _extend_z(xb, "zero", "edge"),
                          _extend_z(wb, "edge", "zero"),
                          grid_map(_pad_z, p), grid_map(_pad_z, q))
        p2 = grid_map(lambda r: r[0][1:-1], pq_ext)
        q2 = grid_map(lambda r: r[1][1:-1], pq_ext)
        # pass XW: the adjoints read the NEW duals' neighbour planes; zero
        # ghosts at the global boundary are exactly the zero coefficients
        xw_ext = grid_map(lambda xs, x0p, pe, ws, qe: tgv_xw(
            _pad_z(xs), x0p, pe, _pad_z(ws), qe, **xw_kw),
            x, x0_pad, _extend_z(p2, "zero", "zero"), w,
            _extend_z(q2, "zero", "zero"))
        out = []
        for iz, it, r in indexed(xw_ext):
            x2, xb2, w2, wb2 = (a[1:-1] for a in r)
            edge_corrections(iz, x2, xb2, w2, wb2, p2[iz][it], q2[iz][it])
            out.append((x2, xb2, w2, wb2))
        cells = grid_like(x, out)
        return (*(grid_map(lambda c, i=i: c[i], cells) for i in range(4)),
                p2, q2)

    def overlap_step(x, xb, w, wb, p, q, x0_pad):
        # take the boundary planes FIRST: the full kernel's interior planes
        # do not depend on them.  Only the planes the kept window slots read
        # are exchanged: pass PQ is forward in xb (xb[z+1] at the high
        # edge) and backward in wb (wb[z-1] at the low edge)
        xb_hi = _z_halo_hi(xb, "edge")
        wb_lo = _z_halo_lo(wb, "edge")
        for iz, it, _ in indexed(x):
            xs, xbs, ws, wbs, ps, qs = (g[iz][it] for g in (x, xb, w, wb, p,
                                                            q))
            # the windows before the full call: the full call updates p and
            # q in place, and the windows must read their old values
            p_lo3, q_lo3 = tgv_pq(_win_lo(xbs), _win_lo(wbs, wb_lo[iz][it]),
                                  _win_lo(ps), _win_lo(qs), **pq_kw)
            p_hi3, q_hi3 = tgv_pq(_win_hi(xbs, xb_hi[iz][it]), _win_hi(wbs),
                                  _win_hi(ps), _win_hi(qs), **pq_kw)
            tgv_pq(xbs, wbs, ps, qs, **pq_kw)
            _merge(ps, p_lo3, p_hi3)
            _merge(qs, q_lo3, q_hi3)
        # pass XW's adjoints read the NEW duals' neighbours: p[z-1] at the
        # low edge, q[z+1] at the high (zero ghosts at the global boundary)
        p_lo = _z_halo_lo(p, "zero")
        q_hi = _z_halo_hi(q, "zero")
        for iz, it, _ in indexed(x):
            xs, xbs, ws, wbs, ps, qs = (g[iz][it] for g in (x, xb, w, wb, p,
                                                            q))
            x0s = x0_pad[iz][it][1:-1]
            lo3 = tgv_xw(_win_lo(xs), _win_lo(x0s), _win_lo(ps, p_lo[iz][it]),
                         _win_lo(ws), _win_lo(qs), **xw_kw)
            hi3 = tgv_xw(_win_hi(xs), _win_hi(x0s), _win_hi(ps), _win_hi(ws),
                         _win_hi(qs, q_hi[iz][it]), **xw_kw)
            full = tgv_xw(xs, x0s, ps, ws, qs, xbs, wbs, **xw_kw)
            for f, lo, hi in zip(full, lo3, hi3):
                _merge(f, lo, hi)
            edge_corrections(iz, xs, xbs, ws, wbs, ps, qs)
        return x, xb, w, wb, p, q

    step = overlap_step if overlap else ghost_step
    space = grid_space(mesh, None, global_shape, shard_time)

    def solve(x0, state=None):
        _check_grid(x0, mesh, global_shape, shard_time)
        x0_pad = grid_map(lambda a: _pad_z(a.to(dt)), x0)
        x0_dt = grid_map(lambda a: a[1:-1], x0_pad)
        if state is None:
            st = _init_state(x0_dt, axes, space)
        else:  # the overlapped step updates its state in place: copies
            st = TGVState(*(grid_map(lambda a: a.to(dt).clone(
                memory_format=torch.contiguous_format), g) for g in state))
        x, xb, w, wb, p, q = st
        losses = torch.empty(n_iter // loss_every if loss_every else 0,
                             dtype=loss_dtype(dt),
                             device=first_shard(x0_dt).device)
        for i in range(n_iter):
            x, xb, w, wb, p, q = step(x, xb, w, wb, p, q, x0_pad)
            if loss_every and (i + 1) % loss_every == 0:
                losses[i // loss_every] = tgv_objective(
                    x, w, x0_dt, axes, alpha1, alpha0, norm, huber_delta,
                    space)
        return TGVResult(x=x, w=w, loss=losses,
                         state=TGVState(x, xb, w, wb, p, q))

    solve.overlap = overlap
    return solve


def tgv_denoise_grid(x_noisy, *, n_iter, alpha1, alpha0, sigma_tau_split,
                     axes, compute_loss, fused, loss_every, state, norm,
                     huber_delta):
    """``solvers.tgv_denoise`` of a volume grid.  ``'2d'`` goes to
    :func:`tgv_denoise_sharded` (B7 a shard on the card).  ``'3d'``, and
    ``'4d'`` on a grid that does not cut time, take the path the shard's
    shape takes on a volume (``solvers.tgv._select_path``): the streaming
    kernels through :func:`make_sharded_tgv_stream_solver` (a per-
    iteration loss is its objective sampled every iteration, a sum over
    shards), or ``solvers.tgv.run_plain`` on the grid.  ``'4d'`` on a grid
    that cuts
    time couples the cut axis inside the streaming kernels' step, which
    the sharded solver does not exchange: it takes the plain loop on every
    device, and ``fused=True`` raises.  ``state`` is a ``TGVState`` of
    grids."""
    from ..solvers.tgv import _select_path, run_plain

    lay = grid_mesh(x_noisy)
    kw = dict(n_iter=n_iter, alpha1=alpha1, alpha0=alpha0,
              sigma_tau_split=sigma_tau_split, norm=norm,
              huber_delta=huber_delta)
    if axes == "2d":
        return tgv_denoise_sharded(
            x_noisy, lay.mesh, compute_loss=compute_loss, fused=fused,
            shard_time=lay.shard_time, loss_every=loss_every, state=state,
            **kw)
    first = first_shard(x_noisy)
    if axes == "4d" and lay.shard_time:
        if fused:
            raise ValueError(
                "fused=True cannot serve axes='4d' on a grid that cuts "
                "time: the sharded streaming solver exchanges z planes "
                "only; cut z alone (parallel.mesh.shard_volume(..., "
                "shard_time=False)) or leave fused=None for the plain loop")
        path = "plain"
    else:
        path = _select_path(tuple(first.shape), first.dtype, axes, n_iter,
                            compute_loss, fused, loss_every,
                            state is not None, first.is_cuda)
    if path == "stream":
        # the per-iteration loss is the objective sampled every iteration
        solve = make_sharded_tgv_stream_solver(
            lay.mesh, lay.shape, axes, dtype=first.dtype,
            shard_time=lay.shard_time,
            loss_every=loss_every or int(bool(compute_loss)), **kw)
        return solve(x_noisy, state)
    return run_plain(x_noisy, state, axes=axes, compute_loss=compute_loss,
                     loss_every=loss_every,
                     space=grid_space(lay.mesh, None, lay.shape,
                                      lay.shard_time), **kw)
