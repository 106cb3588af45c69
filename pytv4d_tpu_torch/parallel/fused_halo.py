"""Sharded fused CP and GD: the fused kernels running shard by shard over
the (z, t) grid.

The port of ``pytv4d_tpu/parallel/fused_halo.py``.  Halo strategy ("ghost
planes"): before each fused pass, one boundary plane per direction comes
from the neighbour shard (``parallel.mesh.planes_from_left`` /
``planes_from_right``); shards at the *global* boundary substitute a ghost
plane chosen so that the ungated stencil reproduces the reference's
one-sided zero boundary exactly:

- FWD/BWD channels (upwind/downwind/hybrid): ghost = edge plane
  (``d = ghost - edge = 0`` at the invalid slot);
- CTR channels (central): ghost = reflected plane (``d = x[1] - ghost = 0``).

The kernels then run with z/t gating off (``halo_mode=True`` in
``kernels.fused``) on the extended array.  The adjoint pass uses zero halos
and relies on the CP invariant that dual variables are zero at globally
invalid slots (kept by the forward pass and the zero initialisation): this
module is a *solver* internal, not a general sharded D_T (use
``parallel.halo`` for that).

The overlapped step (``overlap=True``, z-only meshes) takes the exchanged
planes first, runs both passes on the planes of each shard that need no
neighbour (``interior=True``) and redoes the two edge planes with the
boundary kernels (``kernels.fused.cp_dual_boundary`` /
``cp_primal_boundary``).  The exchange can run on a second CUDA stream,
so that its copies run beside the interior kernels (``solve.side_stream``);
between shards of one card the copies are too small for that to show, so it
is off until an exchange is a transfer between cards.

The shards of one process share its device; a step is a Python loop over
the grid, pass by pass.  On a CUDA device every pass launches its kernel or raises; on the CPU
it runs the kernel's plain version.
"""

from __future__ import annotations

import torch

from ..core.config import TVConfig
from ..core.schemes import AXIS_T, AXIS_Z, CTR, scheme_channels
from ..ops.operators import _sl
from .halo import _check_grid, grid_space
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


def _axis_ghost_kind(chans, axis):
    """'reflect' when the axis carries a CTR channel, else 'edge' (the
    central scheme's small-axis fallback makes this per-axis uniform)."""
    kinds = {ch.kind for ch in chans if ch.axis == axis}
    if not kinds:
        return "edge"
    return "reflect" if CTR in kinds else "edge"


def _halo_pairs(shards, axis, ghost_kind):
    """For every shard the planes below and above it along ``axis``: the
    neighbours' edge planes, and at the grid's ends the ghost plane
    (``ghost_kind='zero'`` keeps the exchange's zeros, for duals).  Two
    grids, ``(lo, hi)``."""
    n = grid_size(shards, axis)
    lo_g = planes_from_left(shards, axis)
    hi_g = planes_from_right(shards, axis)
    if ghost_kind == "zero":
        return lo_g, hi_g
    for iz, it, x in indexed(shards):
        nd = x.ndim
        idx = (iz, it)[axis]
        lo, hi = lo_g[iz][it], hi_g[iz][it]
        L = x.shape[axis]
        if ghost_kind == "edge":
            g_lo = x[_sl(nd, axis, 0, 1)]
            g_hi = x[_sl(nd, axis, -1, None)]
        else:  # reflect: globally x[1] / x[L-2]; with a 1-plane shard those
            # live on the neighbour, which is exactly the exchanged halo
            g_lo = x[_sl(nd, axis, 1, 2)] if L > 1 else hi
            g_hi = x[_sl(nd, axis, -2, -1)] if L > 1 else lo
        if idx == 0:
            lo_g[iz][it] = g_lo
        if idx == n - 1:
            hi_g[iz][it] = g_hi
    return lo_g, hi_g


def _extend_axis(shards, axis, ghost_kind):
    """Every shard with one halo plane per side along ``axis``; boundary
    shards substitute the ghost plane."""
    lo, hi = _halo_pairs(shards, axis, ghost_kind)
    return grid_map(lambda lo, x, hi: torch.cat([lo, x, hi], dim=axis),
                    lo, shards, hi)


def _halo_planes(shards, axis, ghost_kind):
    """For every shard the two exchanged boundary planes along ``axis``,
    stacked: slot 0 = the plane from the LEFT neighbour (the z-1 value at
    the shard's low edge), slot 1 = from the RIGHT; ghosts as in
    :func:`_extend_axis`.  The overlapped step takes this BEFORE the
    interior kernels so that the copies ride beside them."""
    lo, hi = _halo_pairs(shards, axis, ghost_kind)
    return grid_map(lambda lo, hi: torch.cat([lo, hi], dim=axis), lo, hi)


def _kind_range(chans, want_axis, kinds):
    """[lo, hi) channel range of ``want_axis`` channels whose kind is in
    ``kinds`` (scheme tables keep them contiguous; checked)."""
    idx = [i for i, ch in enumerate(chans)
           if ch.axis == want_axis and ch.kind in kinds]
    if not idx:
        return 0, 0
    lo, hi = idx[0], idx[-1] + 1
    if idx != list(range(lo, hi)):
        raise AssertionError(f"channels {idx} of axis {want_axis} are not "
                             f"contiguous")
    return lo, hi


def _sparse_channel_halo(ys, axis, chans, want_axis):
    """Dual-variable halo along ``axis`` of internal-layout shards
    ``(nz, m, Nd, Nr, Nc)``, exchanging ONLY the channels the primal pass's
    D^T stencil reads from each neighbour: a channel crosses an edge only if
    it DIFFERENTIATES along that axis, and then only in ONE direction:
    ``fwd`` kinds (D^T at z needs y[z-1]) come from the LEFT neighbour,
    ``bwd`` kinds (needs y[z+1]) from the RIGHT, ``ctr`` from both.  Each
    exchanged block is embedded in a zero-filled full-channel plane, so the
    kernels' halo interface does not change; returns per shard the two
    planes concatenated along ``axis`` ([left, right], the
    :func:`_halo_planes` order).  The ghost kind of a dual is always 'zero':
    at the global boundary the exchange's zeros stay."""
    lo_f, hi_f = _kind_range(chans, want_axis, ("fwd", "ctr"))
    lo_b, hi_b = _kind_range(chans, want_axis, ("bwd", "ctr"))
    from_l = (planes_from_left(grid_map(lambda y: y[:, :, lo_f:hi_f], ys),
                               axis) if hi_f > lo_f else None)
    from_r = (planes_from_right(grid_map(lambda y: y[:, :, lo_b:hi_b], ys),
                                axis) if hi_b > lo_b else None)

    def halo(iz, it, y):
        shape = list(y.shape)
        shape[axis] = 2
        out = torch.zeros(shape, dtype=y.dtype, device=y.device)
        if from_l is not None:
            out[_sl(5, axis, 0, 1)][:, :, lo_f:hi_f] = from_l[iz][it]
        if from_r is not None:
            out[_sl(5, axis, 1, 2)][:, :, lo_b:hi_b] = from_r[iz][it]
        return out

    return grid_like(ys, [halo(*cell) for cell in indexed(ys)])


def _extend_dual(ys, chans):
    """Every internal-layout dual shard with zero halos per side in z and t
    that carry only the channels differentiating along that axis.  What
    concatenating the z halo stack and then the t halo stack of the
    z-extended shards gives (the corners stay zero: a z halo holds no t
    channel), written into one buffer so that the dual is copied once."""
    hz = _sparse_channel_halo(ys, 0, chans, AXIS_Z)
    ht = _sparse_channel_halo(ys, 1, chans, AXIS_T)

    def ext(y, hz, ht):
        nz, m = y.shape[:2]
        out = torch.empty((nz + 2, m + 2) + tuple(y.shape[2:]), dtype=y.dtype,
                          device=y.device)
        out[1:-1, 1:-1] = y
        out[0::nz + 1, 1:-1] = hz
        out[1:-1, 0::m + 1] = ht
        out[0::nz + 1, 0::m + 1] = 0
        return out

    return grid_map(ext, ys, hz, ht)


def _setup(mesh, cfg, global_shape, shard_time, dtype, mask_static,
           weight_time):
    """What both fused solvers derive from their arguments: the mesh's
    sizes, the storage dtype, the GLOBAL channel table and the time
    multiplier plane on the mesh's device."""
    from ..kernels.dispatch import as_dtype, t_plane_multiplier

    dtype = as_dtype(dtype)
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"dtype must be float32 or bfloat16, got {dtype}")
    nz, nt = mesh_sizes(mesh, shard_time)
    check_divisible(global_shape, nz, nt)
    # channel table from GLOBAL dims: a 2-plane shard of a central-scheme
    # volume must keep its CTR channels
    chans, _ = scheme_channels(cfg.scheme, global_shape[0], global_shape[1],
                               cfg.reg_z_over_reg, cfg.reg_time)
    tmul = t_plane_multiplier(tuple(global_shape), cfg, mask_static,
                              weight_time, dtype=dtype, device=mesh.device)
    if tmul is not None:
        tmul = tmul.float().contiguous()
    return nz, nt, dtype, chans, tmul


def _check_state(grid, name, dtype, mesh):
    for _, _, s in indexed(grid):
        if s.dtype != dtype or s.device.type != mesh.device.type:
            raise ValueError(f"{name} shards must be {dtype} on "
                             f"{mesh.device}, got {s.dtype} on {s.device}")


def _on_side_stream(side, fn):
    """``fn()`` on the CUDA stream ``side`` after the work queued on the
    current stream so far; the current stream waits for it in turn when
    ``wait()`` is called.  With ``side`` None it simply runs now.

    What ``fn`` allocates belongs to ``side`` and is read on the current
    stream.  That is safe without ``record_stream``: the memory can only be
    handed out again to a later burst on ``side``, and every burst starts by
    waiting for the current stream, hence for those reads."""
    if side is None:
        return fn(), lambda: None
    main = torch.cuda.current_stream(side.device)
    side.wait_stream(main)
    with torch.cuda.stream(side):
        out = fn()
    return out, lambda: main.wait_stream(side)


def make_sharded_cp_solver_fused(
    mesh: Mesh,
    cfg: TVConfig,
    global_shape,
    *,
    reg,
    n_iter,
    sigma_D=0.5,
    sigma_A=1.0,
    tau=None,
    shard_time: bool = True,
    dual_dtype=None,
    dtype="float32",
    mask_static=None,
    weight_time=None,
    overlap: bool = None,
    fidelity: str = "l2",
    fidelity_weight: float = 1.0,
    nonneg: bool = False,
):
    """``n_iter`` fused CP steps on a sharded volume.

    Same call convention as ``parallel.halo.make_sharded_cp_solver``, but
    each shard runs the fused kernels; y_D rides in the kernels' internal
    channel-contiguous layout ``(Nz, M, Nd, Nr, Nc)`` (shard it with
    ``parallel.mesh.shard_volume``) and optionally bf16:
    ``solve(x_noisy, x, y_A, y_D_int) -> (x, y_A, y_D_int, losses)`` on
    grids of shards.  The inputs are not modified.  Channel gating uses the
    GLOBAL Nz / M.

    ``dtype``: storage dtype of x / y_A / x_noisy ('float32' or 'bfloat16';
    the kernels always COMPUTE in f32, as on the unsharded path); the caller
    passes state shards already in this dtype.  ``dual_dtype`` defaults to
    ``dtype``.

    ``mask_static`` / ``weight_time``: plane-shaped ``(1, 1, N, N)`` per the
    reference contract; the (N_row, N_col) multiplier plane is shared by
    every shard (the mesh cuts z and t only).

    ``overlap``: the interior / boundary step (module docstring); by default
    taken when only z is sharded, the scheme has z channels and every shard
    has at least 3 planes.

    ``fidelity`` / ``fidelity_weight`` (scalar) / ``nonneg``: the data-term
    family of ``solvers.chambolle_pock``; 'l1' and 'kl' (x_noisy >= 0) ride
    the sharded kernels too (the fidelity update and loss are pointwise).
    """
    from ..kernels.dispatch import as_dtype
    from ..kernels.fused import (
        cp_dual,
        cp_dual_boundary,
        cp_primal,
        cp_primal_boundary,
    )
    from ..solvers.cp import default_tau
    from ..solvers.fidelity import validate_fidelity

    validate_fidelity(fidelity, torch.zeros(()), fidelity_weight)
    fid_kw = dict(fidelity=fidelity, fid_weight=float(fidelity_weight))
    if tau is None:
        tau = default_tau(cfg, global_shape[0], global_shape[1], sigma_A)
    nz, nt, dtype, chans, tmul = _setup(mesh, cfg, global_shape, shard_time,
                                        dtype, mask_static, weight_time)
    dual_dtype = dtype if dual_dtype is None else as_dtype(dual_dtype)
    table_dims = (global_shape[0], global_shape[1])
    nz_local = global_shape[0] // nz
    t_sharded = nt > 1
    need_z = any(ch.axis == AXIS_Z for ch in chans)
    ghost_z = _axis_ghost_kind(chans, AXIS_Z)
    ghost_t = _axis_ghost_kind(chans, AXIS_T)

    # halo / compute overlap: eligible when only z is sharded and each shard
    # has interior planes to compute while the boundary planes travel
    if overlap is None:
        overlap = nz > 1 and not t_sharded and nz_local >= 3 and need_z
    if overlap and (t_sharded or nz_local < 3 or not need_z):
        raise ValueError(
            "overlap=True requires a z-sharded mesh (t unsharded), z "
            "channels, and >= 3 local z planes"
        )

    dual_kw = dict(cfg=cfg, sigma_D=sigma_D, sigma_A=sigma_A, reg=reg,
                   table_dims=table_dims, **fid_kw)
    primal_kw = dict(cfg=cfg, tau=tau, nonneg=nonneg, table_dims=table_dims,
                     **fid_kw)

    def shard_loss(fid, tv):
        return torch.add(torch.sum(fid), torch.sum(tv), alpha=reg)

    def ghost_step(x, y_A, y_D, x_noisy):
        mode = dict(halo_mode=True, t_sharded=t_sharded)
        x_ext = _extend_axis(_extend_axis(x, 0, ghost_z), 1, ghost_t)
        tv = grid_map(lambda xe, x0, ya, yd: cp_dual(
            xe, x0, ya, yd, tmul, **mode, **dual_kw)[2],
            x_ext, x_noisy, y_A, y_D)
        y_ext = _extend_dual(y_D, chans)
        fid = grid_map(lambda xs, x0, ya, yd, ye: cp_primal(
            xs, x0, ya, yd, tmul, y_ext=ye, **mode, **primal_kw)[1],
            x, x_noisy, y_A, y_D, y_ext)
        return grid_sum(grid_map(shard_loss, fid, tv))

    def overlap_step(x, y_A, y_D, x_noisy):
        side = _side_stream()
        # the exchange comes FIRST: the interior kernels do not depend
        # on it, so its copies run beside them on the second stream
        x_halo, wait = _on_side_stream(
            side, lambda: _halo_planes(x, 0, ghost_z))
        tv = grid_map(lambda xs, x0, ya, yd: cp_dual(
            xs, x0, ya, yd, tmul, interior=True, **dual_kw)[2],
            x, x_noisy, y_A, y_D)
        wait()
        grid_map(lambda xs, xh, x0, ya, yd, p: cp_dual_boundary(
            xs, xh, x0, ya, yd, p, tmul, **dual_kw),
            x, x_halo, x_noisy, y_A, y_D, tv)
        # the same for pass B: only the z-differentiating channels cross z
        # edges, and only toward the side whose D^T stencil reads them
        y_halo, wait = _on_side_stream(
            side, lambda: _sparse_channel_halo(y_D, 0, chans, AXIS_Z))
        fid = grid_map(lambda xs, x0, ya, yd: cp_primal(
            xs, x0, ya, yd, tmul, interior=True, **primal_kw)[1],
            x, x_noisy, y_A, y_D)
        wait()
        grid_map(lambda xs, x0, ya, yd, yh, p: cp_primal_boundary(
            xs, x0, ya, yd, yh, p, tmul, **primal_kw),
            x, x_noisy, y_A, y_D, y_halo, fid)
        return grid_sum(grid_map(shard_loss, fid, tv))

    def _side_stream():
        if mesh.device.type != "cuda" or not solve.side_stream:
            return None
        if solve._stream is None:
            solve._stream = torch.cuda.Stream(mesh.device)
        return solve._stream

    step = overlap_step if overlap else ghost_step

    def solve(x_noisy, x, y_A, y_D_int, each=None):
        for name, grid in (("x_noisy", x_noisy), ("x", x), ("y_A", y_A)):
            _check_grid(grid, mesh, global_shape, shard_time)
            _check_state(grid, name, dtype, mesh)
        _check_grid(y_D_int, mesh, global_shape, shard_time)
        # the kernels update their operands in place: work on copies
        x_noisy = grid_map(lambda a: a.contiguous(), x_noisy)
        x, y_A = (grid_map(lambda a: a.contiguous().clone(), g)
                  for g in (x, y_A))
        y_D = grid_map(lambda a: a.to(dual_dtype, copy=True).contiguous(),
                       y_D_int)
        losses = torch.empty(n_iter, dtype=torch.float32, device=mesh.device)
        for i in range(n_iter):
            losses[i] = step(x, y_A, y_D, x_noisy)
            if each is not None:
                each(i, losses[i])
        return x, y_A, y_D, losses

    # True runs the overlapped step's exchange on a second CUDA stream;
    # on one card it buys nothing measurable (the two are timed side by side
    # on the card by chip_smoke.py), so the current stream is the default
    solve.side_stream = False
    solve._stream = None
    solve.overlap = overlap
    return solve


def make_sharded_tv_half(mesh: Mesh, cfg: TVConfig, global_shape,
                         shard_time: bool = True, *, sigma, tau, reg,
                         nonneg: bool = False):
    """The TV half of the fused inverse-problem iteration
    (``solvers.inverse``'s fused loop) on a grid of shards, each pass a
    kernel in its halo mode on every shard: ``dual(x_bar, y_D_int)``, the
    TV dual prox of the over-relaxed iterate extended by its ghost planes
    (``kernels.fused.tv_dual``: B5); ``primal(x, at, y_D_int, out)``, the
    primal update from the dual extended by its neighbours' planes
    (``cp_primal``: B2, with ``A^T y_A`` in its y_A slot and x in its x0
    slot, x' written to ``out``); ``tv(x)``, the TV value of ``D x`` summed
    over shards (``tv_norms``: B3).  The exchanges are the sharded CP's
    ghost path.  On a CUDA device each pass launches its kernel or raises;
    on the CPU it runs the kernel's plain version."""
    from ..kernels.fused import cp_primal, tv_dual, tv_norms
    from ..solvers.inverse import _TVHalf

    nz, nt = mesh_sizes(mesh, shard_time)
    check_divisible(global_shape, nz, nt)
    chans, _ = scheme_channels(cfg.scheme, global_shape[0], global_shape[1],
                               cfg.reg_z_over_reg, cfg.reg_time)
    mode = dict(cfg=cfg, halo_mode=True,
                table_dims=(global_shape[0], global_shape[1]))
    t_sharded = nt > 1
    ghost_z = _axis_ghost_kind(chans, AXIS_Z)
    ghost_t = _axis_ghost_kind(chans, AXIS_T)

    def extend(x):
        return _extend_axis(_extend_axis(x, 0, ghost_z), 1, ghost_t)

    def dual(x_bar, y):
        return grid_map(lambda xe, yd: tv_dual(
            xe, yd, sigma_D=sigma, reg=reg, **mode)[0], extend(x_bar), y)

    def primal(x, at, y, out):
        return grid_map(lambda xs, a, yd, ye, o: cp_primal(
            xs, xs, a, yd, tau=tau, nonneg=nonneg, out=o, y_ext=ye,
            t_sharded=t_sharded, **mode)[0],
            x, at, y, _extend_dual(y, chans), out)

    def tv(x):
        return grid_sum(grid_map(lambda xe: torch.sum(tv_norms(
            xe, **mode)[1]), extend(x)))

    return _TVHalf(dual, primal, tv)


def _extend_axis2(shards, axis, ghost_kind):
    """Two halo planes + ghosts per side along ``axis`` (for the G pass,
    which recomputes D channels at +-1 neighbour planes and therefore reads
    x at +-2).  Ghosts are chosen so that every D channel at a globally
    invalid slot evaluates to exactly zero:

    - 'edge' (fwd/bwd schemes): clamp padding, ghost(-1) = ghost(-2) = x[0];
    - 'reflect' (central): ghost(-1) = x[1], ghost(-2) = x[0] (and mirrored
      on the high side), the unique choice with d_ctr(-1) = d_ctr(0) = 0.

    Handles 1-plane shards (the second halo comes from two hops along the
    grid, and mirror ghosts from the opposite-direction halo)."""
    n = grid_size(shards, axis)
    nd = first_shard(shards).ndim
    L = first_shard(shards).shape[axis]

    def first(a):
        return a[_sl(nd, axis, 0, 1)]

    def last(a):
        return a[_sl(nd, axis, -1, None)]

    if n == 1:
        def ext(x):
            if ghost_kind == "edge" or L == 1:
                lo1 = lo2 = first(x)
                hi1 = hi2 = last(x)
            else:
                lo1, lo2 = x[_sl(nd, axis, 1, 2)], first(x)
                hi1, hi2 = x[_sl(nd, axis, -2, -1)], last(x)
            return torch.cat([lo2, lo1, x, hi1, hi2], dim=axis)

        return grid_map(ext, shards)

    # the planes one hop away, and (1-plane shards) the planes two hops away
    # as the hop of a hop: zeros beyond the grid's end either way
    h1l = planes_from_left(shards, axis)
    h1r = planes_from_right(shards, axis)
    if L >= 2:
        src_l = grid_map(lambda x: x[_sl(nd, axis, -2, -1)], shards)
        src_r = grid_map(lambda x: x[_sl(nd, axis, 1, 2)], shards)
    else:
        src_l, src_r = h1l, h1r
    h2l = planes_from_left(src_l, axis)
    h2r = planes_from_right(src_r, axis)
    out = []
    for iz, it, x in indexed(shards):
        idx = (iz, it)[axis]
        l1, r1 = h1l[iz][it], h1r[iz][it]
        l2, r2 = h2l[iz][it], h2r[iz][it]
        if ghost_kind == "edge":
            g_lo1, g_hi1 = first(x), last(x)
            g_lo2_second, g_hi2_second = l1, r1  # = the global edge plane
        else:  # reflect
            g_lo1 = x[_sl(nd, axis, 1, 2)] if L >= 2 else r1
            g_hi1 = x[_sl(nd, axis, -2, -1)] if L >= 2 else l1
            # the shard whose 2-back plane is global -1 needs mirror(-1) =
            # x_global[1], which with a 1-plane shard is its OWN plane
            g_lo2_second, g_hi2_second = first(x), last(x)
        lo1 = g_lo1 if idx == 0 else l1
        hi1 = g_hi1 if idx == n - 1 else r1
        lo2 = first(x) if idx == 0 else l2
        hi2 = last(x) if idx == n - 1 else r2
        if L == 1:
            if idx == 1:
                lo2 = g_lo2_second
            if idx == n - 2:
                hi2 = g_hi2_second
        out.append(torch.cat([lo2, lo1, x, hi1, hi2], dim=axis))
    return grid_like(shards, out)


def _extend_norms(norms):
    """Every shard's pass-1 norms with one halo plane per side in z and t,
    and safe divisors in them: the numerators at ghost planes are zero by
    the x ghosts' construction, so any finite nonzero divisor works."""
    for axis in (0, 1):
        norms = _extend_axis(norms, axis, "zero")
        for _, _, n1 in indexed(norms):
            for edge in (_sl(4, axis, 0, 1), _sl(4, axis, -1, None)):
                n1[edge] = torch.where(n1[edge] == 0, 1.0, n1[edge])
    return norms


def make_sharded_gd_solver_fused(
    mesh: Mesh,
    cfg: TVConfig,
    global_shape,
    *,
    reg,
    n_iter,
    step_size=5e-3,
    shard_time: bool = True,
    dtype="float32",
    mask_static=None,
    weight_time=None,
):
    """``n_iter`` fused subgradient-descent steps on a sharded volume: the
    fused tv-norms and subgradient kernels per shard, ghost-plane halos
    (1-deep for the norms pass, 2-deep for the G pass), a sum over shards
    for the loss.  Supports all three TV norms (iso L2,1, aniso L1,1 and
    Huber-smoothed) and plane-shaped static masks / weight_time, like the
    unsharded fused path, and bf16 primary storage (``dtype='bfloat16'``;
    the kernels compute in f32).
    ``solve(x_noisy, x) -> (x, losses)``; inputs sharded with
    ``parallel.mesh.shard_volume``, in ``dtype``; ``solve``'s optional
    ``each(i, loss)`` is called after every iteration.  The loop is
    ``solvers.gd.gd_loop`` on :func:`make_sharded_tv_and_subgrad_fused`'s
    TV, as ``solvers.subgradient_descent`` runs it on a grid."""
    from ..kernels.dispatch import as_dtype
    from ..solvers.gd import eager_step, gd_loop

    tv_and_G = make_sharded_tv_and_subgrad_fused(
        mesh, cfg, global_shape, shard_time=shard_time, dtype=dtype,
        mask_static=mask_static, weight_time=weight_time)
    space = grid_space(mesh, None, global_shape, shard_time)

    def solve(x_noisy, x, each=None):
        _check_grid(x_noisy, mesh, global_shape, shard_time)
        _check_state(x_noisy, "x_noisy", as_dtype(dtype), mesh)
        x, losses, _ = gd_loop(
            space, eager_step(space, tv_and_G, x_noisy, reg, step_size), x,
            n_iter=n_iter, hist_dtype=torch.float32, each=each)
        return x, losses

    return solve


def make_sharded_tv_and_subgrad_fused(
    mesh: Mesh,
    cfg: TVConfig,
    global_shape,
    *,
    shard_time: bool = True,
    dtype="float32",
    mask_static=None,
    weight_time=None,
    return_grad_norms: bool = False,
):
    """The TV value and subgradient of a sharded volume on the fused
    kernels: pass 1 (``kernels.fused.tv_norms``) on every shard with
    1-deep ghost-plane halos, pass 2 (``tv_subgrad``) with 2-deep ones and
    the norms' halos, the tv a sum over shards.  ``fn(x) -> (tv, G)`` on
    grids in ``dtype`` (``tv`` float32), and the grid of per-voxel norms
    third with ``return_grad_norms`` (``kernels.fused.tv_norms``'s).  On
    a CUDA device each pass launches its kernel (B3, B4 in their halo
    mode) or raises; on the CPU it runs the kernel's plain version."""
    from ..kernels.fused import tv_norms, tv_subgrad

    if cfg.norm not in ("iso", "aniso", "huber"):
        raise ValueError(
            f"the fused kernels support norm='iso'/'aniso'/'huber', got "
            f"{cfg.norm!r}"
        )
    aniso = cfg.norm == "aniso"
    _, _, dtype, chans, tmul = _setup(mesh, cfg, global_shape, shard_time,
                                      dtype, mask_static, weight_time)
    mode = dict(cfg=cfg, halo_mode=True,
                table_dims=(global_shape[0], global_shape[1]))
    ghost_z = _axis_ghost_kind(chans, AXIS_Z)
    ghost_t = _axis_ghost_kind(chans, AXIS_T)

    def fn(x):
        _check_grid(x, mesh, global_shape, shard_time)
        _check_state(x, "x", dtype, mesh)
        x1 = _extend_axis(_extend_axis(x, 0, ghost_z), 1, ghost_t)
        passed = grid_map(lambda xe: tv_norms(xe, tmul, **mode), x1)
        tv = grid_sum(grid_map(lambda np_: torch.sum(np_[1]), passed))
        x2 = _extend_axis2(_extend_axis2(x, 0, ghost_z), 1, ghost_t)
        # the aniso G never divides by the norms (sign-based subgradient)
        if aniso:
            G = grid_map(lambda xe: tv_subgrad(xe, None, tmul, **mode), x2)
        else:
            n1 = _extend_norms(grid_map(lambda np_: np_[0], passed))
            G = grid_map(lambda xe, ne: tv_subgrad(xe, ne, tmul, **mode),
                         x2, n1)
        if return_grad_norms:
            return tv, G, grid_map(lambda np_: np_[0], passed)
        return tv, G

    return fn
