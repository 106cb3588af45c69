"""The (z, t) mesh of shards and the exchange between them.

The port of ``pytv4d_tpu/parallel/mesh.py``.  The reference's layout comment
is the sharding blueprint: ``(Nz, M, N, N)`` is chosen "since the CT
operations can be decomposed easily along z" (``README.md:235``), so the
mesh is ``('z', 't')`` and a volume is cut along its two leading axes.

A sharded volume is a grid of shards ``shards[iz][it]``: a nested list of
contiguous tensors on the mesh's device.  On a mesh that spans several
processes (``parallel.multihost.global_mesh``) each process owns a
contiguous block of rows, in rank order, and the rows of the other
processes are ``None`` in its grid.  A spec names, per tensor axis, the mesh
axis that cuts it (``volume_spec``: the JAX package's ``PartitionSpec``),
and a :class:`Sharding` pairs it with a mesh (``NamedSharding``).

The exchange between neighbours is written once, here:
:func:`planes_from_left` and :func:`planes_from_right` hand every shard of a
grid its neighbour's edge plane, or zeros at the grid's end, exactly what
``lax.ppermute`` delivers in the JAX package.  Across processes they post
the whole grid's exchange at once (``torch.distributed.batch_isend_irecv``)
and then wait, so every process must call them at the same point of the
program, as it would a collective.  ``parallel.halo``,
``parallel.fused_halo`` and ``parallel.tgv_sharded`` reach their neighbours
through these two functions only, and sum over shards through
:func:`grid_sum`.

The mesh's device follows the package's rule (``utils.device``): the CUDA
device unless ``device="cpu"`` asks for the CPU.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from ..ops.operators import _sl

Z_AXIS = "z"
T_AXIS = "t"


class Mesh:
    """A ``z x t`` grid of shards: ``shape`` is ``{'z': nz, 't': nt}`` as on
    a ``jax.sharding.Mesh``.  ``process_count`` processes share it, each on
    its own ``device``; process ``process_index`` owns the z-rows
    :meth:`local_rows`."""

    def __init__(self, z: int, t: int, device, process_index: int = 0,
                 process_count: int = 1):
        if z % process_count:
            raise ValueError(f"a mesh of z={z} cannot be split among "
                             f"{process_count} processes")
        self.shape = {Z_AXIS: z, T_AXIS: t}
        self.device = torch.device(device)
        self.process_index = process_index
        self.process_count = process_count

    def local_rows(self) -> range:
        """The z-rows of the grid this process holds."""
        k = self.shape[Z_AXIS] // self.process_count
        return range(self.process_index * k, (self.process_index + 1) * k)

    def __repr__(self):
        procs = (f", process {self.process_index} of {self.process_count}"
                 if self.process_count > 1 else "")
        return (f"Mesh(z={self.shape[Z_AXIS]}, t={self.shape[T_AXIS]}, "
                f"device={self.device}{procs})")


class Sharding(NamedTuple):
    """Where an array lives: ``spec[k]`` is the mesh axis that cuts tensor
    axis ``k`` (``'z'``, ``'t'`` or None), as in a ``NamedSharding``."""
    mesh: Mesh
    spec: tuple


def make_mesh(z: int, t: int = 1, device=None) -> Mesh:
    """Build a ``(z, t)`` mesh of ``z * t`` shards on ``device`` (default:
    the CUDA device; ``RuntimeError`` where there is none)."""
    if z < 1 or t < 1:
        raise ValueError(f"mesh {z}x{t}: both sizes must be >= 1")
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "a mesh lives on the CUDA device, and none is available; "
                "pass device='cpu' to shard on the CPU")
        device = "cuda"
    return Mesh(z, t, device)


def mesh_sizes(mesh: Mesh, shard_time: bool = True):
    """``(nz, nt)``: the number of shards along z and along t (1 when time
    is not sharded)."""
    return mesh.shape[Z_AXIS], mesh.shape[T_AXIS] if shard_time else 1


def check_divisible(global_shape, nz: int, nt: int):
    if global_shape[0] % nz or global_shape[1] % nt:
        raise ValueError(
            f"global shape {tuple(global_shape)} not divisible by mesh "
            f"(z={nz}, t={nt})"
        )


def volume_spec(shard_time: bool = True) -> tuple:
    """The spec of a ``(Nz, M, N_row, N_col)`` volume."""
    return (Z_AXIS, T_AXIS if shard_time else None, None, None)


def d_volume_spec(shard_time: bool = True) -> tuple:
    """The spec of a ``(Nz, Nd, M, N_row, N_col)`` difference volume: the
    channel axis stays whole, z and t are cut like the volume's."""
    return (Z_AXIS, None, T_AXIS if shard_time else None, None, None)


def volume_sharding(mesh: Mesh, shard_time: bool = True) -> Sharding:
    return Sharding(mesh, volume_spec(shard_time))


def d_volume_sharding(mesh: Mesh, shard_time: bool = True) -> Sharding:
    return Sharding(mesh, d_volume_spec(shard_time))


def _cuts(sharding: Sharding):
    """``((z tensor axis, nz), (t tensor axis, nt))``: which axis each mesh
    axis cuts, and into how many parts (axis None and 1 part where the spec
    does not name it)."""
    mesh, spec = sharding
    out = []
    for name in (Z_AXIS, T_AXIS):
        axis = spec.index(name) if name in spec else None
        out.append((axis, mesh.shape[name] if axis is not None else 1))
    return out


def shard(x, sharding: Sharding):
    """Cut ``x`` (a tensor or a numpy array holding the whole array) into
    the grid of shards ``[iz][it]`` that ``sharding`` describes, on the
    mesh's device: the ``jax.device_put`` of a host array.  On a mesh of
    several processes only this process's rows are kept."""
    mesh = sharding.mesh
    (z_axis, nz), (t_axis, nt) = _cuts(sharding)
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    if len(sharding.spec) != x.ndim:
        raise ValueError(f"spec {sharding.spec} does not fit an array of "
                         f"shape {tuple(x.shape)}")
    check_divisible((x.shape[z_axis] if z_axis is not None else nz,
                     x.shape[t_axis] if t_axis is not None else nt), nz, nt)
    if mesh.process_count > 1 and nz != mesh.shape[Z_AXIS]:
        raise ValueError(f"spec {sharding.spec} does not cut z, and a mesh "
                         f"of {mesh.process_count} processes splits its "
                         f"z-rows among them")
    local = mesh.local_rows() if mesh.process_count > 1 else range(nz)

    def cut(a, axis, n):
        return torch.chunk(a, n, dim=axis) if axis is not None else (a,)

    return [[part.to(mesh.device).contiguous() for part in cut(slab, t_axis,
                                                               nt)]
            if iz in local else None
            for iz, slab in enumerate(cut(x, z_axis, nz))]


def shard_volume(x, mesh: Mesh, shard_time: bool = True):
    """Cut a volume ``(Nz, M, ...)`` (a tensor or a numpy array) into the
    mesh's grid of shards ``[iz][it]``, on the mesh's device.  Also shards a
    dual in the kernels' internal ``(Nz, M, Nd, Nr, Nc)`` layout."""
    if not isinstance(x, torch.Tensor):
        x = torch.as_tensor(np.asarray(x))
    spec = volume_spec(shard_time) + (None,) * (x.ndim - 4)
    return shard(x, Sharding(mesh, spec))


def shard_d_volume(y, mesh: Mesh, shard_time: bool = True):
    """:func:`shard_volume` for a difference volume ``(Nz, Nd, M, Nr, Nc)``:
    the channel axis stays whole, z and t are cut like the volume's."""
    return shard(y, d_volume_sharding(mesh, shard_time))


def is_distributed(grid) -> bool:
    """True for the grid of one process of several: some rows are another
    process's (None here)."""
    return any(row is None for row in grid)


def is_grid(x) -> bool:
    """True for a grid of shards (what :func:`shard` returns): a nonempty
    list of rows, each a nonempty list of tensors or None (another
    process's row)."""
    if not isinstance(x, list):
        return False
    rows = [row for row in x if row is not None]
    return bool(rows) and all(
        isinstance(row, list) and row
        and all(isinstance(s, torch.Tensor) for s in row) for row in rows)


class GridLayout(NamedTuple):
    """What a grid of shards says of itself (:func:`grid_mesh`)."""
    mesh: Mesh
    shard_time: bool
    shape: tuple  # the whole array's shape


def grid_mesh(grid, t_axis: int = 1) -> GridLayout:
    """The mesh a grid lives on, whether it cuts time and the whole
    array's shape, from its shards' shapes and :func:`grid_process`.
    ``t_axis``: the tensor axis the mesh's t cuts (2 for a difference
    volume, ``shard_d_volume``).  The mesh is the grid's own: ``t`` is 1
    where time is not cut."""
    first = first_shard(grid)
    nz, nt = len(grid), grid_size(grid, 1)
    shape = list(first.shape)
    shape[0] *= nz
    shape[t_axis] *= nt
    return GridLayout(Mesh(nz, nt, first.device, *grid_process(grid)),
                      nt > 1, tuple(shape))


def grid_process(grid):
    """``(process index, process count)`` of a grid: its z-rows are split
    evenly among the processes, in rank order (``(0, 1)`` for one
    process's grid)."""
    rows = [iz for iz, row in enumerate(grid) if row is not None]
    return rows[0] // len(rows), len(grid) // len(rows)


def _gather(shards, t_axis):
    if is_distributed(shards):
        raise ValueError(
            "this grid holds only this process's rows; take them with "
            "parallel.multihost.global_to_host_local")
    return torch.cat([torch.cat(row, dim=t_axis) for row in shards], dim=0)


def gather_volume(shards):
    """The whole volume from its grid of shards (the inverse of
    :func:`shard_volume`)."""
    return _gather(shards, 1)


def gather_d_volume(shards):
    """The inverse of :func:`shard_d_volume`."""
    return _gather(shards, 2)


def grid_map(fn, *grids):
    """``fn`` applied shard by shard, in (iz, it) order, over grids of one
    shape; a grid of the results (another process's rows stay None)."""
    return [None if rows[0] is None else
            [fn(*cells) for cells in zip(*rows)] for rows in zip(*grids)]


def indexed(shards):
    """``(iz, it, shard)`` of this process's shards, in the fixed order
    every sum over shards is taken in."""
    return [(iz, it, s) for iz, row in enumerate(shards) if row is not None
            for it, s in enumerate(row)]


def grid_like(shards, cells):
    """The flat list ``cells`` (in :func:`indexed` order) as a grid shaped
    like ``shards``."""
    cells = iter(cells)
    return [None if row is None else [next(cells) for _ in row]
            for row in shards]


def first_shard(shards):
    """The first shard this process holds (every shard of a grid has its
    shape)."""
    return indexed(shards)[0][2]


def grid_size(shards, axis: int) -> int:
    """Number of shards along tensor axis ``axis`` (0: the mesh's z, 1: its
    t), over every process."""
    return len(shards) if axis == 0 else len(next(
        row for row in shards if row is not None))


def _all_cells(grid):
    """The cells of a grid in (iz, it) order, those of every process: on
    a grid spread over processes they are all-gathered, so that every
    process holds them all in the same order."""
    cells = [c for _, _, c in indexed(grid)]
    if is_distributed(grid):
        import torch.distributed as dist

        local = torch.stack([torch.as_tensor(c) for c in cells])
        parts = [torch.empty_like(local)
                 for _ in range(dist.get_world_size())]
        dist.all_gather(parts, local)
        cells = [c for part in parts for c in part.unbind(0)]
    return cells


def grid_sum(grid):
    """The sum of a grid of scalars (or of equal-shaped tensors) in (iz, it)
    order: the ``psum``.  Across processes the cells are all-gathered and
    added in the same order on every process, so the sum is bit-equal to
    the one process's; an ``all_reduce`` would not promise that."""
    cells = _all_cells(grid)
    total = cells[0]
    for c in cells[1:]:
        total = total + c
    return total


def grid_max(grid):
    """The largest of a grid of scalars, over every process (``pmax``)."""
    return functools.reduce(torch.maximum, map(torch.as_tensor,
                                               _all_cells(grid)))


def grid_min(grid):
    """The smallest of a grid of scalars, over every process (``pmin``)."""
    return functools.reduce(torch.minimum, map(torch.as_tensor,
                                               _all_cells(grid)))


def _zero_plane(a, axis):
    return torch.zeros_like(a[_sl(a.ndim, axis, 0, 1)])


def plane_from_left(shards, axis: int, iz: int, it: int):
    """For shard ``(iz, it)``: the last plane along tensor axis ``axis``
    (0 crosses the mesh's z, 1 its t) of its left neighbour, zeros on the
    first shard.  The neighbour must be in this process's grid: a grid's
    exchange across processes is :func:`planes_from_left`."""
    if (iz, it)[axis] == 0:
        return _zero_plane(shards[iz][it], axis)
    nb = shards[iz - 1][it] if axis == 0 else shards[iz][it - 1]
    return nb[_sl(nb.ndim, axis, -1, None)]


def plane_from_right(shards, axis: int, iz: int, it: int):
    """For shard ``(iz, it)``: the first plane along tensor axis ``axis`` of
    its right neighbour, zeros on the last shard (as
    :func:`plane_from_left`)."""
    if (iz, it)[axis] == grid_size(shards, axis) - 1:
        return _zero_plane(shards[iz][it], axis)
    nb = shards[iz + 1][it] if axis == 0 else shards[iz][it + 1]
    return nb[_sl(nb.ndim, axis, 0, 1)]


def _exchange_rows(shards, from_left: bool):
    """Across processes along z: the edge planes this process's edge row
    takes from the neighbouring process, one per column (None on the first
    process for ``from_left``, on the last otherwise).  Sends the planes
    the neighbour on the other side takes from this process, all in one
    batch of point-to-point operations, then waits for them."""
    import torch.distributed as dist

    rows = [iz for iz, row in enumerate(shards) if row is not None]
    rank, n_proc = grid_process(shards)
    if from_left:  # my last row's last planes go right
        send_row, recv_row, edge = rows[-1], rows[0], slice(-1, None)
        send_to, recv_from = rank + 1, rank - 1
    else:          # my first row's first planes go left
        send_row, recv_row, edge = rows[0], rows[-1], slice(0, 1)
        send_to, recv_from = rank - 1, rank + 1
    ops, got = [], None
    if 0 <= send_to < n_proc:
        out = torch.stack([s[edge] for s in shards[send_row]])
        ops.append(dist.P2POp(dist.isend, out, send_to))
    if 0 <= recv_from < n_proc:
        got = torch.empty_like(torch.stack([s[edge]
                                            for s in shards[recv_row]]))
        ops.append(dist.P2POp(dist.irecv, got, recv_from))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return None if got is None else list(got.unbind(0))


def _planes(shards, axis, from_left):
    local = plane_from_left if from_left else plane_from_right
    remote = None
    if axis == 0 and is_distributed(shards):
        remote = _exchange_rows(shards, from_left)
    out = []
    for iz, it, _ in indexed(shards):
        nb = iz - 1 if from_left else iz + 1
        if (axis == 0 and 0 <= nb < len(shards)
                and shards[nb] is None):
            out.append(remote[it])
        else:
            out.append(local(shards, axis, iz, it))
    return grid_like(shards, out)


def planes_from_left(shards, axis: int):
    """:func:`plane_from_left` for every shard of the grid: a grid of
    planes.  On a grid spread over processes this is the exchange between
    them, which every process must enter at the same point."""
    return _planes(shards, axis, True)


def planes_from_right(shards, axis: int):
    """:func:`plane_from_right` for every shard of the grid (as
    :func:`planes_from_left`)."""
    return _planes(shards, axis, False)
