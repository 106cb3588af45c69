"""The (z, t) mesh of shards and the exchange between them.

The port of ``pytv4d_tpu/parallel/mesh.py``.  The reference's layout comment
is the sharding blueprint: ``(Nz, M, N, N)`` is chosen "since the CT
operations can be decomposed easily along z" (``README.md:235``), so the
mesh is ``('z', 't')`` and a volume is cut along its two leading axes.

A sharded volume is a grid of shards ``shards[iz][it]``: a nested list of
contiguous tensors, all on the mesh's one device.  The exchange between
neighbours is written once, here: :func:`plane_from_left` and
:func:`plane_from_right` hand a shard its neighbour's edge plane, or zeros at
the grid's end, exactly what ``lax.ppermute`` delivers in the JAX package.
``parallel.halo`` and ``parallel.fused_halo`` reach their neighbours through
these two functions only.

The mesh's device follows the package's rule (``utils.device``): the CUDA
device unless ``device="cpu"`` asks for the CPU.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.operators import _sl

Z_AXIS = "z"
T_AXIS = "t"


class Mesh:
    """A ``z x t`` grid of shards on one device: ``shape`` is
    ``{'z': nz, 't': nt}`` as on a ``jax.sharding.Mesh``."""

    def __init__(self, z: int, t: int, device):
        self.shape = {Z_AXIS: z, T_AXIS: t}
        self.device = torch.device(device)

    def __repr__(self):
        return (f"Mesh(z={self.shape[Z_AXIS]}, t={self.shape[T_AXIS]}, "
                f"device={self.device})")


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


def _shard(x, mesh, shard_time, t_axis):
    x = torch.as_tensor(np.asarray(x) if not isinstance(x, torch.Tensor)
                        else x, device=mesh.device)
    nz, nt = mesh_sizes(mesh, shard_time)
    check_divisible((x.shape[0], x.shape[t_axis]), nz, nt)
    return [[part.contiguous() for part in torch.chunk(slab, nt, dim=t_axis)]
            for slab in torch.chunk(x, nz, dim=0)]


def shard_volume(x, mesh: Mesh, shard_time: bool = True):
    """Cut a volume ``(Nz, M, ...)`` (a tensor or a numpy array) into the
    mesh's grid of shards ``[iz][it]``, on the mesh's device.  Also shards a
    dual in the kernels' internal ``(Nz, M, Nd, Nr, Nc)`` layout."""
    return _shard(x, mesh, shard_time, 1)


def shard_d_volume(y, mesh: Mesh, shard_time: bool = True):
    """:func:`shard_volume` for a difference volume ``(Nz, Nd, M, Nr, Nc)``:
    the channel axis stays whole, z and t are cut like the volume's."""
    return _shard(y, mesh, shard_time, 2)


def _gather(shards, t_axis):
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
    shape; a grid of the results."""
    return [[fn(*cells) for cells in zip(*rows)] for rows in zip(*grids)]


def _zero_plane(a, axis):
    return torch.zeros_like(a[_sl(a.ndim, axis, 0, 1)])


def plane_from_left(shards, axis: int, iz: int, it: int):
    """For shard ``(iz, it)``: the last plane along tensor axis ``axis``
    (0 crosses the mesh's z, 1 its t) of its left neighbour, zeros on the
    first shard."""
    if (iz, it)[axis] == 0:
        return _zero_plane(shards[iz][it], axis)
    nb = shards[iz - 1][it] if axis == 0 else shards[iz][it - 1]
    return nb[_sl(nb.ndim, axis, -1, None)]


def plane_from_right(shards, axis: int, iz: int, it: int):
    """For shard ``(iz, it)``: the first plane along tensor axis ``axis`` of
    its right neighbour, zeros on the last shard."""
    n = len(shards) if axis == 0 else len(shards[0])
    if (iz, it)[axis] == n - 1:
        return _zero_plane(shards[iz][it], axis)
    nb = shards[iz + 1][it] if axis == 0 else shards[iz][it + 1]
    return nb[_sl(nb.ndim, axis, 0, 1)]
