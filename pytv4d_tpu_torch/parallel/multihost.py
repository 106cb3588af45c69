"""Several processes on one mesh, over ``torch.distributed``.

The port of ``pytv4d_tpu/parallel/multihost.py`` (``jax.distributed`` and a
global device mesh there).  On each process:

    from pytv4d_tpu_torch.parallel import multihost
    multihost.initialize()                      # from torchrun's variables
    mesh = multihost.global_mesh(z=8)           # z-rows split among processes
    x = multihost.host_local_to_global(mesh, x_local)

Each process holds one device and a contiguous block of the mesh's z-rows,
in rank order; ``parallel.mesh``'s exchange and sums cross the processes, so
``parallel.halo``, ``parallel.fused_halo`` and ``parallel.tgv_sharded`` run
unchanged on such a grid.

The backend follows the package's device rule: NCCL on the CUDA device, and
gloo only where the caller asks for the CPU (``device='cpu'``).  Nothing
falls back to another backend or to a single process unasked.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np
import torch

from .mesh import Mesh, Sharding, shard, volume_spec

_initialized = False
_device = None

# Environment variables whose presence means "this process is part of a
# cluster" (torchrun and torch.distributed's env:// rendezvous): a
# bootstrap failure is then a configuration error, never something to
# paper over with single-process execution.
_CLUSTER_ENV_VARS = ("TORCHELASTIC_RUN_ID",)


def cluster_configured() -> bool:
    """True when the environment declares a multi-process job:
    ``TORCHELASTIC_RUN_ID`` (set by torchrun), ``WORLD_SIZE`` above 1, or
    ``MASTER_ADDR`` together with ``RANK``."""
    if any(os.environ.get(var) for var in _CLUSTER_ENV_VARS):
        return True
    try:
        if int(os.environ.get("WORLD_SIZE", "1")) > 1:
            return True
    except ValueError:  # a malformed value still declares a cluster
        return True
    return bool(os.environ.get("MASTER_ADDR")) and "RANK" in os.environ


def _pick_device(device):
    """This process's device by the package's rule: the CUDA device (the
    one ``LOCAL_RANK`` names under torchrun) unless ``device`` asks for
    another; ``RuntimeError`` where there is none."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "a multi-process mesh lives on the CUDA devices (NCCL), and none "
            "is available; pass device='cpu' to run on the CPU (gloo)")
    local = int(os.environ.get("LOCAL_RANK", "0"))
    return torch.device("cuda", local % torch.cuda.device_count())


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device=None) -> None:
    """Join the process group.  ``coordinator_address`` (``host:port`` of
    rank 0), ``num_processes`` and ``process_id`` name the job explicitly;
    without them torchrun's variables do (``MASTER_ADDR`` / ``MASTER_PORT``
    / ``WORLD_SIZE`` / ``RANK``).  ``device``: where this process computes
    (default: its CUDA device, NCCL; ``'cpu'``: gloo).  Safe to call twice.

    A failed bootstrap RAISES whenever a cluster was asked for (explicit
    arguments or the variables of :func:`cluster_configured`): running on
    as one process would give every downstream mesh the wrong shape and
    wrong results.  With nothing asking for a cluster this process runs
    alone, with no process group."""
    global _initialized, _device
    import torch.distributed as dist

    if _initialized:
        return
    if dist.is_available() and dist.is_initialized():
        _initialized = True
        return
    if coordinator_address is None and not cluster_configured():
        # single-process environment without any cluster configuration
        _device = device
        _initialized = True
        return
    dev = _pick_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    kwargs = dict(init_method="env://")
    if coordinator_address is not None:
        if num_processes is None or process_id is None:
            raise ValueError("coordinator_address needs num_processes and "
                             "process_id")
        kwargs = dict(init_method=f"tcp://{coordinator_address}",
                      world_size=int(num_processes), rank=int(process_id))
    try:
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, **kwargs)
    except (ValueError, RuntimeError) as e:
        raise RuntimeError(
            f"torch.distributed.init_process_group({backend!r}) failed "
            f"although a cluster was configured (explicit "
            f"coordinator_address or WORLD_SIZE / MASTER_ADDR and RANK / "
            f"{_CLUSTER_ENV_VARS}); refusing to silently degrade to "
            f"single-process execution"
        ) from e
    _device = dev
    _initialized = True


def _process():
    """``(rank, world size)`` of this process (``(0, 1)`` alone)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def global_mesh(z: int = 0, t: int = 1, device=None) -> Mesh:
    """A ``(z, t)`` mesh over every process: process ``r`` of ``W`` holds
    z-rows ``[r z/W, (r+1) z/W)`` on its own device.  ``z=0`` means one
    z-row per process.  ``device`` defaults to the one :func:`initialize`
    chose (alone: the CUDA device, raising where there is none)."""
    rank, world = _process()
    if z == 0:
        z = world
    if z % world:
        raise ValueError(f"z={z} shards cannot be split evenly among "
                         f"{world} processes")
    if device is None:
        device = _device if _device is not None else _pick_device(None)
    return Mesh(z, t, device, process_index=rank, process_count=world)


def _sharding(mesh, x, spec):
    if spec is None:
        spec = volume_spec(mesh.shape["t"] > 1)
    return Sharding(mesh, tuple(spec) + (None,) * (x.ndim - len(spec)))


def host_local_to_global(mesh: Mesh, x_local, spec=None):
    """The grid of a sharded array from this process's block: ``x_local``
    is this process's contiguous z-block (a tensor or a numpy array), cut
    into its rows as ``spec`` says (default: the volume spec, ``t`` cut
    where the mesh has more than one; pass ``d_volume_spec()`` for a
    difference volume).  The other processes' rows are None."""
    if not isinstance(x_local, torch.Tensor):
        x_local = torch.as_tensor(np.asarray(x_local))
    sharding = _sharding(mesh, x_local, spec)
    rows = mesh.local_rows()
    own = shard(x_local, Sharding(Mesh(len(rows), mesh.shape["t"],
                                       mesh.device), sharding.spec))
    return [own[iz - rows.start] if iz in rows else None
            for iz in range(mesh.shape["z"])]


def global_to_host_local(mesh: Mesh, x_global, spec=None):
    """This process's block of a grid (the inverse of
    :func:`host_local_to_global`): its rows, joined along z and along the
    axis ``spec`` cuts by t."""
    rows = [row for row in x_global if row is not None]
    sharding = _sharding(mesh, rows[0][0], spec)
    t_axis = (sharding.spec.index("t") if "t" in sharding.spec
              else 0)
    return torch.cat([torch.cat(row, dim=t_axis) for row in rows], dim=0)
