"""The operations a solver's loop asks of its fields, for one tensor or for
a grid of shards.

Each plain solver loop (``solvers``' CP step, GD, ADMM with its CG,
FISTA, the TGV step) is written once against a :class:`Space`: ``D`` /
``D_T`` of its TV configuration, the one-channel differences TGV builds
on, ``map`` for the arithmetic of its fields, ``sum`` for its inner
products and losses, and ``max`` / ``min`` for the scales that relative
floors are taken from.  :func:`tensor_space` is a whole volume: ``map``
applies the function to the tensors, ``sum`` / ``max`` / ``min`` return
its scalar.  ``parallel.halo.grid_space`` is a grid of shards: the
exchanged stencils, the function applied shard by shard (an argument that
is not a grid goes to every shard as it is), the scalars added over shards
in (iz, it) order, or the largest / smallest of them, so that a floor
comes from the whole grid and never from one shard.  On a tensor the loop
computes exactly what it computed before it took a space.
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

from . import operators as _ops


class Space(NamedTuple):
    """The operations of one kind of field (see the module docstring)."""

    D: Optional[Callable]    # volume -> difference volume (None: no cfg)
    D_T: Optional[Callable]  # its adjoint
    d_channel: Callable      # (x, axis, kind) -> one difference channel
    dt_channel: Callable     # (y, axis, kind) -> its adjoint scatter
    map: Callable            # map(fn, *fields) -> field of fn's results
    sum: Callable            # sum(fn, *fields) -> sum of fn's scalars
    max: Callable            # max(fn, *fields) -> the largest of them
    min: Callable            # min(fn, *fields) -> the smallest of them
    first: Callable          # a field's (first) tensor: dtype and device
    place: Callable          # place(a, d_volume=False): a field of this kind
    shape: Optional[tuple]   # the whole volume's shape, where known


def _apply(fn, *fields):
    return fn(*fields)


def _same(a, d_volume=False):
    return a


def tensor_space(cfg=None, mask_static=None, weight_time=None,
                 shape=None) -> Space:
    """The space of one tensor: ``ops.operators``' ``D`` / ``D_T`` of
    ``cfg`` (a ``TVConfig``) with ``mask_static`` / ``weight_time``."""
    D = D_T = None
    if cfg is not None:
        kw = dict(mask_static=mask_static, weight_time=weight_time,
                  **cfg.kwargs())

        def D(x):
            return _ops.D(x, cfg.scheme, **kw)

        def D_T(y):
            return _ops.D_T(y, cfg.scheme, **kw)

    return Space(D, D_T, _ops.d_channel, _ops.dt_channel, _apply, _apply,
                 _apply, _apply, lambda a: a, _same,
                 None if shape is None else tuple(shape))


TENSOR = tensor_space()


def d_zeros(space: Space, x, n: int):
    """Zeros of ``n`` difference channels on ``x``'s field:
    ``(nz, n, m, Nr, Nc)`` a tensor or shard."""
    return space.map(lambda a: a.new_zeros((a.shape[0], n)
                                           + tuple(a.shape[1:])), x)
