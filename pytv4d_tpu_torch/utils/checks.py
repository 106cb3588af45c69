"""Numerical-health checks: the port of ``pytv4d_tpu/utils/checks.py``'s
:func:`assert_finite` (its ``checkified`` wraps JAX's ``checkify`` and has
no counterpart here)."""

from __future__ import annotations

import numpy as np
import torch


def _leaves(tree, path=""):
    """``(path, leaf)`` of every array in a tree of dicts, lists, tuples and
    NamedTuples, with JAX's ``keystr`` paths (``['key']``, ``[0]``,
    ``.field``)."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f"{path}[{k!r}]")
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for k, v in zip(tree._fields, tree):
            yield from _leaves(v, f"{path}.{k}")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f"{path}[{i}]")
    elif tree is not None:
        yield path, tree


def assert_finite(tree, name: str = "value"):
    """Host-side check that every leaf of a tree (tensors on any device,
    numpy arrays, numbers) is finite; raises ``FloatingPointError`` naming
    the offending leaf's path.  A tensor is checked on its own device and
    only the count of bad elements comes to the host."""
    for path, leaf in _leaves(tree):
        arr = (leaf if isinstance(leaf, torch.Tensor)
               else torch.as_tensor(np.asarray(leaf)))
        bad = int(torch.sum(~torch.isfinite(arr)))
        if bad:
            raise FloatingPointError(
                f"non-finite values in {name}{path}: {bad} bad elements")
