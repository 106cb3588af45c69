"""Solver-state checkpoint / resume and tolerance-based stopping: the port
of ``pytv4d_tpu/solvers/state.py``.

Any solver state (``CPState``, ``CPPrecondState``, ``ADMMState``,
``InverseState``, ``TGVState``, plain tuples, lists and dicts of tensors) can
be saved to a single ``.npz`` and restored.  The file format is the JAX
package's (``leaf_<i>`` arrays in the order its pytree flattening gives:
NamedTuple fields, tuple and list items in order, dict values by sorted key,
``None`` holds no leaf), so a checkpoint either package wrote loads in the
other.  :func:`run_checkpointed` wraps a solver so long runs snapshot at a
configurable cadence and resume after interruption;
:func:`run_until_converged` stops a solver on a tolerance.
"""

from __future__ import annotations

import functools
import inspect
import os
from typing import Any, Callable

import numpy as np
import torch

from ..parallel.mesh import (
    Sharding,
    d_volume_spec,
    first_shard,
    gather_d_volume,
    gather_volume,
    grid_mesh,
    is_distributed,
    is_grid,
    shard,
    volume_spec,
)


def _flatten(tree, leaves):
    """Append the leaves of ``tree`` in the JAX package's order."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for key in sorted(tree):
            _flatten(tree[key], leaves)
    elif isinstance(tree, (tuple, list)):  # NamedTuples too
        for item in tree:
            _flatten(item, leaves)
    else:
        leaves.append(tree)


def _unflatten(like, leaves, place):
    """``like`` with each leaf replaced by ``place(next(leaves), leaf)``,
    in the order of :func:`_flatten`."""
    if like is None:
        return None
    if isinstance(like, dict):
        new = {key: _unflatten(like[key], leaves, place)
               for key in sorted(like)}
        return {key: new[key] for key in like}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_unflatten(t, leaves, place) for t in like))
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten(t, leaves, place) for t in like)
    return place(next(leaves), like)


def _structure(tree):
    """A printable outline of ``tree`` (stored beside the leaves)."""
    if tree is None:
        return "None"
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_structure(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, (tuple, list)):
        name = type(tree).__name__
        return f"{name}(" + ", ".join(_structure(t) for t in tree) + ")"
    return "*"


def _to_numpy(leaf):
    """A leaf as a numpy array (bfloat16, which numpy lacks, widens to
    float32)."""
    if isinstance(leaf, torch.Tensor):
        leaf = leaf.detach()
        if leaf.dtype == torch.bfloat16:
            leaf = leaf.float()
        return leaf.cpu().numpy()
    return np.asarray(leaf)


def _restore(array, like):
    """A loaded array as the template leaf's kind: a tensor on the leaf's
    device (back in bfloat16 where the leaf is), else the numpy array."""
    if isinstance(like, torch.Tensor):
        t = torch.as_tensor(np.asarray(array), device=like.device)
        return t.to(torch.bfloat16) if like.dtype == torch.bfloat16 else t
    return array


def _num_leaves(tree) -> int:
    leaves = []
    _flatten(tree, leaves)
    return len(leaves)


def save_state(path: str, pytree: Any) -> None:
    """Save an arbitrary tree of tensors to ``path`` (.npz, atomic rename)."""
    leaves = []
    _flatten(pytree, leaves)
    arrays = {f"leaf_{i}": _to_numpy(leaf) for i, leaf in enumerate(leaves)}
    arrays["__treedef__"] = np.frombuffer(
        _structure(pytree).encode("utf-8"), dtype=np.uint8
    )
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
    os.replace(tmp, path)


def load_state(path: str, like: Any) -> Any:
    """Restore a tree saved by :func:`save_state` (or by the JAX package's);
    ``like`` supplies the tree structure and, leaf by leaf, the device (e.g.
    a freshly-initialized solver state).

    Forward-compatible with states that GREW trailing optional leaves
    (e.g. ``InverseState.s_x``/``s_x_bar``): a checkpoint with fewer arrays
    than the template loads with the template's trailing NamedTuple fields
    set to ``None``; the solvers accept that and recompute the derived
    quantities once on resume (exact in math, may differ from an
    uninterrupted run in the last ulps)."""
    with np.load(path) as data:
        leaves = [data[f"leaf_{i}"] for i in range(len(data.files) - 1)]
    want = _num_leaves(like)
    if (len(leaves) < want and hasattr(like, "_fields")
            and hasattr(like, "_replace")):
        # pre-format-change checkpoint: None out trailing fields (None
        # holds no leaf) until the leaf counts match, if they can
        reduced = like
        for name in reversed(like._fields):
            if _num_leaves(reduced) <= len(leaves):
                break
            reduced = reduced._replace(**{name: None})
        if _num_leaves(reduced) == len(leaves):
            like, want = reduced, len(leaves)
    if len(leaves) != want:
        raise ValueError(
            f"checkpoint {path!r} holds {len(leaves)} arrays but the "
            f"template {type(like).__name__} expects {want} — the "
            f"solver's state format has likely changed since the "
            f"checkpoint was written (e.g. chambolle_pock_precond now "
            f"carries the over-relaxed iterate); restart the run"
        )
    return _unflatten(like, iter(leaves), _restore)


def _whole(tree):
    """``tree`` with every grid of shards gathered to its whole array: 4-D
    shards in the volume's layout, 5-D ones in the difference volume's
    (``parallel.mesh.gather_volume`` / ``gather_d_volume``; a grid of one
    process of several raises ``ValueError`` there)."""
    if is_grid(tree):
        if first_shard(tree).ndim == 5:
            return gather_d_volume(tree)
        return gather_volume(tree)
    if isinstance(tree, dict):
        return {key: _whole(v) for key, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_whole(t) for t in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_whole(t) for t in tree)
    return tree


def _recut(tree, like):
    """The whole arrays of ``tree`` cut onto the grids of ``like`` where
    it holds grids (the inverse of :func:`_whole`)."""
    if is_grid(like):
        d = first_shard(like).ndim == 5
        lay = grid_mesh(like, 2 if d else 1)
        spec = (d_volume_spec if d else volume_spec)(lay.shard_time)
        return shard(tree, Sharding(lay.mesh, spec))
    if isinstance(like, dict):
        return {key: _recut(tree[key], v) for key, v in like.items()}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_recut(t, v) for t, v in zip(tree, like)))
    if isinstance(like, (tuple, list)):
        return type(like)(_recut(t, v) for t, v in zip(tree, like))
    return tree


def save_state_torch(path: str, pytree: Any) -> None:
    """Save a solver state with ``torch.save`` (atomic rename): every dtype
    kept as it is (bfloat16 too), no trip through numpy.  The counterpart of
    the JAX package's ``save_state_orbax``; :func:`save_state` writes the
    npz both packages read."""
    leaves = []
    _flatten(pytree, leaves)
    tmp = path + ".tmp"
    torch.save({"leaves": [torch.as_tensor(leaf).detach().cpu()
                           for leaf in leaves],
                "structure": _structure(pytree)}, tmp)
    os.replace(tmp, path)


def load_state_torch(path: str, like: Any) -> Any:
    """Restore a state saved by :func:`save_state_torch`; ``like`` supplies
    the structure and each leaf's device."""
    data = torch.load(path, map_location="cpu", weights_only=True)
    leaves = data["leaves"]
    if len(leaves) != _num_leaves(like):
        raise ValueError(
            f"checkpoint {path!r} holds {len(leaves)} tensors but the "
            f"template {type(like).__name__} expects {_num_leaves(like)}")

    def place(leaf, ref):
        return leaf.to(ref.device) if isinstance(ref, torch.Tensor) else leaf

    return _unflatten(like, iter(leaves), place)


# the JAX package's names for its second, sharding-capable pair, so that a
# caller's code carries over unchanged
save_state_orbax = save_state_torch
load_state_orbax = load_state_torch


def run_checkpointed(
    solver: Callable[..., Any],
    x_noisy,
    n_iter: int,
    checkpoint_path: str = None,
    checkpoint_every: int = 0,
    **solver_kwargs,
):
    """Run ``solver(x_noisy, n_iter=..., state=..., **kwargs)`` in chunks,
    saving ``result.state`` every ``checkpoint_every`` iterations and resuming
    from ``checkpoint_path`` if it exists.

    The solver must follow the package convention: accept a ``state`` kwarg
    and return a result with ``.state`` and ``.loss`` fields (``chambolle_pock``
    and ``admm`` do).  Returns the final result with the full loss history
    (the resumed part included) as a tensor on the loss's device.

    ``x_noisy`` may be a grid of shards (``parallel.mesh.shard_volume``):
    the checkpoint then holds the state's whole arrays, gathered from its
    grids, under the keys a volume's state has, so that a checkpoint
    written from a grid resumes on the volume and the reverse (and the JAX
    package's ``load_state`` reads it); on resume they are cut onto the
    grids again.  A grid of one process of several raises ``ValueError``:
    it holds only that process's rows.
    """
    if is_grid(x_noisy) and is_distributed(x_noisy):
        raise ValueError(
            "run_checkpointed writes whole arrays, and this grid holds only "
            "this process's rows; take them with "
            "parallel.multihost.global_to_host_local")
    if not checkpoint_every or checkpoint_path is None:
        return solver(x_noisy, n_iter=n_iter, **solver_kwargs)

    state = None
    done = 0
    losses = []
    if os.path.exists(checkpoint_path):
        meta_path = checkpoint_path + ".meta.npz"
        if os.path.exists(meta_path):
            with np.load(meta_path) as meta:
                done = int(meta["done"])
                losses = [meta["losses"]]
        # a template state to restore into
        probe = solver(x_noisy, n_iter=0, **solver_kwargs)
        state = _recut(load_state(checkpoint_path, _whole(probe.state)),
                       probe.state)

    result = None
    while done < n_iter:
        chunk = min(checkpoint_every, n_iter - done)
        result = solver(x_noisy, n_iter=chunk, state=state, **solver_kwargs)
        state = result.state
        losses.append(_to_numpy(result.loss))
        done += chunk
        save_state(checkpoint_path, _whole(state))
        with open(checkpoint_path + ".meta.npz.tmp", "wb") as f:
            np.savez(f, done=done, losses=np.concatenate(losses))
        os.replace(checkpoint_path + ".meta.npz.tmp",
                   checkpoint_path + ".meta.npz")

    if result is None:  # the checkpoint already covers n_iter
        result = solver(x_noisy, n_iter=0, state=state, **solver_kwargs)
    full_loss = np.concatenate(losses) if losses else np.zeros((0,))
    return result._replace(loss=torch.as_tensor(
        full_loss, dtype=result.loss.dtype, device=result.loss.device))


def run_until_converged(
    solver,
    x_noisy,
    tol: float = 1e-6,
    chunk: int = 50,
    max_iter: int = 5000,
    criterion: str = "loss",
    gap_x_box=None,
    gap_norm_bound=None,
    gap_w_box=None,
    gap_operator=None,
    **solver_kwargs,
):
    """Tolerance-based stopping for the fixed-length solvers: run ``solver``
    in device-resident chunks and stop when the convergence criterion falls
    below ``tol`` (or at ``max_iter``).  The criterion is evaluated on the
    device and only its verdict, one scalar, crosses to the host per chunk;
    the stacked loss history stays on the device.

    ``criterion``:

    - ``'loss'`` (default, any solver): relative loss change across a
      chunk, ``|loss[0] - loss[-1]| / |loss[-1]|`` — a heuristic.
    - ``'gap'``: relative primal-dual gap — a CERTIFIED optimality bound,
      gap/P >= (P(x) - P(x*)) / P(x).  For the denoising solvers
      (``chambolle_pock``/``chambolle_pock_precond``, l2 fidelity) this is
      ``solvers.cp.pd_gap``.  For the INVERSE solvers (``cp_inverse`` /
      ``cp_reconstruct`` states) it is ``solvers.inverse.pd_gap_inverse``,
      which additionally needs a compact prior set containing the true
      solution: pass ``gap_x_box=c`` (0 <= x <= c) and/or
      ``gap_norm_bound=R`` (||x||_2 <= R) — these are consumed here, not
      forwarded to the solver.  The forward operator is read from the
      ``functools.partial`` composition (``partial(cp_inverse, A,
      vol_shape=...)`` — the documented pattern) or passed explicitly as
      ``gap_operator=A`` (required for ``cp_reconstruct``, whose projector
      is built internally: reuse ``models.ct.make_projector``).  TGV
      inverse states use ``solvers.tgv.tgv_gap_inverse`` (pass alpha1/
      alpha0 explicitly; ``gap_w_box`` bounds the auxiliary field,
      defaulting to ``gap_x_box`` — the gradient bound of a [0, c] image).

    Works with any solver following the package convention: ``chambolle_pock``
    and ``admm`` resume via their ``state`` kwarg; ``subgradient_descent``
    (no carried dual) resumes via ``x_init``.  Returns the solver's result
    type with the concatenated loss history.

    ``x_noisy`` may be a grid of shards: the solver runs its grid path, the
    losses are already sums over shards, and ``'gap'`` takes the denoising
    CP states' gap with its scalars summed over shards
    (``solvers.cp.pd_gap``); the inverse solvers' gaps need the whole
    operator and take volumes.
    """
    if criterion not in ("loss", "gap"):
        raise ValueError(
            f"criterion must be 'loss' or 'gap', got {criterion!r}"
        )
    takes_state = "state" in inspect.signature(solver).parameters
    # The gap is computed against the *objective the solver optimizes*; a
    # caller composing via functools.partial(chambolle_pock, reg=...) bakes
    # that objective into the solver, so merge partial keywords into the
    # lookup (call-site solver_kwargs win, matching call semantics).
    gap_kwargs = dict(solver_kwargs)
    gap_pos_args = []
    f = solver
    while isinstance(f, functools.partial):
        for k, v in (f.keywords or {}).items():
            gap_kwargs.setdefault(k, v)
        # partial(partial(f, *a1), *a2) calls f(*a1, *a2): inner args lead
        gap_pos_args = list(f.args) + gap_pos_args
        f = f.func
    is_tgv = "alpha1" in inspect.signature(f).parameters
    if criterion == "gap":
        if is_tgv and ("alpha1" not in gap_kwargs
                       or "alpha0" not in gap_kwargs):
            raise ValueError(
                "criterion='gap' on a TGV solver computes the gap of "
                "F + a1 N(Dx - w) + a0 N(Ew) and needs the SAME alphas the "
                "solver uses — pass alpha1= and alpha0= explicitly; "
                "refusing to silently default"
            )
        if not is_tgv and "reg" not in gap_kwargs:
            raise ValueError(
                "criterion='gap' computes the duality gap of the objective "
                "F(x) + reg*TV(x) and needs the SAME reg the solver uses — "
                "pass reg= explicitly (as a kwarg here or on a "
                "functools.partial solver); refusing to silently default"
            )
        if not takes_state:
            raise ValueError(
                "criterion='gap' needs a solver that carries a primal-dual "
                "state (chambolle_pock / cp_inverse); loss-based stopping "
                "works for all solvers"
            )
        if (gap_kwargs.get("fidelity", "l2") != "l2"
                and gap_x_box is None and gap_norm_bound is None):
            # fail FAST, before a whole chunk of solve: without a prior
            # set this can only be the denoising gap, which is l2-only
            # (the inverse gap supports l1/kl but requires gap_x_box /
            # gap_norm_bound anyway)
            raise ValueError(
                "criterion='gap' certifies the l2-fidelity denoising "
                "objective (solvers.cp.pd_gap) — use criterion='loss' for "
                "fidelity='l1'/'kl' denoising, or, for the INVERSE "
                "solvers (which support all three), pass the prior set "
                "(gap_x_box=/gap_norm_bound=)"
            )
    state = None
    x_init = None
    losses = []
    done = 0
    result = None
    prev_last_loss = None
    while done < max_iter:
        n = min(chunk, max_iter - done)
        if takes_state:
            result = solver(x_noisy, n_iter=n, state=state, **solver_kwargs)
            state = result.state
        else:
            result = solver(x_noisy, n_iter=n, x_init=x_init, **solver_kwargs)
            x_init = result.x
        loss = result.loss
        losses.append(loss)
        done += n
        last = loss[-1]
        if criterion == "gap":
            gap = _gap(state, x_noisy, gap_kwargs, gap_pos_args, gap_operator,
                       gap_x_box, gap_norm_bound, gap_w_box)
            if bool(gap <= tol * torch.abs(last)):
                break
        else:
            # Compare against the previous chunk's last loss so a length-1
            # chunk (chunk=1, or a trailing remainder of 1) cannot trivially
            # report convergence via loss[0] == loss[-1].
            ref = loss[0] if len(loss) > 1 else prev_last_loss
            if (ref is not None
                    and bool(torch.abs(ref - last) <= tol * torch.abs(last))):
                break
        prev_last_loss = last
    return result._replace(loss=torch.cat(losses))


def _gap(state, x_noisy, gap_kwargs, gap_pos_args, gap_operator, gap_x_box,
         gap_norm_bound, gap_w_box):
    """The duality gap of ``state`` by its type, a scalar on the device."""
    from ..utils.device import on_device
    from .cp import CPPrecondState, CPState, pd_gap
    from .inverse import InverseState, pd_gap_inverse
    from .tgv import TGVInverseState, tgv_gap_inverse

    def _operator():
        A = gap_operator
        if A is None and gap_pos_args and callable(gap_pos_args[0]):
            A = gap_pos_args[0]  # partial(cp_inverse, A, ...)
        if A is None:
            raise ValueError(
                "criterion='gap' on an inverse-solver state needs "
                "the forward operator: compose the solver as "
                "functools.partial(cp_inverse, A, vol_shape=...) "
                "or pass gap_operator=A (for cp_reconstruct / "
                "tgv_reconstruct, build A via "
                "models.ct.make_projector)"
            )
        return A

    # type dispatch FIRST: states without a y_D field (ADMM, TGV
    # denoising) must get the clear unsupported-solver error, not
    # an AttributeError
    if isinstance(state, TGVInverseState):
        b = on_device(x_noisy, state.x.device).to(state.x.dtype)
        return tgv_gap_inverse(
            state, _operator(), b,
            alpha1=gap_kwargs["alpha1"],
            alpha0=gap_kwargs["alpha0"],
            axes=gap_kwargs.get("axes", "2d"),
            norm=gap_kwargs.get("norm", "iso"),
            huber_delta=gap_kwargs.get("huber_delta", 1.0),
            fidelity=gap_kwargs.get("fidelity", "l2"),
            fidelity_weight=gap_kwargs.get("fidelity_weight", 1.0),
            x_box=gap_x_box,
            w_box=gap_w_box,
            A_T=gap_kwargs.get("A_T"),
        )
    if isinstance(state, InverseState):
        b = on_device(x_noisy, state.x.device).to(state.x.dtype)
        return pd_gap_inverse(
            state, _operator(), b,
            reg=gap_kwargs["reg"],
            cfg=gap_kwargs.get("cfg", _default_cfg()),
            fidelity=gap_kwargs.get("fidelity", "l2"),
            fidelity_weight=gap_kwargs.get("fidelity_weight", 1.0),
            x_box=gap_x_box,
            norm_bound=gap_norm_bound,
            A_T=gap_kwargs.get("A_T"),
        )
    if is_grid(state.x) and not isinstance(state,
                                           (CPState, CPPrecondState)):
        raise ValueError(
            "criterion='gap' on a grid of shards takes the denoising CP "
            "states (solvers.cp.pd_gap); the inverse solvers' gaps apply "
            "the whole forward operator and take volumes")
    if isinstance(state, (CPState, CPPrecondState)):
        if gap_kwargs.get("fidelity", "l2") != "l2":
            raise ValueError(
                "criterion='gap' certifies the l2-fidelity "
                "denoising objective (solvers.cp.pd_gap) — use "
                "criterion='loss' for fidelity='l1'/'kl' denoising "
                "(the inverse solvers' gap supports all three)"
            )
        if state.y_D is None:
            raise ValueError(
                "criterion='gap' needs the dual in the state — do "
                "not pass return_dual=False"
            )
        return pd_gap(
            state, x_noisy,
            reg=gap_kwargs["reg"],
            cfg=gap_kwargs.get("cfg", _default_cfg()),
            mask_static=gap_kwargs.get("mask_static"),
            weight_time=gap_kwargs.get("weight_time"),
        )
    raise ValueError(
        f"criterion='gap' supports the denoising CP solvers "
        f"and the inverse solvers (cp_inverse/cp_reconstruct/"
        f"tgv_inverse) — got {type(state).__name__}"
    )


def _default_cfg():
    from ..core.config import TVConfig

    return TVConfig()
