"""Carrying solver state and configuration between the JAX package and the
port.

The "weights" of this system are its solver state and config, so these
functions are what a run needs to move across: a JAX CP run resumes in the
port with ``state_from_numpy(*map(np.asarray, jax_state), device=...)``, a
JAX TGV run with ``tgv_state_from_numpy(*map(np.asarray, jax_state),
device=...)``, a JAX inverse or CT run with
``inverse_state_from_numpy(jax_state, device=...)``, and a port run resumes
in JAX with ``CPState(*state_to_numpy(state))``.  The preconditioned CP, ADMM
and FISTA runs carry the same way (``precond_state_from_numpy``,
``admm_state_from_numpy``, ``fista_dual_from_numpy``), and
``solvers.state.save_state`` writes an npz that both packages load.
Configs carry as plain fields:
``config_from_fields(**dataclasses.asdict(cfg))``.  Arrays cross as numpy,
so neither package imports the other.  ``device`` is always named: nothing
here picks the CPU by default.

Subgradient descent needs nothing more: its only state is the iterate x,
which resumes as ``x_init`` (``torch.as_tensor(np.asarray(jax_result.x))``
one way, ``np.asarray`` of the port's ``GDResult.x`` the other).
"""

from __future__ import annotations

import numpy as np
import torch

from .core.config import TVConfig
from .solvers.admm import ADMMState
from .solvers.cp import CPPrecondState, CPState
from .solvers.inverse import InverseState
from .solvers.tgv import TGVState


def _from_numpy(arrays, device, dtype):
    """Tensors on ``device`` in ``dtype`` (default: the first array's own);
    None stays None."""
    first = torch.tensor(np.asarray(arrays[0]), dtype=dtype, device=device)
    rest = [None if a is None else
            torch.tensor(np.asarray(a), dtype=first.dtype, device=device)
            for a in arrays[1:]]
    return [first, *rest]


def state_from_numpy(x, y_A, y_D, *, device, dtype=None) -> CPState:
    """A port :class:`CPState` on ``device`` from numpy arrays in the public
    layouts: ``x``, ``y_A`` ``(Nz, M, Nr, Nc)`` and ``y_D``
    ``(Nz, Nd, M, Nr, Nc)``.  ``dtype`` (a torch dtype) defaults to that of
    ``x``."""
    return CPState(*_from_numpy((x, y_A, y_D), device, dtype))


def precond_state_from_numpy(x, x_bar, y_A, y_D, *, device,
                             dtype=None) -> CPPrecondState:
    """A port :class:`CPPrecondState` on ``device`` from numpy arrays in
    the public layouts: ``x``, ``x_bar``, ``y_A`` ``(Nz, M, Nr, Nc)`` and
    ``y_D`` ``(Nz, Nd, M, Nr, Nc)``.  ``dtype`` (a torch dtype) defaults to
    that of ``x``."""
    return CPPrecondState(*_from_numpy((x, x_bar, y_A, y_D), device, dtype))


def admm_state_from_numpy(x, z, u, *, device, dtype=None) -> ADMMState:
    """A port :class:`ADMMState` on ``device`` from numpy arrays in the
    public layouts: ``x`` ``(Nz, M, Nr, Nc)``, ``z`` and ``u``
    ``(Nz, Nd, M, Nr, Nc)``.  ``dtype`` (a torch dtype) defaults to that of
    ``x``."""
    return ADMMState(*_from_numpy((x, z, u), device, dtype))


def fista_dual_from_numpy(y, *, device, dtype=None):
    """FISTA's only carried state, the dual ``y`` ``(Nz, Nd, M, Nr, Nc)``,
    as a tensor on ``device`` for ``fista(..., y_init=...)``.  ``dtype`` (a
    torch dtype) defaults to the array's own."""
    return _from_numpy((y,), device, dtype)[0]


def tgv_state_from_numpy(x, xb, w, wb, p, q, *, device,
                         dtype=None) -> TGVState:
    """A port :class:`TGVState` on ``device`` from numpy arrays in the
    public layouts: ``x``, ``xb`` ``(Nz, M, Nr, Nc)``; ``w``, ``wb``, ``p``
    ``(Nz, n, M, Nr, Nc)``; ``q`` ``(Nz, n(n+1)/2, M, Nr, Nc)``.  ``dtype``
    (a torch dtype) defaults to that of ``x``."""
    return TGVState(*_from_numpy((x, xb, w, wb, p, q), device, dtype))


def inverse_state_from_numpy(state, *, device, dtype=None) -> InverseState:
    """A port :class:`InverseState` on ``device`` from a state of arrays in
    the public layouts (the JAX package's ``InverseState``, or any sequence
    of its fields): ``x``, ``x_bar`` ``(Nz, M, Nr, Nc)``, ``y_A`` shaped
    like the data, ``y_D`` ``(Nz, Nd, M, Nr, Nc)``, and the projections
    ``s_x``, ``s_x_bar``, which may be None or missing.  ``dtype`` (a torch
    dtype) defaults to that of ``x``."""
    fields = tuple(state) + (None,) * (len(InverseState._fields) - len(state))
    return InverseState(*_from_numpy(fields, device, dtype))


def state_to_numpy(state):
    """The fields of a :class:`CPState`, :class:`CPPrecondState`,
    :class:`ADMMState`, :class:`TGVState` or :class:`InverseState` as numpy
    arrays in the public layouts (bf16 state widens to float32; a dropped
    dual stays None)."""
    def conv(t):
        if t is None:
            return None
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.detach().cpu().numpy()

    return tuple(conv(t) for t in state)


def config_from_fields(**fields) -> TVConfig:
    """The port's :class:`TVConfig` from a config's fields (for example
    ``dataclasses.asdict`` of the JAX package's ``TVConfig``)."""
    return TVConfig(**fields)
