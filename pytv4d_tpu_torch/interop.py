"""Carrying solver state and configuration between the JAX package and the
port.

The "weights" of this system are its solver state and config, so these
three functions are what a run needs to move across: a JAX CP run resumes
in the port with ``state_from_numpy(*map(np.asarray, jax_state))``, and a
port run resumes in JAX with ``CPState(*state_to_numpy(state))``.  Configs
carry as plain fields: ``config_from_fields(**dataclasses.asdict(cfg))``.
Arrays cross as numpy, so neither package imports the other.

Subgradient descent needs nothing more: its only state is the iterate x,
which resumes as ``x_init`` (``torch.as_tensor(np.asarray(jax_result.x))``
one way, ``np.asarray`` of the port's ``GDResult.x`` the other).
"""

from __future__ import annotations

import numpy as np
import torch

from .core.config import TVConfig
from .solvers.cp import CPState


def state_from_numpy(x, y_A, y_D, device="cpu", dtype=None) -> CPState:
    """A port :class:`CPState` from numpy arrays in the public layouts:
    ``x``, ``y_A`` ``(Nz, M, Nr, Nc)`` and ``y_D`` ``(Nz, Nd, M, Nr, Nc)``.
    ``dtype`` (a torch dtype) defaults to that of ``x``."""
    x = torch.tensor(np.asarray(x), dtype=dtype, device=device)

    def conv(a):
        return torch.tensor(np.asarray(a), dtype=x.dtype, device=device)

    y_D = None if y_D is None else conv(y_D)
    return CPState(x, conv(y_A), y_D)


def state_to_numpy(state: CPState):
    """``(x, y_A, y_D)`` as numpy arrays in the public layouts (bf16 state
    widens to float32; a dropped dual stays None)."""
    def conv(t):
        if t is None:
            return None
        if t.dtype == torch.bfloat16:
            t = t.float()
        return t.detach().cpu().numpy()

    return conv(state.x), conv(state.y_A), conv(state.y_D)


def config_from_fields(**fields) -> TVConfig:
    """The port's :class:`TVConfig` from a config's fields (for example
    ``dataclasses.asdict`` of the JAX package's ``TVConfig``)."""
    return TVConfig(**fields)
