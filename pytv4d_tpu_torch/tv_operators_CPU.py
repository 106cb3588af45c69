"""The reference's ``pytv.tv_operators_CPU`` module under its own name
(``pytv/tv_operators_CPU.py:45-658``); the port of
``pytv4d_tpu/tv_operators_CPU.py``.

NumPy in, NumPy out: the array runs the port's ``ops.operators`` as a CPU
tensor (``torch.from_numpy``), never on the GPU.  In float64 it reproduces
the reference CPU path's golden values to round-off (and ``README.md:91``'s
``tv_hybrid`` value 532166.8251801673).  Use ``tv_operators_GPU`` or
``ops.api`` for speed.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops import operators as _ops

__all__ = [
    "compute_L21_norm",
    "D_upwind",
    "D_downwind",
    "D_central",
    "D_hybrid",
    "D_T_upwind",
    "D_T_downwind",
    "D_T_central",
    "D_T_hybrid",
]


def _from_host(a):
    """An array as a CPU tensor sharing its memory (a copy only where it is
    not C-contiguous and writeable)."""
    return torch.from_numpy(np.require(a, requirements=("C", "W")))


def _to_host(t):
    """A CPU tensor as NumPy: an array, or a NumPy scalar where 0-d."""
    return t.numpy()[()]


def compute_L21_norm(D_img, return_array=False):
    """See ``pytv/tv_operators_CPU.py:45-74``."""
    out = _ops.compute_L21_norm(_from_host(D_img), return_array=return_array)
    if return_array:
        return tuple(_to_host(a) for a in out)
    return _to_host(out)


def _make(base, scheme):
    def fn(img, reg_z_over_reg=1.0, reg_time=0, mask_static=False,
           factor_reg_static=0):
        return _to_host(base(
            _from_host(img),
            scheme,
            reg_z_over_reg=reg_z_over_reg,
            reg_time=reg_time,
            mask_static=mask_static,
            factor_reg_static=factor_reg_static,
        ))

    fn.__name__ = f"{base.__name__}_{scheme}"
    fn.__qualname__ = fn.__name__
    fn.__doc__ = (
        f"NumPy {base.__name__}(scheme={scheme!r}) on the CPU; reference "
        f"parity with pytv/tv_operators_CPU.py."
    )
    return fn


D_upwind = _make(_ops.D, "upwind")
D_downwind = _make(_ops.D, "downwind")
D_central = _make(_ops.D, "central")
D_hybrid = _make(_ops.D, "hybrid")
D_T_upwind = _make(_ops.D_T, "upwind")
D_T_downwind = _make(_ops.D_T, "downwind")
D_T_central = _make(_ops.D_T, "central")
D_T_hybrid = _make(_ops.D_T, "hybrid")
