"""Frozen TV-operator configuration.

The reference's de-facto config is the 5-kwarg signature repeated on every
function (``pytv/tv_operators_CPU.py:76``, ``pytv/tv_CPU.py:47``; SURVEY.md
section 5 "Config / flag system").  Here it is one hashable dataclass, a copy
of ``pytv4d_tpu/core/config.py`` with the same fields and validation, so a
JAX config carries across with ``interop.config_from_fields``.
"""

from __future__ import annotations

import dataclasses

from .schemes import SCHEMES


@dataclasses.dataclass(frozen=True)
class TVConfig:
    """Static TV-operator configuration.

    scheme            : one of 'upwind', 'downwind', 'central', 'hybrid'
    reg_z_over_reg    : z-direction regularization ratio; z channels dropped
                        when <= 0 or Nz == 1 (``tv_operators_CPU.py:111``)
    reg_time          : time regularization ratio (mu); time channels are
                        opt-in via reg_time > 0 (``tv_operators_CPU.py:113``)
    factor_reg_static : extra sqrt-factor applied to time channels under the
                        static mask (``tv_operators_CPU.py:148-151``)
    norm              : 'iso' = isotropic L2,1 TV (the reference's definition);
                        'aniso' = anisotropic L1,1 TV (sum of |differences|);
                        'huber' = Huber-smoothed isotropic TV (quadratic below
                        ``huber_delta`` — differentiable everywhere, no
                        inf-trick needed; framework extensions, not in the
                        reference)
    huber_delta       : Huber transition point (only meaningful with
                        norm='huber'; must be > 0 there)
    """

    scheme: str = "hybrid"
    reg_z_over_reg: float = 1.0
    reg_time: float = 0.0
    factor_reg_static: float = 0.0
    norm: str = "iso"  # 'iso' (L2,1), 'aniso' (L1,1) or 'huber'
    huber_delta: float = 1.0

    def __post_init__(self):
        if self.scheme not in SCHEMES:
            raise ValueError(
                f"unknown scheme {self.scheme!r}; expected one of {SCHEMES}"
            )
        if self.norm not in ("iso", "aniso", "huber"):
            raise ValueError(
                f"unknown norm {self.norm!r}; expected 'iso', 'aniso' or "
                f"'huber'"
            )
        if self.norm == "huber" and not self.huber_delta > 0:
            raise ValueError(
                f"norm='huber' needs huber_delta > 0, got {self.huber_delta}"
            )

    def kwargs(self) -> dict:
        """Reference-style kwargs dict for the functional operator API."""
        return dict(
            reg_z_over_reg=self.reg_z_over_reg,
            reg_time=self.reg_time,
            factor_reg_static=self.factor_reg_static,
        )
