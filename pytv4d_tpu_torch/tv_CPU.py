"""The reference's ``pytv.tv_CPU`` module under its own name
(``pytv/tv_CPU.py:47-333``); the port of ``pytv4d_tpu/tv_CPU.py``.

NumPy in, NumPy out: the array is wrapped as a CPU tensor
(``torch.from_numpy``, float64 for the reference's float64 input) and runs
the port's ``ops.tv`` there, never on the GPU.  Returns ``(tv, G)`` (and
``grad_norms`` with ``return_grad_norms=True``): ``tv`` a NumPy scalar, the
rest NumPy arrays.  The reference's broken ``mask`` handling
(``tv_CPU.py:77`` raises on an array, SURVEY.md section 2.4.2) is fixed as
in the JAX package: a boolean mask array applies as
``img = where(mask, img, 0)``.
"""

from __future__ import annotations

from .ops import tv as _tv
from .tv_operators_CPU import _from_host, _to_host

__all__ = ["tv_upwind", "tv_downwind", "tv_central", "tv_hybrid"]


def _make(scheme):
    def fn(
        img,
        mask=[],
        reg_z_over_reg=1.0,
        reg_time=0.0,
        mask_static=False,
        factor_reg_static=0,
        return_grad_norms=False,
    ):
        out = _tv.tv_and_subgrad(
            _from_host(img),
            scheme,
            mask=mask,
            reg_z_over_reg=reg_z_over_reg,
            reg_time=reg_time,
            mask_static=mask_static,
            factor_reg_static=factor_reg_static,
            return_grad_norms=return_grad_norms,
        )
        return tuple(_to_host(a) for a in out)

    fn.__name__ = f"tv_{scheme}"
    fn.__qualname__ = fn.__name__
    fn.__doc__ = (f"NumPy tv_{scheme} on the CPU; reference parity with "
                  f"pytv/tv_CPU.py.")
    return fn


tv_upwind = _make("upwind")
tv_downwind = _make("downwind")
tv_central = _make("central")
tv_hybrid = _make("hybrid")
