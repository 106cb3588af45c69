"""The reference's ``pytv.tv_GPU`` module under its own name
(``pytv/tv_GPU.py:47-376``); the port of ``pytv4d_tpu/tv_TPU.py``.

Returns ``(tv, G[, grad_norms])`` through ``ops.api.tv_and_subgrad``: on a
CUDA tensor the fused kernels B3/B4 compute it.  The input and output rules
are those of :mod:`tv_operators_GPU`: a tensor in gives tensors out on its
device; a numpy array goes to the GPU as float32 (raising where there is
none) and comes back as a float and numpy arrays (``tv_GPU.py:129-139``)
unless ``return_pytorch_tensor=True`` (alias ``return_device_array``).
"""

from __future__ import annotations

from .ops import api as _api
from .tv_operators_GPU import _on_device, _to_host, _want_tensor

__all__ = ["tv_upwind", "tv_downwind", "tv_central", "tv_hybrid"]


def _make(base, name):
    def fn(
        img,
        mask=[],
        reg_z_over_reg=1.0,
        reg_time=0.0,
        mask_static=False,
        factor_reg_static=0,
        return_grad_norms=False,
        **kwargs,
    ):
        want = _want_tensor(img, kwargs)
        out = base(
            _on_device(img),
            mask=_api.normalize_mask(mask),
            reg_z_over_reg=reg_z_over_reg,
            reg_time=reg_time,
            mask_static=_api.normalize_mask(mask_static),
            factor_reg_static=factor_reg_static,
            return_grad_norms=return_grad_norms,
        )
        if want:
            return out
        return (float(out[0]),) + tuple(_to_host(a) for a in out[1:])

    fn.__name__ = name
    fn.__qualname__ = name
    fn.__doc__ = f"GPU {name}; parity with pytv/tv_GPU.py."
    return fn


tv_upwind = _make(_api.tv_upwind, "tv_upwind")
tv_downwind = _make(_api.tv_downwind, "tv_downwind")
tv_central = _make(_api.tv_central, "tv_central")
tv_hybrid = _make(_api.tv_hybrid, "tv_hybrid")
