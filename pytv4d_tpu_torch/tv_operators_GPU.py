"""The reference's ``pytv.tv_operators_GPU`` module under its own name
(``pytv/tv_operators_GPU.py:46-1052``), on PyTorch again; the port of
``pytv4d_tpu/tv_operators_TPU.py``.

- A tensor in gives a tensor out, on its own device
  (``tv_operators_GPU.py:181-182``).
- A numpy array goes to ``torch.device("cuda")``, as the reference's
  ``torch.as_tensor(img).cuda()`` does (``:179``), as float32 (the dtype
  the JAX package's device path computes in); without a GPU that raises,
  it never runs on the CPU.  The result comes back as numpy (``:247``)
  unless ``return_pytorch_tensor=True`` (or its alias
  ``return_device_array=True``) asks for the tensor.

Also provides ``type_like`` (``tv_operators_GPU.py:92-131``): match an
array's dtype and kind (numpy or tensor) to a template.
"""

from __future__ import annotations

import numpy as np
import torch

from .ops import api as _api
from .utils.device import on_device

__all__ = [
    "compute_L21_norm",
    "type_like",
    "D_upwind",
    "D_downwind",
    "D_central",
    "D_hybrid",
    "D_T_upwind",
    "D_T_downwind",
    "D_T_central",
    "D_T_hybrid",
]


def _want_tensor(img, kwargs) -> bool:
    # Pop both spellings; tensor-in forces tensor-out (tv_operators_GPU.py:181-182).
    want = bool(kwargs.pop("return_device_array", False))
    want = bool(kwargs.pop("return_pytorch_tensor", False)) or want
    if kwargs:
        raise TypeError(f"unexpected kwargs {sorted(kwargs)}")
    return want or isinstance(img, torch.Tensor)


def _on_device(img):
    """A tensor as it is; anything else as a float32 tensor on the GPU
    (``utils.device.on_device``)."""
    return on_device(img, dtype=torch.float32)


def _to_host(t):
    """A tensor as a numpy array (bfloat16 widens to float32)."""
    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def type_like(x, template):
    """Cast ``x`` to the dtype and kind (numpy array or tensor, and the
    tensor's device) of ``template`` — the 4-case table of
    ``tv_operators_GPU.py:92-131`` generalized."""
    if isinstance(template, torch.Tensor):
        return torch.as_tensor(x, dtype=template.dtype, device=template.device)
    template = np.asarray(template)
    if isinstance(x, torch.Tensor):
        x = _to_host(x)
    return np.asarray(x, dtype=template.dtype)


def compute_L21_norm(D_img, return_array=False, **kwargs):
    """See ``pytv/tv_operators_GPU.py:46-90``; the result moves to the host
    unless a tensor is asked for (``:84-90``)."""
    want = _want_tensor(D_img, kwargs)
    out = _api.compute_L21_norm(_on_device(D_img), return_array=return_array)
    if return_array:
        l21, arr = out
        return (l21, arr) if want else (float(l21), _to_host(arr))
    return out if want else float(out)


def _make(base, name):
    def fn(
        img,
        reg_z_over_reg=1.0,
        reg_time=0,
        mask_static=False,
        factor_reg_static=0,
        **kwargs,
    ):
        want = _want_tensor(img, kwargs)
        out = base(
            _on_device(img),
            reg_z_over_reg=reg_z_over_reg,
            reg_time=reg_time,
            mask_static=_api.normalize_mask(mask_static),
            factor_reg_static=factor_reg_static,
        )
        return out if want else _to_host(out)

    fn.__name__ = name
    fn.__qualname__ = name
    fn.__doc__ = f"GPU {name}; parity with pytv/tv_operators_GPU.py."
    return fn


D_upwind = _make(_api.D_upwind, "D_upwind")
D_downwind = _make(_api.D_downwind, "D_downwind")
D_central = _make(_api.D_central, "D_central")
D_hybrid = _make(_api.D_hybrid, "D_hybrid")
D_T_upwind = _make(_api.D_T_upwind, "D_T_upwind")
D_T_downwind = _make(_api.D_T_downwind, "D_T_downwind")
D_T_central = _make(_api.D_T_central, "D_T_central")
D_T_hybrid = _make(_api.D_T_hybrid, "D_T_hybrid")
