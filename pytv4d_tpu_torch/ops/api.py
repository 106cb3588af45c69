"""Public device-native entry points (the port of ``pytv4d_tpu/ops/api.py``).

The reference re-launches unfused kernels and round-trips host<->device on
every call (``tv_operators_GPU.py:179,247`` — SURVEY.md section 3.2).  Here
data stays on the tensor's device, and :func:`tv_and_subgrad` takes the
fused TV kernels (B3/B4) for a CUDA tensor they support.  PyTorch runs
eagerly, so these are plain functions: there is no executable cache.

Every function here takes a tensor, which stays on its device, or a numpy
array, which goes to the CUDA device (``RuntimeError`` where there is none)
unless ``device=`` names another (``utils.device.on_device``).  Each also
takes a grid of shards (``parallel.mesh.shard_volume``, or for ``D_T`` and
``compute_L21_norm`` ``shard_d_volume``) and returns grids of the same
layout (``parallel.entry``).
"""

from __future__ import annotations

from ..core.config import TVConfig
from ..parallel.mesh import is_grid
from ..utils.device import on_device
from . import operators as _ops
from . import tv as _tv


def _on_device_first(base, on_grid: str):
    """``base`` with its first argument placed by ``on_device``; a grid of
    shards goes to ``parallel.entry``'s function ``on_grid``."""
    def fn(arr, *args, device=None, **kwargs):
        if is_grid(arr):
            from ..parallel import entry

            return getattr(entry, on_grid)(arr, *args, device=device,
                                           **kwargs)
        return base(on_device(arr, device), *args, **kwargs)

    fn.__name__ = fn.__qualname__ = base.__name__
    fn.__doc__ = base.__doc__
    return fn


D = _on_device_first(_ops.D, "D")
D_T = _on_device_first(_ops.D_T, "D_T")
compute_L21_norm = _on_device_first(_ops.compute_L21_norm, "L21_norm")


def tv_and_subgrad(img, scheme="hybrid", mask=None, reg_z_over_reg=1.0,
                   reg_time=0.0, mask_static=None, factor_reg_static=0.0,
                   weight_time=None, return_grad_norms=False,
                   norm_type="iso", huber_delta=1.0, device=None):
    """tv + subgradient on the tensor's device: the fused kernels
    (``kernels.fused.tv_and_subgrad_fused``) for a rank-4 CUDA tensor without
    ``mask`` that ``kernels.dispatch.can_fuse`` accepts (iso, aniso or huber
    norm, float32/bfloat16, plane-shaped static masks / weight_time), else
    ``ops.tv.tv_and_subgrad`` — the same numbers to f32 round-off either
    way.  A grid of shards takes ``parallel.entry.tv_and_subgrad``: B3 and
    B4 in their halo mode on CUDA shards the kernels serve, else
    ``parallel.halo.sharded_tv_and_subgrad``."""
    from ..kernels.dispatch import can_fuse, t_plane_multiplier

    if is_grid(img):
        from ..parallel import entry

        return entry.tv_and_subgrad(
            img, scheme=scheme, mask=mask, reg_z_over_reg=reg_z_over_reg,
            reg_time=reg_time, mask_static=mask_static,
            factor_reg_static=factor_reg_static, weight_time=weight_time,
            return_grad_norms=return_grad_norms, norm_type=norm_type,
            huber_delta=huber_delta, device=device)
    img = on_device(img, device)
    cfg = TVConfig(scheme=scheme, reg_z_over_reg=reg_z_over_reg,
                   reg_time=reg_time, factor_reg_static=factor_reg_static,
                   norm=norm_type, huber_delta=huber_delta)
    shape = tuple(img.shape)
    if (not _ops.mask_enabled(mask) and img.ndim == 4 and img.is_cuda
            and can_fuse(shape, cfg, mask_static=mask_static,
                         dtype=img.dtype, weight_time=weight_time,
                         for_gd=True)):
        from ..kernels.fused import tv_and_subgrad_fused

        tmul = t_plane_multiplier(shape, cfg, mask_static, weight_time,
                                  dtype=img.dtype, device=img.device)
        if tmul is not None:
            tmul = tmul.float().contiguous()
        return tv_and_subgrad_fused(img.contiguous(), cfg,
                                    return_grad_norms=return_grad_norms,
                                    tmul=tmul)
    return _tv.tv_and_subgrad(img, scheme=scheme, mask=mask,
                              reg_z_over_reg=reg_z_over_reg,
                              reg_time=reg_time,
                              mask_static=mask_static,
                              factor_reg_static=factor_reg_static,
                              weight_time=weight_time,
                              return_grad_norms=return_grad_norms,
                              norm_type=norm_type, huber_delta=huber_delta)


def normalize_mask(mask_static):
    """Map the reference's bool sentinel (``tv_operators_CPU.py:148``) and
    ``[]`` to None: "no mask"."""
    if _ops.mask_enabled(mask_static):
        return mask_static
    return None


def _scheme_fn(base, scheme):
    def fn(img, **kwargs):
        kwargs["mask_static"] = normalize_mask(kwargs.get("mask_static"))
        if "mask" in kwargs:
            kwargs["mask"] = normalize_mask(kwargs.get("mask"))
        return base(img, scheme=scheme, **kwargs)

    fn.__name__ = f"{getattr(base, '__name__', 'fn')}_{scheme}"
    fn.__qualname__ = fn.__name__
    return fn


D_upwind = _scheme_fn(D, "upwind")
D_downwind = _scheme_fn(D, "downwind")
D_central = _scheme_fn(D, "central")
D_hybrid = _scheme_fn(D, "hybrid")
D_T_upwind = _scheme_fn(D_T, "upwind")
D_T_downwind = _scheme_fn(D_T, "downwind")
D_T_central = _scheme_fn(D_T, "central")
D_T_hybrid = _scheme_fn(D_T, "hybrid")
tv_upwind = _scheme_fn(tv_and_subgrad, "upwind")
tv_downwind = _scheme_fn(tv_and_subgrad, "downwind")
tv_central = _scheme_fn(tv_and_subgrad, "central")
tv_hybrid = _scheme_fn(tv_and_subgrad, "hybrid")
