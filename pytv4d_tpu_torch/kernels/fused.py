"""The fused Chambolle-Pock step: CUDA kernels B1/B2 and their plain versions.

One CP iteration is two passes over the volume:

- pass A, :func:`cp_dual` (kernel ``cp_dual_kernel`` in ``csrc/cp_fused.cu``;
  replaces ``pytv4d_tpu/kernels/fused.py::make_cp_dual_kernel``): fidelity
  dual prox, every weighted D channel of the scheme table, the TV dual prox
  (iso ball, aniso box, Huber shrink + ball) and one TV partial of D x per
  block.  Writes y_A and y_D in place.
- pass B, :func:`cp_primal` (kernel ``cp_primal_kernel``; replaces
  ``make_cp_primal_kernel``): ``x' = x - tau y_A' - tau D^T y_D'``, the
  optional ``nonneg`` clamp and one fidelity partial of x' per block.
  Writes x in place.

Both are bound by HBM bytes (``utils.profiling.cp_traffic_model``): the
kernels keep D x, the prox argument and D^T y' in registers and touch each
array once per pass.  Pass B computes the full adjoint from y_D' at the
pixel and its neighbours instead of the TPU kernel's split adjoint
(``dt_local``), which existed only because VMEM could not hold the dual;
the minimal traffic model already counts that full read of y_D.

y_D lives in the internal channel-contiguous layout ``(Nz, M, Nd, Nr, Nc)``
inside the solver (:func:`to_internal_layout`).  Storage is float32 or
bfloat16, chosen independently for the primary arrays (x, x0, y_A) and the
dual; compute is float32.

Each wrapper takes its plain PyTorch version (:func:`cp_dual_plain`,
:func:`cp_primal_plain`) for tensors on the CPU, which is how the CPU tests
run the fused path.  For CUDA tensors it launches the kernel or raises.
``cp_dual.launches`` / ``cp_primal.launches`` count kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..core.config import TVConfig
from ..core.schemes import BWD, CTR, FWD, channel_weight, scheme_channels
from ..ops.operators import D, D_T, tv_norm
from ..solvers.fidelity import fidelity_dual_prox, fidelity_loss

MAX_CHANNELS = 8      # CP_MAX_CH: channels a thread keeps in registers
MAX_PLANES = 65535    # Nz * M rides gridDim.y
MAX_PLANE_VOXELS = 2**31 - 1
STORAGE_DTYPES = (torch.float32, torch.bfloat16)

_KIND = {FWD: 0, BWD: 1, CTR: 2}
_NORM = {"iso": 0, "aniso": 1, "huber": 2}
_FIDELITY = {"l2": 0, "l1": 1, "kl": 2}


class _CPParams(ctypes.Structure):
    """Mirror of ``struct CPParams`` in ``csrc/cp_fused.cu``."""
    _fields_ = [
        ("Nz", ctypes.c_int), ("M", ctypes.c_int), ("Nr", ctypes.c_int),
        ("Nc", ctypes.c_int), ("Nd", ctypes.c_int),
        ("axis", ctypes.c_int * MAX_CHANNELS),
        ("kind", ctypes.c_int * MAX_CHANNELS),
        ("w", ctypes.c_float * MAX_CHANNELS),
        ("norm", ctypes.c_int), ("fidelity", ctypes.c_int),
        ("nonneg", ctypes.c_int), ("has_tmul", ctypes.c_int),
        ("sigma_D", ctypes.c_float), ("sigma_A", ctypes.c_float),
        ("reg", ctypes.c_float), ("tau", ctypes.c_float),
        ("fid_weight", ctypes.c_float), ("huber_delta", ctypes.c_float),
        ("fid_den", ctypes.c_float), ("kl_c", ctypes.c_float),
        ("huber_den", ctypes.c_float), ("fid_scale", ctypes.c_float),
    ]


def fits_kernel(shape, Nd: int, dtype=torch.float32) -> bool:
    """Shape guard of the CUDA kernels: a 4D volume stored as float32 or
    bfloat16, at most :data:`MAX_CHANNELS` channels, ``Nz * M`` planes
    within the grid's y extent and an ``Nr * Nc`` plane indexable by int."""
    if len(shape) != 4 or dtype not in STORAGE_DTYPES:
        return False
    Nz, M, Nr, Nc = shape
    return (0 < Nd <= MAX_CHANNELS and 0 < Nz * M <= MAX_PLANES
            and 0 < Nr * Nc <= MAX_PLANE_VOXELS)


@functools.lru_cache(maxsize=64)
def _params(cfg: TVConfig, shape, has_tmul, sigma_D=0.5, sigma_A=1.0,
            reg=1.0, tau=0.1, fidelity="l2", fid_weight=1.0, nonneg=False):
    """The kernels' launch parameters: the channel table of ``cfg`` at
    ``shape`` (weights as ``make_cp_dual_kernel``'s ``_build`` computes
    them) and the step's scalars."""
    Nz, M, Nr, Nc = shape
    chans, norm = scheme_channels(cfg.scheme, Nz, M, cfg.reg_z_over_reg,
                                  cfg.reg_time)
    p = _CPParams(Nz=Nz, M=M, Nr=Nr, Nc=Nc, Nd=len(chans))
    for i, ch in enumerate(chans):
        p.axis[i] = ch.axis
        p.kind[i] = _KIND[ch.kind]
        p.w[i] = channel_weight(ch, cfg.reg_z_over_reg, cfg.reg_time) * norm
    p.norm = _NORM[cfg.norm]
    p.fidelity = _FIDELITY[fidelity]
    p.nonneg = int(bool(nonneg))
    p.has_tmul = int(bool(has_tmul))
    p.sigma_D, p.sigma_A, p.reg, p.tau = sigma_D, sigma_A, reg, tau
    p.fid_weight, p.huber_delta = fid_weight, cfg.huber_delta
    p.fid_den = 1.0 + sigma_A / fid_weight
    p.kl_c = 4.0 * sigma_A * fid_weight
    p.huber_den = 1.0 + sigma_D * cfg.huber_delta / reg
    p.fid_scale = 0.5 * fid_weight if fidelity == "l2" else fid_weight
    return p


@functools.lru_cache(maxsize=None)
def _lib():
    from .build import load

    lib = load("cp_fused")
    ptr = ctypes.c_void_p
    lib.cp_num_parts.argtypes = [ctypes.c_int] * 4
    lib.cp_num_parts.restype = ctypes.c_longlong
    for fn in (lib.cp_dual_launch, lib.cp_primal_launch):
        fn.argtypes = [ctypes.POINTER(_CPParams), ctypes.c_int, ctypes.c_int,
                       ptr, ptr, ptr, ptr, ptr, ptr, ptr]
        fn.restype = ctypes.c_int
    lib.cp_error_string.argtypes = [ctypes.c_int]
    lib.cp_error_string.restype = ctypes.c_char_p
    return lib


def _check_operands(x, x0, y_A, y_D, tmul, cfg: TVConfig):
    """Validate what either pass accepts (both devices)."""
    for name, t in (("x", x), ("x0", x0), ("y_A", y_A), ("y_D", y_D)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")
    if x.ndim != 4:
        raise ValueError(f"x must be (Nz, M, Nr, Nc), got {tuple(x.shape)}")
    if x.dtype not in STORAGE_DTYPES:
        raise ValueError(f"x storage must be float32 or bfloat16, got {x.dtype}")
    for name, t in (("x0", x0), ("y_A", y_A)):
        if t.dtype != x.dtype or t.shape != x.shape:
            raise ValueError(f"{name} must match x: {tuple(x.shape)} "
                             f"{x.dtype}, got {tuple(t.shape)} {t.dtype}")
    if y_D.dtype not in STORAGE_DTYPES:
        raise ValueError(f"y_D storage must be float32 or bfloat16, got "
                         f"{y_D.dtype}")
    Nz, M, Nr, Nc = x.shape
    Nd = len(scheme_channels(cfg.scheme, Nz, M, cfg.reg_z_over_reg,
                             cfg.reg_time)[0])
    if tuple(y_D.shape) != (Nz, M, Nd, Nr, Nc):
        raise ValueError(f"y_D must be (Nz, M, Nd, Nr, Nc) = "
                         f"{(Nz, M, Nd, Nr, Nc)}, got {tuple(y_D.shape)}")
    if not fits_kernel(tuple(x.shape), Nd, x.dtype):
        raise ValueError(f"shape {tuple(x.shape)} with Nd={Nd} is outside "
                         f"what the CUDA kernels accept (fits_kernel)")
    if tmul is not None:
        if (tmul.dtype != torch.float32 or tuple(tmul.shape) != (Nr, Nc)
                or not tmul.is_contiguous() or tmul.device != x.device):
            raise ValueError("tmul must be a contiguous float32 (Nr, Nc) "
                             "tensor on x's device")


def _launch(fn, x, y_D, p, args):
    lib = _lib()
    Nz, M, Nr, Nc = x.shape
    parts = torch.empty(lib.cp_num_parts(Nz, M, Nr, Nc), dtype=torch.float32,
                        device=x.device)
    ptrs = [None if a is None else a.data_ptr() for a in args]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = fn(ctypes.byref(p), int(x.dtype == torch.bfloat16),
                  int(y_D.dtype == torch.bfloat16), *ptrs, parts.data_ptr(),
                  stream)
    if code != 0:
        raise RuntimeError(f"{fn.__name__} failed: "
                           f"{lib.cp_error_string(code).decode()}")
    return parts


def cp_dual(x, x0, y_A, y_D, tmul=None, *, cfg: TVConfig, sigma_D, sigma_A,
            reg, fidelity="l2", fid_weight=1.0):
    """Pass A: ``(x, x0, y_A, y_D[, tmul]) -> (y_A', y_D', tv_parts)``.

    ``y_A`` and ``y_D`` (internal layout) are updated in place and returned;
    ``tv_parts`` are partial sums of the TV term of D x (multiply their sum
    by ``reg`` for the loss).  ``tmul``: optional float32 (Nr, Nc)
    multiplier of the time channels (``dispatch.t_plane_multiplier``)."""
    _check_operands(x, x0, y_A, y_D, tmul, cfg)
    if x.device.type == "cpu":
        return cp_dual_plain(x, x0, y_A, y_D, tmul, cfg=cfg, sigma_D=sigma_D,
                             sigma_A=sigma_A, reg=reg, fidelity=fidelity,
                             fid_weight=fid_weight)
    p = _params(cfg, tuple(x.shape), tmul is not None, sigma_D=float(sigma_D),
                sigma_A=float(sigma_A), reg=float(reg), fidelity=fidelity,
                fid_weight=float(fid_weight))
    parts = _launch(_lib().cp_dual_launch, x, y_D, p, (x, x0, y_A, y_D, tmul))
    cp_dual.launches += 1
    return y_A, y_D, parts


def cp_primal(x, x0, y_A, y_D, tmul=None, *, cfg: TVConfig, tau,
              fidelity="l2", fid_weight=1.0, nonneg=False):
    """Pass B: ``(x, x0, y_A', y_D'[, tmul]) -> (x', fid_parts)``.

    ``x`` is updated in place and returned; ``fid_parts`` are partial sums
    of the fidelity term of x'."""
    _check_operands(x, x0, y_A, y_D, tmul, cfg)
    if x.device.type == "cpu":
        return cp_primal_plain(x, x0, y_A, y_D, tmul, cfg=cfg, tau=tau,
                               fidelity=fidelity, fid_weight=fid_weight,
                               nonneg=nonneg)
    p = _params(cfg, tuple(x.shape), tmul is not None, tau=float(tau),
                fidelity=fidelity, fid_weight=float(fid_weight),
                nonneg=bool(nonneg))
    parts = _launch(_lib().cp_primal_launch, x, y_D, p,
                    (x, x0, y_A, y_D, tmul))
    cp_primal.launches += 1
    return x, parts


cp_dual.launches = 0
cp_primal.launches = 0


def cp_dual_plain(x, x0, y_A, y_D, tmul=None, *, cfg: TVConfig, sigma_D,
                  sigma_A, reg, fidelity="l2", fid_weight=1.0):
    """Plain PyTorch version of :func:`cp_dual` (same signature, outputs and
    in-place updates), built from the ported operators: computes in float32
    and rounds to the storage dtypes where the kernel stores."""
    from ..solvers.cp import dual_prox

    kw = cfg.kwargs()
    xf = x.float()
    y_A_new = fidelity_dual_prox(y_A.float(), xf, x0.float(), sigma_A,
                                 fidelity, fid_weight)
    D_x = D(xf, cfg.scheme, weight_time=tmul, **kw)
    p = from_internal_layout(y_D).float() + sigma_D * D_x
    y_D_new = dual_prox(p, reg, cfg.norm, sigma_D, cfg.huber_delta)
    y_A.copy_(y_A_new)
    y_D.copy_(y_D_new.transpose(1, 2))  # public -> internal layout
    parts = tv_norm(D_x, cfg.norm, huber_delta=cfg.huber_delta).reshape(1)
    return y_A, y_D, parts


def cp_primal_plain(x, x0, y_A, y_D, tmul=None, *, cfg: TVConfig, tau,
                    fidelity="l2", fid_weight=1.0, nonneg=False):
    """Plain PyTorch version of :func:`cp_primal`."""
    kw = cfg.kwargs()
    dty = D_T(from_internal_layout(y_D).float(), cfg.scheme,
              weight_time=tmul, **kw)
    x_new = x.float() - tau * y_A.float() - tau * dty
    if nonneg:
        x_new = torch.clamp_min(x_new, 0.0)
    parts = fidelity_loss(x_new, x0.float(), fidelity, fid_weight).reshape(1)
    x.copy_(x_new)
    return x, parts


def to_internal_layout(y_D):
    """Public (Nz, Nd, M, Nr, Nc) -> internal (Nz, M, Nd, Nr, Nc), always a
    new contiguous tensor (the fused step updates it in place)."""
    return y_D.transpose(1, 2).clone(memory_format=torch.contiguous_format)


def from_internal_layout(y_D_int):
    """Internal (Nz, M, Nd, Nr, Nc) -> public (Nz, Nd, M, Nr, Nc), a view."""
    return y_D_int.transpose(1, 2)


def cp_step_fused_internal(x, y_A, y_D_int, x_noisy, *, reg, sigma_D,
                           sigma_A, tau, cfg: TVConfig, tmul=None,
                           fidelity="l2", fid_weight=1.0, nonneg=False):
    """One fused CP iteration with y_D in the internal layout.

    Updates ``x``, ``y_A`` and ``y_D_int`` IN PLACE (the TPU kernels alias
    them the same way) and returns ``(x, y_A, y_D_int, loss)`` with
    ``loss = F(x') + reg * TV(D x)`` as a float32 tensor on the device; no
    value is read back to the host."""
    fid_kw = dict(fidelity=fidelity, fid_weight=fid_weight)
    y_A, y_D_int, tv_parts = cp_dual(x, x_noisy, y_A, y_D_int, tmul, cfg=cfg,
                                     sigma_D=sigma_D, sigma_A=sigma_A,
                                     reg=reg, **fid_kw)
    x, fid_parts = cp_primal(x, x_noisy, y_A, y_D_int, tmul, cfg=cfg,
                             tau=tau, nonneg=nonneg, **fid_kw)
    loss = torch.add(torch.sum(fid_parts), torch.sum(tv_parts), alpha=reg)
    return x, y_A, y_D_int, loss


def cp_step_fused(state, x_noisy, *, reg, sigma_D, sigma_A, tau,
                  cfg: TVConfig, tmul=None, fidelity="l2", fid_weight=1.0,
                  nonneg=False):
    """Drop-in fused replacement for ``solvers.cp.cp_step`` on a public
    ``CPState`` (the state is copied, not updated); converts the y_D layout
    per call, so inside loops prefer :func:`cp_step_fused_internal`."""
    from ..solvers.cp import CPState

    x, y_A, y_D = state
    x, y_A, y_D_int, loss = cp_step_fused_internal(
        x.clone(), y_A.clone(), to_internal_layout(y_D), x_noisy, reg=reg,
        sigma_D=sigma_D, sigma_A=sigma_A, tau=tau, cfg=cfg, tmul=tmul,
        fidelity=fidelity, fid_weight=fid_weight, nonneg=nonneg,
    )
    return CPState(x, y_A, from_internal_layout(y_D_int)), loss
