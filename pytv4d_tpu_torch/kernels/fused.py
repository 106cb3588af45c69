"""The fused stencil kernels: the Chambolle-Pock step (B1/B2), its pass A
for inverse problems (B5) and the TV value and subgradient (B3/B4), and
their plain versions.

One CP iteration is two passes over the volume:

- pass A, :func:`cp_dual` (kernel ``cp_dual_kernel`` in ``csrc/cp_fused.cu``;
  replaces ``pytv4d_tpu/kernels/fused.py::make_cp_dual_kernel``): fidelity
  dual prox, every weighted D channel of the scheme table, the TV dual prox
  (iso ball, aniso box, Huber shrink + ball) and one TV partial of D x per
  block.  Writes y_A and y_D in place.
- pass B, :func:`cp_primal` (kernel ``cp_primal_kernel``; replaces
  ``make_cp_primal_kernel``): ``x' = x - tau y_A' - tau D^T y_D'``, the
  optional ``nonneg`` clamp and one fidelity partial of x' per block.
  Writes x in place, or into ``out``.

For an inverse problem ``min F(A x) + reg TV(x)`` (``solvers.inverse``) the
fidelity dual lives in the measurement space, so pass A is
:func:`tv_dual` (kernel ``tv_dual_kernel``; replaces ``make_tv_dual_kernel``):
the D channels of the over-relaxed iterate, the TV dual prox and the TV
partials, with no ``x0`` and no ``y_A``.  Pass B then runs with ``A^T y_A``
in its ``y_A`` slot and writes x' to a second buffer, because the solver
still needs x.

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

The TV value and subgradient (:func:`tv_and_subgrad_fused`, the
subgradient-descent step's operator) is two more passes, in
``csrc/tv_fused.cu``:

- pass 1, :func:`tv_norms` (kernel ``tv_norms_kernel``; replaces
  ``make_tv_norms_kernel``): per-voxel gradient norms (float32; +inf at zero
  for iso, the |D x| sum for aniso, the raw magnitude for huber) and one TV
  partial per block, from x alone.
- pass 2, :func:`tv_subgrad` (kernel ``tv_subgrad_kernel``; replaces
  ``make_tv_subgrad_kernel``): G from x and the norms, recomputing the D
  channels at each voxel and its neighbours, stored in x's dtype.  No
  Nd-channel volume is written.

Each wrapper takes its plain PyTorch version (:func:`cp_dual_plain`,
:func:`tv_dual_plain`, :func:`cp_primal_plain`, :func:`tv_norms_plain`,
:func:`tv_subgrad_plain`) for tensors on the CPU, which is how the CPU tests
run the fused path.  For CUDA tensors it launches the kernel or raises.
``cp_dual.launches``, ``tv_dual.launches``, ``cp_primal.launches``,
``tv_norms.launches`` and ``tv_subgrad.launches`` count kernel launches.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..core.config import TVConfig
from ..core.schemes import BWD, CTR, FWD, channel_weight, scheme_channels
from ..ops.operators import D, D_T, tv_norm
from ..ops.tv import _subgrad_from_D
from ..solvers.fidelity import fidelity_dual_prox, fidelity_loss

MAX_CHANNELS = 8      # MAX_CH: channels a thread keeps in registers
MAX_PLANES = 65535    # Nz * M rides gridDim.y
MAX_PLANE_VOXELS = 2**31 - 1
STORAGE_DTYPES = (torch.float32, torch.bfloat16)

_KIND = {FWD: 0, BWD: 1, CTR: 2}
_NORM = {"iso": 0, "aniso": 1, "huber": 2}
_FIDELITY = {"l2": 0, "l1": 1, "kl": 2}


class _Params(ctypes.Structure):
    """Mirror of ``struct Params`` in ``csrc/stencil.cuh``."""
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
        ("scheme_norm", ctypes.c_float),
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
    p = _Params(Nz=Nz, M=M, Nr=Nr, Nc=Nc, Nd=len(chans), scheme_norm=norm)
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


_ENTRY_POINTS = {
    # library: (prefix, parameter struct,
    #           {launch function: (int flags, tensor pointers)});
    # kernels/tgv_stream.py, tgv_resident.py, resident.py and zstream.py add
    # theirs
    "cp_fused": ("cp", _Params, {"cp_dual_launch": (2, 6),
                                 "tv_dual_launch": (2, 3),
                                 "cp_primal_launch": (2, 7)}),
    "tv_fused": ("tv", _Params, {"tv_norms_launch": (1, 4),
                                 "tv_subgrad_launch": (1, 4)}),
}


@functools.lru_cache(maxsize=None)
def _lib(name="cp_fused"):
    """Build (on first use), load and bind ``csrc/<name>.cu``.  Every launch
    function takes the parameter struct, its int flags, its pointers and
    the stream, and returns ``cudaGetLastError()``."""
    from .build import load

    lib = load(name)
    prefix, params, launches = _ENTRY_POINTS[name]
    ptr = ctypes.c_void_p
    if hasattr(lib, f"{prefix}_num_parts"):
        num_parts = getattr(lib, f"{prefix}_num_parts")
        num_parts.argtypes = [ctypes.c_int] * 4
        num_parts.restype = ctypes.c_longlong
    for fn_name, (n_int, n_ptr) in launches.items():
        fn = getattr(lib, fn_name)
        fn.argtypes = ([ctypes.POINTER(params)] + [ctypes.c_int] * n_int
                       + [ptr] * (n_ptr + 1))  # the pointers, then the stream
        fn.restype = ctypes.c_int
    error_string = getattr(lib, f"{prefix}_error_string")
    error_string.argtypes = [ctypes.c_int]
    error_string.restype = ctypes.c_char_p
    return lib


def _check_tensors(x, **others):
    """Tensors, contiguous, all on x's device, which is a CPU or a GPU."""
    for name, t in (("x", x), *others.items()):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t)}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.device != x.device:
            raise ValueError(f"{name} is on {t.device}, x on {x.device}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {x.device}")


def _check_volume(x, cfg: TVConfig) -> int:
    """x is a volume the kernels take; returns the scheme's Nd."""
    if x.ndim != 4:
        raise ValueError(f"x must be (Nz, M, Nr, Nc), got {tuple(x.shape)}")
    if x.dtype not in STORAGE_DTYPES:
        raise ValueError(f"x storage must be float32 or bfloat16, got {x.dtype}")
    Nz, M = x.shape[0], x.shape[1]
    Nd = len(scheme_channels(cfg.scheme, Nz, M, cfg.reg_z_over_reg,
                             cfg.reg_time)[0])
    if not fits_kernel(tuple(x.shape), Nd, x.dtype):
        raise ValueError(f"shape {tuple(x.shape)} with Nd={Nd} is outside "
                         f"what the CUDA kernels accept (fits_kernel)")
    return Nd


def _check_tmul(tmul, x):
    if tmul is not None and (
            not isinstance(tmul, torch.Tensor) or tmul.dtype != torch.float32
            or tuple(tmul.shape) != tuple(x.shape[2:])
            or not tmul.is_contiguous() or tmul.device != x.device):
        raise ValueError("tmul must be a contiguous float32 (Nr, Nc) tensor "
                         "on x's device")


def _check_like(x, **others):
    for name, t in others.items():
        if t.dtype != x.dtype or t.shape != x.shape:
            raise ValueError(f"{name} must match x: {tuple(x.shape)} "
                             f"{x.dtype}, got {tuple(t.shape)} {t.dtype}")


def _check_dual(y_D, x, Nd):
    """y_D is a dual of x in the internal layout and a storage dtype."""
    if y_D.dtype not in STORAGE_DTYPES:
        raise ValueError(f"y_D storage must be float32 or bfloat16, got "
                         f"{y_D.dtype}")
    Nz, M, Nr, Nc = x.shape
    if tuple(y_D.shape) != (Nz, M, Nd, Nr, Nc):
        raise ValueError(f"y_D must be (Nz, M, Nd, Nr, Nc) = "
                         f"{(Nz, M, Nd, Nr, Nc)}, got {tuple(y_D.shape)}")


def _check_operands(x, x0, y_A, y_D, tmul, cfg: TVConfig):
    """Validate what either CP pass accepts (both devices)."""
    _check_tensors(x, x0=x0, y_A=y_A, y_D=y_D)
    _check_like(x, x0=x0, y_A=y_A)
    _check_dual(y_D, x, _check_volume(x, cfg))
    _check_tmul(tmul, x)


def _launch(name, fn_name, x, p, flags, args, with_parts=False):
    """Launch ``fn_name`` of library ``name`` on x's device and current
    stream; with ``with_parts``, allocates the float32 per-block partials it
    writes (its last pointer) and returns them."""
    lib = _lib(name)
    prefix = _ENTRY_POINTS[name][0]
    parts = None
    if with_parts:
        parts = torch.empty(getattr(lib, f"{prefix}_num_parts")(*x.shape),
                            dtype=torch.float32, device=x.device)
        args = (*args, parts)
    ptrs = [None if a is None else a.data_ptr() for a in args]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        code = getattr(lib, fn_name)(ctypes.byref(p), *flags, *ptrs, stream)
    if code != 0:
        raise RuntimeError(
            f"{fn_name} failed: "
            f"{getattr(lib, f'{prefix}_error_string')(code).decode()}")
    return parts


def _cp_launch(fn_name, x, y_D, p, args):
    flags = (int(x.dtype == torch.bfloat16), int(y_D.dtype == torch.bfloat16))
    return _launch("cp_fused", fn_name, x, p, flags, args, with_parts=True)


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
    parts = _cp_launch("cp_dual_launch", x, y_D, p, (x, x0, y_A, y_D, tmul))
    cp_dual.launches += 1
    return y_A, y_D, parts


def tv_dual(x_bar, y_D, *, cfg: TVConfig, sigma_D, reg):
    """Pass A for inverse problems: ``(x_bar, y_D) -> (y_D', tv_parts)``.

    ``y_D`` (internal layout) becomes ``prox(y_D + sigma_D D x_bar)`` in
    place and is returned; ``tv_parts`` are partial sums of the TV term of
    ``D x_bar``.  No fidelity dual and no time-plane multiplier: the TPU
    kernel takes neither."""
    _check_tensors(x_bar, y_D=y_D)
    _check_dual(y_D, x_bar, _check_volume(x_bar, cfg))
    if x_bar.device.type == "cpu":
        return tv_dual_plain(x_bar, y_D, cfg=cfg, sigma_D=sigma_D, reg=reg)
    p = _params(cfg, tuple(x_bar.shape), False, sigma_D=float(sigma_D),
                reg=float(reg))
    parts = _cp_launch("tv_dual_launch", x_bar, y_D, p, (x_bar, y_D))
    tv_dual.launches += 1
    return y_D, parts


def cp_primal(x, x0, y_A, y_D, tmul=None, *, cfg: TVConfig, tau,
              fidelity="l2", fid_weight=1.0, nonneg=False, out=None):
    """Pass B: ``(x, x0, y_A', y_D'[, tmul]) -> (x', fid_parts)``.

    x' is written to ``out`` and returned; by default ``out`` is ``x``
    itself (in place).  Each voxel reads x only at itself, so a separate
    ``out`` costs nothing and leaves x intact.  ``fid_parts`` are partial
    sums of the fidelity term of x'."""
    _check_operands(x, x0, y_A, y_D, tmul, cfg)
    if out is None:
        out = x
    else:
        _check_tensors(x, out=out)
        _check_like(x, out=out)
    if x.device.type == "cpu":
        return cp_primal_plain(x, x0, y_A, y_D, tmul, cfg=cfg, tau=tau,
                               fidelity=fidelity, fid_weight=fid_weight,
                               nonneg=nonneg, out=out)
    p = _params(cfg, tuple(x.shape), tmul is not None, tau=float(tau),
                fidelity=fidelity, fid_weight=float(fid_weight),
                nonneg=bool(nonneg))
    parts = _cp_launch("cp_primal_launch", x, y_D, p,
                       (x, x0, y_A, y_D, tmul, out))
    cp_primal.launches += 1
    return out, parts


cp_dual.launches = 0
tv_dual.launches = 0
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


def tv_dual_plain(x_bar, y_D, *, cfg: TVConfig, sigma_D, reg):
    """Plain PyTorch version of :func:`tv_dual` (same signature, outputs
    and in-place update): the TV half of :func:`cp_dual_plain`."""
    from ..solvers.cp import dual_prox

    D_x = D(x_bar.float(), cfg.scheme, **cfg.kwargs())
    p = from_internal_layout(y_D).float() + sigma_D * D_x
    y_D_new = dual_prox(p, reg, cfg.norm, sigma_D, cfg.huber_delta)
    y_D.copy_(y_D_new.transpose(1, 2))  # public -> internal layout
    parts = tv_norm(D_x, cfg.norm, huber_delta=cfg.huber_delta).reshape(1)
    return y_D, parts


def cp_primal_plain(x, x0, y_A, y_D, tmul=None, *, cfg: TVConfig, tau,
                    fidelity="l2", fid_weight=1.0, nonneg=False, out=None):
    """Plain PyTorch version of :func:`cp_primal`."""
    kw = cfg.kwargs()
    dty = D_T(from_internal_layout(y_D).float(), cfg.scheme,
              weight_time=tmul, **kw)
    x_new = x.float() - tau * y_A.float() - tau * dty
    if nonneg:
        x_new = torch.clamp_min(x_new, 0.0)
    parts = fidelity_loss(x_new, x0.float(), fidelity, fid_weight).reshape(1)
    out = x if out is None else out
    out.copy_(x_new)
    return out, parts


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


# ---------------------------------------------------------------------------
# TV value and subgradient (B3/B4)
# ---------------------------------------------------------------------------


def _check_norms(norms, x):
    if norms.dtype != torch.float32 or norms.shape != x.shape:
        raise ValueError(f"norms must be float32 {tuple(x.shape)}, got "
                         f"{tuple(norms.shape)} {norms.dtype}")


def tv_norms(x, tmul=None, *, cfg: TVConfig):
    """Pass 1: ``(x[, tmul]) -> (norms, tv_parts)``.

    ``norms`` (float32, shaped like x): the per-voxel gradient norm with
    +inf where it is 0 (iso), the sum of |channels| (aniso) or the raw norm
    (huber); ``tv_parts`` sum to the TV value.  ``tmul``: optional float32
    (Nr, Nc) multiplier of the time channels
    (``dispatch.t_plane_multiplier``)."""
    _check_tensors(x)
    _check_volume(x, cfg)
    _check_tmul(tmul, x)
    if x.device.type == "cpu":
        return tv_norms_plain(x, tmul, cfg=cfg)
    p = _params(cfg, tuple(x.shape), tmul is not None)
    norms = torch.empty(x.shape, dtype=torch.float32, device=x.device)
    parts = _launch("tv_fused", "tv_norms_launch", x, p,
                    (int(x.dtype == torch.bfloat16),), (x, tmul, norms),
                    with_parts=True)
    tv_norms.launches += 1
    return norms, parts


def tv_subgrad(x, norms, tmul=None, *, cfg: TVConfig):
    """Pass 2: ``(x, norms[, tmul]) -> G`` in x's dtype, with ``norms``
    from :func:`tv_norms` (the aniso G does not read them)."""
    _check_tensors(x, norms=norms)
    _check_volume(x, cfg)
    _check_norms(norms, x)
    _check_tmul(tmul, x)
    if x.device.type == "cpu":
        return tv_subgrad_plain(x, norms, tmul, cfg=cfg)
    p = _params(cfg, tuple(x.shape), tmul is not None)
    g = torch.empty_like(x)
    _launch("tv_fused", "tv_subgrad_launch", x, p,
            (int(x.dtype == torch.bfloat16),),
            (x, None if cfg.norm == "aniso" else norms, tmul, g))
    tv_subgrad.launches += 1
    return g


tv_norms.launches = 0
tv_subgrad.launches = 0


def tv_norms_plain(x, tmul=None, *, cfg: TVConfig):
    """Plain PyTorch version of :func:`tv_norms` (same signature and
    outputs), from the ported operators, in float32."""
    D_x = D(x.float(), cfg.scheme, weight_time=tmul, **cfg.kwargs())
    tv, norms = tv_norm(D_x, cfg.norm, return_array=True,
                        huber_delta=cfg.huber_delta)
    if cfg.norm == "iso":
        norms = torch.where(norms == 0, torch.inf, norms)
    return norms, tv.reshape(1)


def tv_subgrad_plain(x, norms, tmul=None, *, cfg: TVConfig):
    """Plain PyTorch version of :func:`tv_subgrad`: computes in float32 and
    rounds G to x's dtype."""
    kw = dict(weight_time=tmul, **cfg.kwargs())
    D_x = D(x.float(), cfg.scheme, **kw)
    if cfg.norm == "aniso":
        G = D_T(torch.sign(D_x), cfg.scheme, **kw)
    elif cfg.norm == "huber":
        G = D_T(D_x / torch.clamp_min(norms, cfg.huber_delta)[:, None],
                cfg.scheme, **kw)
    else:
        G = _subgrad_from_D(D_x, norms, cfg.scheme, x.shape[0], x.shape[1],
                            cfg.reg_z_over_reg, cfg.reg_time)
    return G.to(x.dtype)


def tv_and_subgrad_fused(x, cfg: TVConfig, return_grad_norms=False,
                         tmul=None):
    """``(tv, G[, grad_norms])`` in two passes with no Nd-channel volume:
    the semantics of ``ops.tv.tv_and_subgrad`` (``grad_norms`` with the inf
    convention for iso, the per-voxel |channel| sum for aniso).  ``tv`` is
    a float32 scalar tensor on x's device, G has x's dtype.  ``tmul``:
    optional (Nr, Nc) time-channel multiplier
    (``dispatch.t_plane_multiplier``)."""
    norms, parts = tv_norms(x, tmul, cfg=cfg)
    G = tv_subgrad(x, norms, tmul, cfg=cfg)
    if return_grad_norms:
        return torch.sum(parts), G, norms
    return torch.sum(parts), G
