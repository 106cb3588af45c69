"""The fused stencil kernels: the Chambolle-Pock step (B1/B2), its pass A
for inverse problems (B5) and the TV value and subgradient (B3/B4), and
their plain versions.

One CP iteration is two passes over the volume:

- pass A, :func:`cp_dual` (kernel ``cp_dual_spec_kernel`` in
  ``csrc/specialised.cu``; replaces
  ``pytv4d_tpu/kernels/fused.py::make_cp_dual_kernel``): fidelity dual
  prox, every weighted D channel of the scheme table, the TV dual prox (iso
  ball, aniso box, Huber shrink + ball) and one TV partial of D x per
  block.  Writes y_A and y_D in place.
- pass B, :func:`cp_primal` (kernel ``cp_primal_spec_kernel`` in
  ``csrc/specialised.cu``; replaces ``make_cp_primal_kernel``):
  ``x' = x - tau y_A' - tau D^T y_D'``, the optional ``nonneg`` clamp and
  one fidelity partial of x' per block.  Writes x in place, or into
  ``out``.

For an inverse problem ``min F(A x) + reg TV(x)`` (``solvers.inverse``) the
fidelity dual lives in the measurement space, so pass A is
:func:`tv_dual` (kernel ``tv_dual_spec_kernel`` in
``csrc/specialised_tv.cu``; replaces ``make_tv_dual_kernel``): the D
channels of the over-relaxed iterate, the TV dual prox and the TV
partials, with no ``x0`` and no ``y_A``: pass A's body without the
fidelity dual.  Pass B then runs with ``A^T y_A``
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
``tv_<scheme>`` API's on a CUDA tensor) is two more passes:

- pass 1, :func:`tv_norms` (kernel ``tv_norms_spec_kernel`` in
  ``csrc/specialised_tv.cu``; replaces ``make_tv_norms_kernel``): per-voxel
  gradient norms (float32; +inf at zero for iso, the |D x| sum for aniso,
  the raw magnitude for huber) and TV partials, from x alone; each block
  marches a tile of the plane along t with the tiles of the planes either
  side in shared memory.
- pass 2, :func:`tv_subgrad` (kernel ``tv_subgrad_spec_kernel`` in
  ``csrc/specialised.cu``; replaces ``make_tv_subgrad_kernel``): G from x
  and the norms, recomputing the D channels at each voxel and its
  neighbours, stored in x's dtype.  No Nd-channel volume is written.
  Subgradient descent takes its step in pass 2's epilogue instead
  (:func:`tv_gd_step`, the same kernel's GD instance): x' and the fidelity
  partials of x' are written, and G is not.

All five passes launch kernels specialised for the scheme's channel table
(``kernels.tables``: the table id picks the template instance; the
libraries :data:`SPECIALISED`) on an unsharded volume, and on a shard
(passes 1, 2 and A for inverse problems in ``halo_mode``: their HALO
instances, ``spectv_norms_halo_launch``, ``spec_tv_subgrad_halo_launch``,
``spectv_dual_halo_launch``; passes A and B in both sharded modes:
``csrc/specialised_cp.cu``'s ``spcp_dual_halo_launch``,
``spcp_dual_interior_launch``, ``spcp_primal_halo_launch``,
``spcp_primal_interior_launch``; each with the whole volume's table); a
table outside the compiled list raises (``interior``: outside
``kernels.tables.BOUNDARY_TABLES``, the tables of the step B8 finishes).

On one shard of a (z, t)-sharded solve (``parallel.fused_halo``) the five
passes A, B, 1, 2 and A for inverse problems take the TPU kernels' modes.
``halo_mode``: x (pass B: a copy of the dual, pass 2: the norms too)
arrives extended by a plane per side in z and t (two
for pass 2's x) that holds the neighbour shard's edge or, at the volume's
edge, a ghost plane chosen so that every difference across it is zero; the z
and t gates are off and ``table_dims`` gives the whole volume's ``(Nz, M)``
for the channel table.  ``interior`` (passes A and B): only the planes
``1 .. Nz-2``, which need no neighbour, are computed; the two edge planes
are then redone from exchanged planes by the boundary kernels B8,
:func:`cp_dual_boundary` and :func:`cp_primal_boundary`
(``bnd_dual_kernel`` and ``bnd_primal_kernel`` in ``csrc/cp_boundary.cu``,
specialised per channel table for the tables
``kernels.tables.BOUNDARY_TABLES``; replace ``make_cp_dual_boundary_kernel``
and ``make_cp_primal_boundary_kernel``).  Their wrappers check each call's
operands as the others do, but only once per kind of call: a call whose
operands have the types, shapes, dtypes, devices and contiguity of one that
passed, with the same configuration, passes again without the work.

Each wrapper takes its plain PyTorch version (:func:`cp_dual_plain`,
:func:`tv_dual_plain`, :func:`cp_primal_plain`, :func:`tv_norms_plain`,
:func:`tv_subgrad_plain`, :func:`cp_dual_boundary_plain`,
:func:`cp_primal_boundary_plain`) for tensors on the CPU, which is how the
CPU tests run the fused path.  For CUDA tensors it launches the kernel or
raises.  Each launch is counted in ``utils.profiling.counters()``: B1 to
B5 under ``launch.B1`` ... ``launch.B5`` (pass 2 with the GD epilogue
under ``launch.B4`` and ``launch.B4_gd``), the boundary kernels under
``launch.B8.dual`` / ``launch.B8.primal``, and B1 and B2 also under
``launch.B1/<launch function>`` / ``launch.B2/<launch function>``, which
tells the unsharded launch and the two sharded modes apart.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..core.config import TVConfig
from ..core.schemes import BWD, CTR, FWD, channel_weight, scheme_channels
from ..ops.operators import D, D_T, _sl, d_channel, dt_channel, tv_norm
from ..ops.tv import _subgrad_from_D
from ..solvers.fidelity import fidelity_dual_prox, fidelity_loss
from ..utils.profiling import count
from . import tables

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
        ("sharded", ctypes.c_int), ("t_free", ctypes.c_int),
        ("xe", ctypes.c_int), ("ye", ctypes.c_int), ("ne", ctypes.c_int),
        ("z_first", ctypes.c_int), ("z_last", ctypes.c_int),
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
            reg=1.0, tau=0.1, fidelity="l2", fid_weight=1.0, nonneg=False,
            table_dims=None, sharded=False, t_free=False, xe=0, ye=0, ne=0,
            interior=False):
    """The kernels' launch parameters: the channel table of ``cfg`` at
    ``shape`` (weights as ``make_cp_dual_kernel``'s ``_build`` computes
    them) and the step's scalars.  On a shard, ``shape`` is the shard's,
    ``table_dims`` the whole volume's ``(Nz, M)`` for the table, and the
    remaining arguments fill the fields the HALO kernels read
    (``csrc/stencil.cuh``)."""
    Nz, M, Nr, Nc = shape
    chans, norm = scheme_channels(cfg.scheme, *(table_dims or (Nz, M)),
                                  cfg.reg_z_over_reg, cfg.reg_time)
    p = _Params(Nz=Nz, M=M, Nr=Nr, Nc=Nc, Nd=len(chans), scheme_norm=norm,
                sharded=int(sharded), t_free=int(t_free), xe=xe, ye=ye,
                ne=ne, z_first=1 if interior else 0,
                z_last=Nz - 2 if interior else Nz - 1)
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
    # the specialised kernels; int flags (table, storage...)
    "cp_boundary": ("bnd", _Params, {"cp_dual_boundary_launch": (3, 7),
                                     "cp_primal_boundary_launch": (3, 7)}),
    "specialised": ("spec", _Params, {
        "spec_cp_dual_launch": (3, 6), "spec_cp_primal_launch": (3, 7),
        "spec_tv_subgrad_launch": (2, 4),
        "spec_tv_subgrad_halo_launch": (2, 4), "spec_tv_gd_launch": (2, 6)}),
    "specialised_tv": ("spectv", _Params, {
        "spectv_norms_launch": (2, 4), "spectv_norms_halo_launch": (2, 4),
        "spectv_dual_launch": (3, 3), "spectv_dual_halo_launch": (3, 3)}),
    "specialised_cp": ("spcp", _Params, {
        "spcp_dual_halo_launch": (3, 6), "spcp_dual_interior_launch": (3, 6),
        "spcp_primal_halo_launch": (3, 7),
        "spcp_primal_interior_launch": (3, 7)}),
}
SPECIALISED = ("specialised", "specialised_tv", "specialised_cp")


def _num_parts_name(lib, prefix, fn_name):
    """The function of ``lib`` that counts the partials ``fn_name`` writes:
    the first the library has of its own ``<launch>_num_parts`` and its
    mode's ``<prefix>_<mode>_num_parts`` (the launch's last word, as in
    ``spcp_dual_interior_launch``), else the library's
    ``<prefix>_num_parts``."""
    stem = fn_name[:-len("_launch")]
    mode = stem.rsplit("_", 1)[-1]
    for count in (f"{stem}_num_parts", f"{prefix}_{mode}_num_parts"):
        if hasattr(lib, count):
            return count
    return f"{prefix}_num_parts"


@functools.lru_cache(maxsize=None)
def _num_parts(name, fn_name):
    """The bound function of library ``name`` that counts the partials
    ``fn_name`` writes (looked up once: a failed lookup costs a launch)."""
    lib = _lib(name)
    return getattr(lib, _num_parts_name(lib, _ENTRY_POINTS[name][0],
                                        fn_name))


@functools.lru_cache(maxsize=None)
def _lib(name):
    """Build (on first use), load and bind ``csrc/<name>.cu``.  Every launch
    function takes the parameter struct, its int flags, its pointers and
    the stream, and returns ``cudaGetLastError()``."""
    from .build import load

    lib = load(name)
    prefix, params, launches = _ENTRY_POINTS[name]
    ptr = ctypes.c_void_p
    for count in {_num_parts_name(lib, prefix, fn) for fn in launches}:
        if hasattr(lib, count):
            num_parts = getattr(lib, count)
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


def _shard_shape(x, e=0):
    """The shape of the shard that the volume ``x`` extends by ``e`` planes
    per side in z and t (x's own for e = 0)."""
    if x.ndim != 4 or min(x.shape[:2]) <= 2 * e:
        raise ValueError(f"x must be (Nz, M, Nr, Nc), extended by {e} "
                         f"plane(s) per side in z and t, got "
                         f"{tuple(x.shape)}")
    return (x.shape[0] - 2 * e, x.shape[1] - 2 * e) + tuple(x.shape[2:])


@functools.lru_cache(maxsize=64)
def _scheme_nd(cfg: TVConfig, Nz: int, M: int) -> int:
    """The number of channels of ``cfg``'s scheme on an (Nz, M) volume."""
    return len(scheme_channels(cfg.scheme, Nz, M, cfg.reg_z_over_reg,
                               cfg.reg_time)[0])


def _check_volume(x, cfg: TVConfig, table_dims=None, e=0) -> int:
    """x is a volume the kernels take (on a shard: extended by ``e`` planes
    per side in z and t); returns the scheme's Nd (on a shard, from the
    whole volume's ``table_dims``)."""
    shape = _shard_shape(x, e)
    if x.dtype not in STORAGE_DTYPES:
        raise ValueError(f"x storage must be float32 or bfloat16, got {x.dtype}")
    Nd = _scheme_nd(cfg, *(table_dims or shape[:2]))
    if not fits_kernel(shape, Nd, x.dtype):
        raise ValueError(f"shape {shape} with Nd={Nd} is outside "
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


def _check_extended(ref, e, **others):
    """Each tensor has ref's dtype and ref's shape extended by ``e`` planes
    per side along z and t."""
    want = (ref.shape[0] + 2 * e, ref.shape[1] + 2 * e) + tuple(ref.shape[2:])
    for name, t in others.items():
        if t.dtype != ref.dtype or tuple(t.shape) != want:
            raise ValueError(
                f"{name} must be {ref.dtype} {want} (the shard's array "
                f"extended by {e} plane(s) per side in z and t), got "
                f"{tuple(t.shape)} {t.dtype}")


def _check_modes(halo_mode, interior, Nz):
    if halo_mode and interior:
        raise ValueError("halo_mode and interior exclude each other")
    if interior and Nz < 3:
        raise ValueError("interior needs >= 3 local z planes, got "
                         f"{Nz}")


def _check_operands(x, x0, y_A, y_D, tmul, cfg: TVConfig, table_dims=None,
                    xe=0):
    """Validate what either CP pass accepts (both devices).  ``x0`` has the
    shard's shape; x is extended by ``xe`` planes per side in z and t."""
    _check_tensors(x, x0=x0, y_A=y_A, y_D=y_D)
    _check_like(x0, y_A=y_A)
    _check_extended(x0, xe, x=x)
    _check_dual(y_D, x0, _check_volume(x0, cfg, table_dims))
    _check_tmul(tmul, x0)


def _stream_handle(device):
    """The raw handle of the current CUDA stream on ``device``: torch's own
    query (the one Triton's launcher makes), which builds no
    ``torch.cuda.Stream`` as ``current_stream`` does: 0.3 us against 3.3-5.6
    us of a boundary launch's host time on an H100's host
    (``tools/torch_probe_boundary.py``)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def _launch(name, fn_name, x, p, flags, args, with_parts=False,
            shape=None):
    """Launch ``fn_name`` of library ``name`` on x's device and current
    stream; with ``with_parts``, allocates the float32 per-block partials it
    writes for a volume of ``shape`` (x's by default; its last pointer) and
    returns them."""
    lib = _lib(name)
    prefix = _ENTRY_POINTS[name][0]
    parts = None
    if with_parts:
        parts = torch.empty(_num_parts(name, fn_name)(*(shape or x.shape)),
                            dtype=torch.float32, device=x.device)
        args = (*args, parts)
    ptrs = [None if a is None else a.data_ptr() for a in args]
    with torch.cuda.device(x.device):
        code = getattr(lib, fn_name)(ctypes.byref(p), *flags, *ptrs,
                                     _stream_handle(x.device))
    if code != 0:
        raise RuntimeError(
            f"{fn_name} failed: "
            f"{getattr(lib, f'{prefix}_error_string')(code).decode()}")
    return parts


def _storage_flags(x, y_D):
    return int(x.dtype == torch.bfloat16), int(y_D.dtype == torch.bfloat16)


def _spec_launch(fn_name, cfg, x, p, flags, args, with_parts=False,
                 table_dims=None, shape=None):
    """Launch a specialised kernel, from whichever of the
    :data:`SPECIALISED` libraries defines ``fn_name``, on the volume or
    shard of ``shape`` (x's by default; the shape whose partials it
    counts), for the channel table of ``cfg`` at the whole volume's
    ``table_dims``, that shape's ``(Nz, M)`` by default
    (``kernels.tables``; raises where no kernel is compiled for it)."""
    shape = shape or tuple(x.shape)
    table = tables.table_id(cfg, *(table_dims or shape[:2]))
    name = next(n for n in SPECIALISED if fn_name in _ENTRY_POINTS[n][2])
    return _launch(name, fn_name, x, p, (table, *flags), args, with_parts,
                   shape)


def _cp_shard_launch(pass_name, cfg, x, p, flags, args, interior,
                     table_dims):
    """Launch CP pass ``pass_name`` (``"dual"`` or ``"primal"``) of
    ``csrc/specialised_cp.cu`` on the shard ``x`` in its mode, for the
    channel table of the whole volume's ``table_dims``: any of the 21 in the
    halo mode, in the interior one only those of the step B8 finishes
    (``kernels.tables.boundary_table_id``; raises where no kernel is
    compiled for it).  Returns the launch function's name and the
    partials."""
    fn = f"spcp_{pass_name}_{'interior' if interior else 'halo'}_launch"
    find = tables.boundary_table_id if interior else tables.table_id
    table = find(cfg, *(table_dims or x.shape[:2]))
    return fn, _launch("specialised_cp", fn, x, p, (table, *flags), args,
                       with_parts=True)


def _shard_fields(halo_mode, interior, table_dims, **depths):
    """``_params`` keywords of a pass on a shard: every sharded mode ungates
    z, ``halo_mode`` also t and names the extension ``depths``."""
    if not (halo_mode or interior):
        return dict(table_dims=table_dims)
    return dict(table_dims=table_dims, sharded=True, t_free=halo_mode,
                interior=interior, **(depths if halo_mode else {}))


def cp_dual(x, x0, y_A, y_D, tmul=None, *, cfg: TVConfig, sigma_D, sigma_A,
            reg, fidelity="l2", fid_weight=1.0, halo_mode=False,
            table_dims=None, t_sharded=False, interior=False):
    """Pass A: ``(x, x0, y_A, y_D[, tmul]) -> (y_A', y_D', tv_parts)``.

    ``y_A`` and ``y_D`` (internal layout) are updated in place and returned;
    ``tv_parts`` are partial sums of the TV term of D x (multiply their sum
    by ``reg`` for the loss).  ``tmul``: optional float32 (Nr, Nc)
    multiplier of the time channels (``dispatch.t_plane_multiplier``).

    On a shard (module docstring): with ``halo_mode`` x is
    ``(Nz+2, M+2, Nr, Nc)`` while ``x0``, ``y_A``, ``y_D`` keep the shard's
    shape; with ``interior`` only planes ``1 .. Nz-2`` of ``y_A`` and
    ``y_D`` are updated and ``tv_parts`` comes back as ``(Nz, k)`` whose
    rows 0 and ``Nz-1`` are left for :func:`cp_dual_boundary` to write.
    ``table_dims``: the whole volume's ``(Nz, M)``.  ``t_sharded`` changes
    nothing here (on the TPU it moves the time channels' adjoint out of
    pass A's third output, which the port does not have)."""
    _check_operands(x, x0, y_A, y_D, tmul, cfg, table_dims, int(halo_mode))
    _check_modes(halo_mode, interior, x0.shape[0])
    kw = dict(cfg=cfg, sigma_D=sigma_D, sigma_A=sigma_A, reg=reg,
              fidelity=fidelity, fid_weight=fid_weight)
    if x.device.type == "cpu":
        return cp_dual_plain(x, x0, y_A, y_D, tmul, halo_mode=halo_mode,
                             table_dims=table_dims, interior=interior, **kw)
    return _cp_dual_kernel(x, x0, y_A, y_D, tmul, halo_mode=halo_mode,
                           table_dims=table_dims, interior=interior, **kw)


def _cp_dual_kernel(x, x0, y_A, y_D, tmul=None, *, cfg: TVConfig, sigma_D,
                    sigma_A, reg, fidelity="l2", fid_weight=1.0,
                    halo_mode=False, table_dims=None, interior=False):
    """:func:`cp_dual`'s launch, on checked operands: the kernel of the
    scheme's channel table (``csrc/specialised.cu``), on a shard its
    halo-mode or interior instance (``csrc/specialised_cp.cu``) with the
    whole volume's table."""
    p = _params(cfg, tuple(x0.shape), tmul is not None,
                sigma_D=float(sigma_D), sigma_A=float(sigma_A),
                reg=float(reg), fidelity=fidelity,
                fid_weight=float(fid_weight),
                **_shard_fields(halo_mode, interior, table_dims, xe=1))
    flags, args = _storage_flags(x0, y_D), (x, x0, y_A, y_D, tmul)
    if halo_mode or interior:
        fn, parts = _cp_shard_launch("dual", cfg, x0, p, flags, args,
                                     interior, table_dims)
    else:
        fn = "spec_cp_dual_launch"
        parts = _spec_launch(fn, cfg, x0, p, flags, args, with_parts=True)
    count("launch.B1")
    count(f"launch.B1/{fn}")
    return y_A, y_D, parts.view(x0.shape[0], -1) if interior else parts


def tv_dual(x_bar, y_D, *, cfg: TVConfig, sigma_D, reg, halo_mode=False,
            table_dims=None):
    """Pass A for inverse problems: ``(x_bar, y_D) -> (y_D', tv_parts)``.

    ``y_D`` (internal layout) becomes ``prox(y_D + sigma_D D x_bar)`` in
    place and is returned; ``tv_parts`` are partial sums of the TV term of
    ``D x_bar``.  No fidelity dual and no time-plane multiplier: the TPU
    kernel takes neither.

    On a shard (module docstring): with ``halo_mode`` x_bar is
    ``(Nz+2, M+2, Nr, Nc)`` while ``y_D`` keeps the shard's shape, and the
    kernel is the halo instance of ``tv_dual_spec_kernel``
    (``csrc/specialised_tv.cu``) for the whole volume's table.
    ``table_dims``: the whole volume's ``(Nz, M)``.  ``y_D'`` is the
    unsharded kernel's on the same voxels of the gathered volume, bit for
    bit; ``tv_parts`` come one per block of the shard's planes, so their
    sum differs from the unsharded kernel's only by the order of a sum."""
    e = int(halo_mode)
    _check_tensors(x_bar, y_D=y_D)
    Nd = _check_volume(x_bar, cfg, table_dims, e)
    _check_dual(y_D, torch.empty(_shard_shape(x_bar, e), device="meta"), Nd)
    kw = dict(cfg=cfg, sigma_D=sigma_D, reg=reg, halo_mode=halo_mode,
              table_dims=table_dims)
    if x_bar.device.type == "cpu":
        return tv_dual_plain(x_bar, y_D, **kw)
    return _tv_dual_kernel(x_bar, y_D, **kw)


def _tv_dual_kernel(x_bar, y_D, *, cfg: TVConfig, sigma_D, reg,
                    halo_mode=False, table_dims=None):
    """:func:`tv_dual`'s launch, on checked operands: the kernel of the
    scheme's channel table (``csrc/specialised_tv.cu``), on a shard its
    halo instance with the whole volume's table."""
    shape = _shard_shape(x_bar, int(halo_mode))
    p = _params(cfg, shape, False, sigma_D=float(sigma_D), reg=float(reg),
                **_shard_fields(halo_mode, False, table_dims, xe=1))
    fn = "spectv_dual_halo_launch" if halo_mode else "spectv_dual_launch"
    parts = _spec_launch(fn, cfg, x_bar, p, _storage_flags(x_bar, y_D),
                         (x_bar, y_D), with_parts=True,
                         table_dims=table_dims, shape=shape)
    count("launch.B5")
    return y_D, parts


def cp_primal(x, x0, y_A, y_D, tmul=None, *, cfg: TVConfig, tau,
              fidelity="l2", fid_weight=1.0, nonneg=False, out=None,
              halo_mode=False, table_dims=None, t_sharded=False,
              interior=False, y_ext=None):
    """Pass B: ``(x, x0, y_A', y_D'[, tmul]) -> (x', fid_parts)``.

    x' is written to ``out`` and returned; by default ``out`` is ``x``
    itself (in place).  Each voxel reads x only at itself, so a separate
    ``out`` costs nothing and leaves x intact.  ``fid_parts`` are partial
    sums of the fidelity term of x'.

    On a shard (module docstring): with ``halo_mode`` every array keeps the
    shard's shape and ``y_ext``, ``(Nz+2, M+2, Nd, Nr, Nc)``, is ``y_D``
    with a plane per side in z and t holding the neighbour shards' values
    (zeros at the volume's edge); the kernel reads the dual from ``y_ext``
    alone (one array streamed, as on the unsharded path).  With
    ``interior`` only planes ``1 .. Nz-2`` of x' are written and
    ``fid_parts`` comes back as ``(Nz, k)`` whose rows 0 and ``Nz-1`` are
    left for :func:`cp_primal_boundary`.  ``table_dims``: the whole volume's
    ``(Nz, M)``.  ``t_sharded`` changes nothing but what ``y_ext`` holds
    along t: this pass always computes the full adjoint (the TPU kernel
    takes the time channels' part from pass A unless time is sharded)."""
    _check_operands(x, x0, y_A, y_D, tmul, cfg, table_dims)
    _check_modes(halo_mode, interior, x.shape[0])
    if halo_mode != (y_ext is not None):
        raise ValueError("y_ext goes with halo_mode, and only with it")
    if halo_mode:
        _check_tensors(x, y_ext=y_ext)
        _check_extended(y_D, 1, y_ext=y_ext)
    if out is None:
        out = x
    else:
        _check_tensors(x, out=out)
        _check_like(x, out=out)
    kw = dict(cfg=cfg, tau=tau, fidelity=fidelity, fid_weight=fid_weight,
              nonneg=nonneg, out=out, halo_mode=halo_mode,
              table_dims=table_dims, interior=interior, y_ext=y_ext)
    if x.device.type == "cpu":
        return cp_primal_plain(x, x0, y_A, y_D, tmul, **kw)
    return _cp_primal_kernel(x, x0, y_A, y_D, tmul, **kw)


def _cp_primal_kernel(x, x0, y_A, y_D, tmul=None, *, cfg: TVConfig, tau,
                      fidelity="l2", fid_weight=1.0, nonneg=False, out,
                      halo_mode=False, table_dims=None, interior=False,
                      y_ext=None):
    """:func:`cp_primal`'s launch, on checked operands: the kernel of the
    scheme's channel table (``csrc/specialised.cu``), on a shard its
    halo-mode or interior instance (``csrc/specialised_cp.cu``) with the
    whole volume's table."""
    p = _params(cfg, tuple(x.shape), tmul is not None, tau=float(tau),
                fidelity=fidelity, fid_weight=float(fid_weight),
                nonneg=bool(nonneg),
                **_shard_fields(halo_mode, interior, table_dims, ye=1))
    flags = _storage_flags(x, y_D)
    if halo_mode or interior:
        # the halo mode reads the dual from y_ext alone
        y = y_ext if halo_mode else y_D
        fn, parts = _cp_shard_launch("primal", cfg, x, p, flags,
                                     (x, x0, y_A, y, tmul, out), interior,
                                     table_dims)
    else:
        fn = "spec_cp_primal_launch"
        parts = _spec_launch(fn, cfg, x, p, flags,
                             (x, x0, y_A, y_D, tmul, out), with_parts=True)
    count("launch.B2")
    count(f"launch.B2/{fn}")
    return out, parts.view(x.shape[0], -1) if interior else parts


def _signature(t):
    """What the checks read of an operand: its type and, for a tensor, its
    shape, dtype, device and contiguity."""
    if isinstance(t, torch.Tensor):
        return type(t), t.shape, t.dtype, t.device, t.is_contiguous()
    return (type(t),)


# the signatures of the boundary calls whose operands passed the checks
_BOUNDARY_PASSED = set()


def _check_boundary(x, halo, x0, y_A, y_D, parts, tmul, cfg, table_dims,
                    halo_name):
    """Validate what either boundary kernel accepts: a shard of >= 3 planes,
    its (2, ...) halo stack shaped like two planes of the array it extends,
    and the interior launch's ``(Nz, k)`` partials (on a CUDA device: one
    per block, as many as that launch wrote).  The verdict depends only on
    the configuration and the operands' :func:`_signature`, so a call whose
    signatures match one that passed passes at once: the overlapped step
    repeats one call per shard and iteration."""
    key = (cfg, table_dims, halo_name,
           *map(_signature, (x, halo, x0, y_A, y_D, parts, tmul)))
    if key in _BOUNDARY_PASSED:
        return
    _check_operands(x, x0, y_A, y_D, tmul, cfg, table_dims)
    _check_modes(False, True, x.shape[0])
    like = x if halo_name == "x_halo" else y_D
    _check_tensors(x, parts=parts, **{halo_name: halo})
    if halo.dtype != like.dtype or tuple(halo.shape) != (2,) + tuple(
            like.shape[1:]):
        raise ValueError(f"{halo_name} must be {like.dtype} "
                         f"{(2,) + tuple(like.shape[1:])}, got "
                         f"{tuple(halo.shape)} {halo.dtype}")
    if (parts.dtype != torch.float32 or parts.ndim != 2
            or parts.shape[0] != x.shape[0]):
        raise ValueError("parts must be the float32 (Nz, k) partials of the "
                         f"interior launch, got {tuple(parts.shape)} "
                         f"{parts.dtype}")
    if x.is_cuda:
        want = _num_parts("cp_boundary", "cp_dual_boundary_launch")(*x.shape)
        if parts.numel() != want:
            raise ValueError(f"parts holds {parts.numel()} partials, the "
                             f"interior launch of a {tuple(x.shape)} shard "
                             f"writes {want}")
    if len(_BOUNDARY_PASSED) >= 256:
        _BOUNDARY_PASSED.clear()
    _BOUNDARY_PASSED.add(key)


def _boundary_launch(fn_name, cfg, x, y_D, table_dims, p, args):
    """Launch a boundary kernel of ``csrc/cp_boundary.cu`` on the shard ``x``
    for the channel table of ``cfg`` at the whole volume's ``table_dims``
    (``kernels.tables.boundary_table_id``; raises where no kernel is
    compiled for it)."""
    table = tables.boundary_table_id(cfg, *(table_dims or x.shape[:2]))
    _launch("cp_boundary", fn_name, x, p, (table, *_storage_flags(x, y_D)),
            args)


def cp_dual_boundary(x, x_halo, x0, y_A, y_D, parts, tmul=None, *,
                     cfg: TVConfig, sigma_D, sigma_A, reg, fidelity="l2",
                     fid_weight=1.0, table_dims=None):
    """Pass A redone on the two z-edge planes of a shard:
    ``(x, x_halo, x0, y_A, y_D, tv_parts[, tmul]) -> (y_A', y_D', tv_parts)``.

    After ``cp_dual(..., interior=True)`` has updated planes ``1 .. Nz-2``,
    this updates ``y_A`` and ``y_D`` at planes 0 and ``Nz-1`` in place and
    writes rows 0 and ``Nz-1`` of ``tv_parts`` (the interior call's).
    ``x_halo`` ``(2, M, Nr, Nc)``: slot 0 is x at ``z = -1`` (the left
    neighbour's last plane), slot 1 x at ``z = Nz`` (the right neighbour's
    first); at the volume's edge the ghost plane that zeroes every z
    difference there (``parallel.fused_halo._halo_planes``).  Time is
    unsharded: its gates stay on.  ``table_dims``: the whole volume's
    ``(Nz, M)``."""
    _check_boundary(x, x_halo, x0, y_A, y_D, parts, tmul, cfg, table_dims,
                    "x_halo")
    kw = dict(cfg=cfg, sigma_D=sigma_D, sigma_A=sigma_A, reg=reg,
              fidelity=fidelity, fid_weight=fid_weight,
              table_dims=table_dims)
    if x.device.type == "cpu":
        return cp_dual_boundary_plain(x, x_halo, x0, y_A, y_D, parts, tmul,
                                      **kw)
    return _dual_boundary_kernel(x, x_halo, x0, y_A, y_D, parts, tmul, **kw)


def _dual_boundary_kernel(x, x_halo, x0, y_A, y_D, parts, tmul=None, *,
                          cfg: TVConfig, sigma_D, sigma_A, reg, fidelity,
                          fid_weight, table_dims):
    """:func:`cp_dual_boundary`'s launch, on checked operands."""
    p = _params(cfg, tuple(x.shape), tmul is not None,
                sigma_D=float(sigma_D), sigma_A=float(sigma_A),
                reg=float(reg), fidelity=fidelity,
                fid_weight=float(fid_weight), table_dims=table_dims,
                sharded=True)
    _boundary_launch("cp_dual_boundary_launch", cfg, x, y_D, table_dims, p,
                     (x, x_halo, x0, y_A, y_D, tmul, parts))
    count("launch.B8.dual")
    return y_A, y_D, parts


def cp_primal_boundary(x, x0, y_A, y_D, y_halo, parts, tmul=None, *,
                       cfg: TVConfig, tau, fidelity="l2", fid_weight=1.0,
                       nonneg=False, table_dims=None):
    """Pass B redone on the two z-edge planes of a shard:
    ``(x, x0, y_A', y_D', y_halo, fid_parts[, tmul]) -> (x', fid_parts)``.

    After ``cp_primal(..., interior=True)`` has written planes ``1 .. Nz-2``
    of x', this writes planes 0 and ``Nz-1`` in place and rows 0 and
    ``Nz-1`` of ``fid_parts``.  ``y_halo`` ``(2, M, Nd, Nr, Nc)``: slot 0 is
    the updated dual at ``z = -1``, slot 1 at ``z = Nz``, of which only the
    z channels are read (``parallel.fused_halo._sparse_channel_halo``;
    zeros at the volume's edge).  ``table_dims``: the whole volume's
    ``(Nz, M)``."""
    _check_boundary(x, y_halo, x0, y_A, y_D, parts, tmul, cfg, table_dims,
                    "y_halo")
    kw = dict(cfg=cfg, tau=tau, fidelity=fidelity, fid_weight=fid_weight,
              nonneg=nonneg, table_dims=table_dims)
    if x.device.type == "cpu":
        return cp_primal_boundary_plain(x, x0, y_A, y_D, y_halo, parts, tmul,
                                        **kw)
    return _primal_boundary_kernel(x, x0, y_A, y_D, y_halo, parts, tmul, **kw)


def _primal_boundary_kernel(x, x0, y_A, y_D, y_halo, parts, tmul=None, *,
                            cfg: TVConfig, tau, fidelity, fid_weight, nonneg,
                            table_dims):
    """:func:`cp_primal_boundary`'s launch, on checked operands."""
    p = _params(cfg, tuple(x.shape), tmul is not None, tau=float(tau),
                fidelity=fidelity, fid_weight=float(fid_weight),
                nonneg=bool(nonneg), table_dims=table_dims, sharded=True)
    _boundary_launch("cp_primal_boundary_launch", cfg, x, y_D, table_dims, p,
                     (x, x0, y_A, y_D, y_halo, tmul, parts))
    count("launch.B8.primal")
    return x, parts


_LO = {FWD: 0, BWD: -1, CTR: -1}   # a difference's lower and upper slot,
_HI = {FWD: 1, BWD: 0, CTR: 1}     # relative to its own


def _centre(a, ext, skip=None):
    """``a`` cut to the shard along every extended axis but ``skip``
    (``ext``: axis -> planes per side)."""
    for axis, e in ext.items():
        if e and axis != skip:
            a = a[_sl(a.ndim, axis, e, a.shape[axis] - e)]
    return a


def _d_ext(x_ext, ez, et, tmul, cfg: TVConfig, table_dims=None):
    """``ops.operators.D`` on a shard: every weighted D channel at the
    shard's voxels, ``(Nz, Nd, M, Nr, Nc)``, from x extended by ``ez``
    planes per side in z and ``et`` in t.  An extended axis is differenced
    without a gate (its ghost planes stand for the volume's edge), the
    others by the zero-slot rule; the table is the whole volume's
    (``table_dims``).  With no extension and no ``table_dims`` it is ``D``,
    operation for operation."""
    ext = {0: ez, 1: et}
    Nz, M = x_ext.shape[0] - 2 * ez, x_ext.shape[1] - 2 * et
    chans, norm = scheme_channels(cfg.scheme, *(table_dims or (Nz, M)),
                                  cfg.reg_z_over_reg, cfg.reg_time)
    outs = []
    for ch in chans:
        e = ext.get(ch.axis, 0)
        if e:
            n = x_ext.shape[ch.axis] - 2 * e
            d = (x_ext[_sl(4, ch.axis, e + _HI[ch.kind], e + _HI[ch.kind] + n)]
                 - x_ext[_sl(4, ch.axis, e + _LO[ch.kind],
                             e + _LO[ch.kind] + n)])
            d = _centre(d, ext, skip=ch.axis)
        else:
            d = _centre(d_channel(x_ext, ch.axis, ch.kind), ext)
        w = channel_weight(ch, cfg.reg_z_over_reg, cfg.reg_time)
        if w != 1.0:
            d = d * w
        if ch.weight == "t" and tmul is not None:
            d = d * tmul
        outs.append(d)
    D_x = torch.stack(outs, dim=1)
    return D_x * norm if norm != 1.0 else D_x


def _dt_ext(Y_ext, ez, et, tmul, cfg: TVConfig, table_dims=None,
            weighted=True):
    """``ops.operators.D_T`` on a shard: the adjoint at the shard's voxels,
    ``(Nz, M, Nr, Nc)``, of the public-layout channels ``Y_ext`` extended by
    ``ez`` planes per side in z and ``et`` in t.  Along an extended axis a
    voxel reads its neighbour slots without a gate (a halo plane holds the
    neighbour shard's values, zeros at the volume's edge).  ``weighted``
    False leaves out the per-axis weights and ``tmul``, as the isotropic
    subgradient does (``ops.tv._subgrad_from_D``)."""
    ext = {0: ez, 1: et}
    Nz, M = Y_ext.shape[0] - 2 * ez, Y_ext.shape[2] - 2 * et
    chans, norm = scheme_channels(cfg.scheme, *(table_dims or (Nz, M)),
                                  cfg.reg_z_over_reg, cfg.reg_time)
    out = None
    for i, ch in enumerate(chans):
        y = Y_ext[:, i]
        if weighted:
            w = channel_weight(ch, cfg.reg_z_over_reg, cfg.reg_time)
            if w != 1.0:
                y = y * w
            if ch.weight == "t" and tmul is not None:
                y = y * tmul
        e = ext.get(ch.axis, 0)
        if e:
            n = y.shape[ch.axis] - 2 * e
            # FWD: y[i-1] - y[i]; BWD: y[i] - y[i+1]; CTR: y[i-1] - y[i+1]
            lo, hi = -_HI[ch.kind], -_LO[ch.kind]
            c = (y[_sl(4, ch.axis, e + lo, e + lo + n)]
                 - y[_sl(4, ch.axis, e + hi, e + hi + n)])
            c = _centre(c, ext, skip=ch.axis)
        else:
            c = _centre(dt_channel(y, ch.axis, ch.kind), ext)
        out = c if out is None else out + c
    return out * norm if norm != 1.0 else out


def _tv_parts(D_x, cfg: TVConfig, per_plane):
    """The TV term of ``D_x``: one sum, or with ``per_plane`` one per z
    plane as a column ``(Nz, 1)``."""
    if not per_plane:
        return tv_norm(D_x, cfg.norm, huber_delta=cfg.huber_delta).reshape(1)
    return torch.stack([tv_norm(D_x[z:z + 1], cfg.norm,
                                huber_delta=cfg.huber_delta)
                        for z in range(D_x.shape[0])]).reshape(-1, 1)


def _dual_update(D_x, xf, x0, y_A, y_D, *, cfg, sigma_D, sigma_A, reg,
                 fidelity, fid_weight):
    """Pass A's two prox steps from ``D_x``, written into ``y_A`` and the
    internal-layout ``y_D`` (which may be views of some planes)."""
    from ..solvers.cp import dual_prox

    y_A_new = fidelity_dual_prox(y_A.float(), xf, x0.float(), sigma_A,
                                 fidelity, fid_weight)
    p = from_internal_layout(y_D).float() + sigma_D * D_x
    y_D_new = dual_prox(p, reg, cfg.norm, sigma_D, cfg.huber_delta)
    y_A.copy_(y_A_new)
    y_D.copy_(y_D_new.transpose(1, 2))  # public -> internal layout


def _primal_update(dty, x, x0, y_A, out, *, tau, fidelity, fid_weight,
                   nonneg, per_plane):
    """Pass B from ``dty = D^T y_D'``: x' into ``out`` (views allowed) and
    the fidelity term of x', one sum or one per z plane ``(Nz, 1)``."""
    x_new = x.float() - tau * y_A.float() - tau * dty
    if nonneg:
        x_new = torch.clamp_min(x_new, 0.0)
    x0f = x0.float()
    if per_plane:
        parts = torch.stack([
            fidelity_loss(x_new[z:z + 1], x0f[z:z + 1], fidelity, fid_weight)
            for z in range(x_new.shape[0])]).reshape(-1, 1)
    else:
        parts = fidelity_loss(x_new, x0f, fidelity, fid_weight).reshape(1)
    out.copy_(x_new)
    return parts


def _edge_rows(inner, Nz):
    """``(Nz, 1)`` partials: ``inner`` for planes ``1 .. Nz-2``, zeros in
    the two edge rows the boundary pass writes."""
    parts = torch.zeros((Nz, 1), dtype=inner.dtype, device=inner.device)
    parts[1:-1] = inner
    return parts


def cp_dual_plain(x, x0, y_A, y_D, tmul=None, *, cfg: TVConfig, sigma_D,
                  sigma_A, reg, fidelity="l2", fid_weight=1.0,
                  halo_mode=False, table_dims=None, t_sharded=False,
                  interior=False):
    """Plain PyTorch version of :func:`cp_dual` (same signature, outputs and
    in-place updates), built from the ported operators: computes in float32
    and rounds to the storage dtypes where the kernel stores.  Its partials
    are one sum (``interior``: one per z plane, ``(Nz, 1)``)."""
    kw = dict(cfg=cfg, sigma_D=sigma_D, sigma_A=sigma_A, reg=reg,
              fidelity=fidelity, fid_weight=fid_weight)
    xf = x.float()
    if interior:  # the shard is its planes 1 .. Nz-2 extended by one in z
        D_x = _d_ext(xf, 1, 0, tmul, cfg, table_dims)
        _dual_update(D_x, xf[1:-1], x0[1:-1], y_A[1:-1], y_D[1:-1], **kw)
        return y_A, y_D, _edge_rows(_tv_parts(D_x, cfg, True), x.shape[0])
    if halo_mode:
        D_x = _d_ext(xf, 1, 1, tmul, cfg, table_dims)
        xf = xf[1:-1, 1:-1]
    else:
        D_x = D(xf, cfg.scheme, weight_time=tmul, **cfg.kwargs())
    _dual_update(D_x, xf, x0, y_A, y_D, **kw)
    return y_A, y_D, _tv_parts(D_x, cfg, False)


def _edge_planes(Nz):
    """(halo slot, plane) of a shard's two z-edge planes."""
    return (0, 0), (1, Nz - 1)


def _edge_window(a, halo, b, z):
    """Plane z of ``a`` between its two z neighbours, ``(3, ...)``: the
    halo stack's slot across the shard's edge, the shard's own plane on the
    other side."""
    lo = halo[0:1] if b == 0 else a[z - 1:z]
    hi = halo[1:2] if b == 1 else a[z + 1:z + 2]
    return torch.cat([lo, a[z:z + 1], hi])


def cp_dual_boundary_plain(x, x_halo, x0, y_A, y_D, parts, tmul=None, *,
                           cfg: TVConfig, sigma_D, sigma_A, reg,
                           fidelity="l2", fid_weight=1.0, table_dims=None):
    """Plain PyTorch version of :func:`cp_dual_boundary`: each edge plane is
    a one-plane shard extended in z by the halo slot and its in-shard
    neighbour; ``parts`` is the plain interior call's ``(Nz, 1)``."""
    for b, z in _edge_planes(x.shape[0]):
        one = slice(z, z + 1)
        D_x = _d_ext(_edge_window(x, x_halo, b, z).float(), 1, 0, tmul, cfg,
                     table_dims)
        _dual_update(D_x, x[one].float(), x0[one], y_A[one], y_D[one],
                     cfg=cfg, sigma_D=sigma_D, sigma_A=sigma_A, reg=reg,
                     fidelity=fidelity, fid_weight=fid_weight)
        parts[one] = _tv_parts(D_x, cfg, True)
    return y_A, y_D, parts


def tv_dual_plain(x_bar, y_D, *, cfg: TVConfig, sigma_D, reg,
                  halo_mode=False, table_dims=None):
    """Plain PyTorch version of :func:`tv_dual` (same signature, outputs
    and in-place update): the TV half of :func:`cp_dual_plain`, on the
    ghost-extended shard with ``halo_mode``."""
    from ..solvers.cp import dual_prox

    if halo_mode:
        D_x = _d_ext(x_bar.float(), 1, 1, None, cfg, table_dims)
    else:
        D_x = D(x_bar.float(), cfg.scheme, **cfg.kwargs())
    p = from_internal_layout(y_D).float() + sigma_D * D_x
    y_D_new = dual_prox(p, reg, cfg.norm, sigma_D, cfg.huber_delta)
    y_D.copy_(y_D_new.transpose(1, 2))  # public -> internal layout
    parts = tv_norm(D_x, cfg.norm, huber_delta=cfg.huber_delta).reshape(1)
    return y_D, parts


def cp_primal_plain(x, x0, y_A, y_D, tmul=None, *, cfg: TVConfig, tau,
                    fidelity="l2", fid_weight=1.0, nonneg=False, out=None,
                    halo_mode=False, table_dims=None, t_sharded=False,
                    interior=False, y_ext=None):
    """Plain PyTorch version of :func:`cp_primal`.  Its partials are one
    sum (``interior``: one per z plane, ``(Nz, 1)``)."""
    kw = dict(tau=tau, fidelity=fidelity, fid_weight=fid_weight,
              nonneg=nonneg)
    out = x if out is None else out
    if interior:  # the shard is its planes 1 .. Nz-2 extended by one in z
        dty = _dt_ext(from_internal_layout(y_D).float(), 1, 0, tmul, cfg,
                      table_dims)
        inner = _primal_update(dty, x[1:-1], x0[1:-1], y_A[1:-1], out[1:-1],
                               per_plane=True, **kw)
        return out, _edge_rows(inner, x.shape[0])
    if halo_mode:
        dty = _dt_ext(from_internal_layout(y_ext).float(), 1, 1, tmul, cfg,
                      table_dims)
    else:
        dty = D_T(from_internal_layout(y_D).float(), cfg.scheme,
                  weight_time=tmul, **cfg.kwargs())
    return out, _primal_update(dty, x, x0, y_A, out, per_plane=False, **kw)


def cp_primal_boundary_plain(x, x0, y_A, y_D, y_halo, parts, tmul=None, *,
                             cfg: TVConfig, tau, fidelity="l2",
                             fid_weight=1.0, nonneg=False, table_dims=None):
    """Plain PyTorch version of :func:`cp_primal_boundary` (see
    :func:`cp_dual_boundary_plain`)."""
    for b, z in _edge_planes(x.shape[0]):
        one = slice(z, z + 1)
        win = from_internal_layout(_edge_window(y_D, y_halo, b, z)).float()
        dty = _dt_ext(win, 1, 0, tmul, cfg, table_dims)
        parts[one] = _primal_update(dty, x[one], x0[one], y_A[one], x[one],
                                    tau=tau, fidelity=fidelity,
                                    fid_weight=fid_weight, nonneg=nonneg,
                                    per_plane=True)
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


# ---------------------------------------------------------------------------
# TV value and subgradient (B3/B4)
# ---------------------------------------------------------------------------


def tv_norms(x, tmul=None, *, cfg: TVConfig, halo_mode=False,
             table_dims=None):
    """Pass 1: ``(x[, tmul]) -> (norms, tv_parts)``.

    ``norms`` (float32, shaped like x): the per-voxel gradient norm with
    +inf where it is 0 (iso), the sum of |channels| (aniso) or the raw norm
    (huber); ``tv_parts`` sum to the TV value.  ``tmul``: optional float32
    (Nr, Nc) multiplier of the time channels
    (``dispatch.t_plane_multiplier``).

    On a shard (module docstring): with ``halo_mode`` x is
    ``(Nz+2, M+2, Nr, Nc)`` and the norms come back in the shard's shape;
    ``table_dims``: the whole volume's ``(Nz, M)``."""
    _check_tensors(x)
    _check_volume(x, cfg, table_dims, int(halo_mode))
    _check_tmul(tmul, x)
    if x.device.type == "cpu":
        return tv_norms_plain(x, tmul, cfg=cfg, halo_mode=halo_mode,
                              table_dims=table_dims)
    return _tv_norms_kernel(x, tmul, cfg=cfg, halo_mode=halo_mode,
                            table_dims=table_dims)


def _tv_norms_kernel(x, tmul=None, *, cfg: TVConfig, halo_mode=False,
                     table_dims=None):
    """:func:`tv_norms`'s launch, on checked operands: the kernel of the
    scheme's channel table (``csrc/specialised_tv.cu``), on a shard its
    halo-mode instance with the whole volume's table."""
    shape = _shard_shape(x, int(halo_mode))
    p = _params(cfg, shape, tmul is not None,
                **_shard_fields(halo_mode, False, table_dims, xe=1))
    norms = torch.empty(shape, dtype=torch.float32, device=x.device)
    fn = "spectv_norms_halo_launch" if halo_mode else "spectv_norms_launch"
    parts = _spec_launch(fn, cfg, norms, p, (int(x.dtype == torch.bfloat16),),
                         (x, tmul, norms), with_parts=True,
                         table_dims=table_dims)
    count("launch.B3")
    return norms, parts


def tv_subgrad(x, norms, tmul=None, *, cfg: TVConfig, halo_mode=False,
               table_dims=None):
    """Pass 2: ``(x, norms[, tmul]) -> G`` in x's dtype, with ``norms``
    from :func:`tv_norms` (the aniso G does not read them).

    On a shard (module docstring): with ``halo_mode`` x is
    ``(Nz+4, M+4, Nr, Nc)``, ``norms`` ``(Nz+2, M+2, Nr, Nc)`` with divisors
    at its ghost planes that are safe (nonzero; the differences there are
    zero), or None for aniso, and G has the shard's shape; ``table_dims``:
    the whole volume's ``(Nz, M)``."""
    aniso = cfg.norm == "aniso"
    if halo_mode and aniso and norms is None:
        _check_tensors(x)
    else:
        _check_tensors(x, norms=norms)
    _check_volume(x, cfg, table_dims, 2 * int(halo_mode))
    shape = _shard_shape(x, 2 * int(halo_mode))
    if norms is not None:
        want = tuple(n + 2 * int(halo_mode) for n in shape[:2]) + shape[2:]
        if norms.dtype != torch.float32 or tuple(norms.shape) != want:
            raise ValueError(f"norms must be float32 {want}, got "
                             f"{tuple(norms.shape)} {norms.dtype}")
    _check_tmul(tmul, x)
    if x.device.type == "cpu":
        return tv_subgrad_plain(x, norms, tmul, cfg=cfg, halo_mode=halo_mode,
                                table_dims=table_dims)
    return _tv_subgrad_kernel(x, None if aniso else norms, tmul, cfg=cfg,
                              halo_mode=halo_mode, table_dims=table_dims)


def _tv_subgrad_kernel(x, norms, tmul=None, *, cfg: TVConfig,
                       halo_mode=False, table_dims=None):
    """:func:`tv_subgrad`'s launch, on checked operands: the kernel of the
    scheme's channel table (``csrc/specialised.cu``), on a shard its
    halo-mode instance with the whole volume's table."""
    shape = _shard_shape(x, 2 * int(halo_mode))
    p = _params(cfg, shape, tmul is not None,
                **_shard_fields(halo_mode, False, table_dims, xe=2, ne=1))
    g = torch.empty(shape, dtype=x.dtype, device=x.device)
    fn = ("spec_tv_subgrad_halo_launch" if halo_mode
          else "spec_tv_subgrad_launch")
    _spec_launch(fn, cfg, g, p, (int(x.dtype == torch.bfloat16),),
                 (x, norms, tmul, g), table_dims=table_dims)
    count("launch.B4")
    return g


def tv_gd_step(x, x0, norms, tmul=None, *, cfg: TVConfig, reg,
               step_size):
    """Pass 2 with the subgradient-descent step in its epilogue:
    ``(x, x0, norms[, tmul]) -> (x', fid_parts)``, ``x' = x - step_size
    ((x - x0) + reg G)`` in x's dtype, G as :func:`tv_subgrad` gives it
    from ``norms``, which is not stored.  x' is a new tensor (x0 may be
    x); ``fid_parts`` (float32) sum to ``0.5 sum((x' - x0)^2)``.  x' equals
    the eager update on :func:`tv_subgrad`'s G to the bit, float32 or
    bfloat16: each of the update's five operations rounds to x's dtype."""
    _check_tensors(x, x0=x0, norms=norms)
    _check_like(x, x0=x0)
    _check_volume(x, cfg)
    if norms.dtype != torch.float32 or norms.shape != x.shape:
        raise ValueError(f"norms must be float32 {tuple(x.shape)}, got "
                         f"{tuple(norms.shape)} {norms.dtype}")
    _check_tmul(tmul, x)
    kw = dict(cfg=cfg, reg=reg, step_size=step_size)
    if x.device.type == "cpu":
        return tv_gd_step_plain(x, x0, norms, tmul, **kw)
    return _tv_gd_kernel(x, x0, None if cfg.norm == "aniso" else norms,
                         tmul, **kw)


@functools.lru_cache(maxsize=64)
def _gd_params(cfg: TVConfig, shape, has_tmul, reg, step_size):
    """Pass 2's Params with the GD epilogue's scalars: ``reg`` the weight
    of G, ``tau`` the step, ``fid_scale`` 0.5."""
    p = _Params.from_buffer_copy(_params(cfg, shape, has_tmul))
    p.reg, p.tau, p.fid_scale = reg, step_size, 0.5
    return p


def _tv_gd_kernel(x, x0, norms, tmul=None, *, cfg: TVConfig, reg,
                  step_size):
    """:func:`tv_gd_step`'s launch, on checked operands: the GD instance of
    pass 2's kernel for the scheme's channel table
    (``csrc/specialised.cu``)."""
    p = _gd_params(cfg, tuple(x.shape), tmul is not None, float(reg),
                   float(step_size))
    out = torch.empty_like(x)
    parts = _spec_launch("spec_tv_gd_launch", cfg, x, p,
                         (int(x.dtype == torch.bfloat16),),
                         (x, x0, norms, tmul, out), with_parts=True)
    count("launch.B4")
    count("launch.B4_gd")
    return out, parts


def tv_norms_plain(x, tmul=None, *, cfg: TVConfig, halo_mode=False,
                   table_dims=None):
    """Plain PyTorch version of :func:`tv_norms` (same signature and
    outputs), from the ported operators, in float32."""
    if halo_mode:
        D_x = _d_ext(x.float(), 1, 1, tmul, cfg, table_dims)
    else:
        D_x = D(x.float(), cfg.scheme, weight_time=tmul, **cfg.kwargs())
    tv, norms = tv_norm(D_x, cfg.norm, return_array=True,
                        huber_delta=cfg.huber_delta)
    if cfg.norm == "iso":
        norms = torch.where(norms == 0, torch.inf, norms)
    return norms, tv.reshape(1)


def tv_subgrad_plain(x, norms, tmul=None, *, cfg: TVConfig, halo_mode=False,
                     table_dims=None):
    """Plain PyTorch version of :func:`tv_subgrad`: computes in float32 and
    rounds G to x's dtype."""
    if halo_mode:
        # the channels on the shard and one plane around it (the 2-deep x
        # is that block extended by one), their values y there, and the
        # adjoint of the 1-deep extended y at the shard
        D_x = _d_ext(x.float(), 1, 1, tmul, cfg, table_dims)
        if cfg.norm == "aniso":
            Y = torch.sign(D_x)
        elif cfg.norm == "huber":
            Y = D_x / torch.clamp_min(norms, cfg.huber_delta)[:, None]
        else:
            Y = D_x / norms[:, None]
        G = _dt_ext(Y, 1, 1, tmul, cfg, table_dims,
                    weighted=cfg.norm != "iso")
        return G.to(x.dtype)
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


def tv_gd_step_plain(x, x0, norms, tmul=None, *, cfg: TVConfig, reg,
                     step_size):
    """Plain PyTorch version of :func:`tv_gd_step`: G from
    :func:`tv_subgrad_plain`, then the solver's eager update
    (``solvers.gd._update``), whose loss at a TV of 0 is the one fidelity
    partial."""
    from ..ops.space import TENSOR
    from ..solvers import gd

    G = tv_subgrad_plain(x, norms, tmul, cfg=cfg)
    x, fid, _ = gd._update(TENSOR, lambda _: (0.0, G), x, x0, reg, step_size)
    return x, fid.float().reshape(1)


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
