"""TV gradient operators D / D_T and the TV norms on torch tensors.

The port of ``pytv4d_tpu/ops/operators.py``: one implementation generated
from the stencil tables in ``core/schemes.py``, written as pads and slices
so it runs on any device and dtype (float64 on the CPU reproduces the
reference's golden values to round-off).

Semantics matched to the reference (SURVEY.md section 2.2):

- input layout ``(Nz, M, N_row, N_col)``; D output ``(Nz, Nd, M, N_row, N_col)``
  (``pytv/tv_operators_CPU.py:97``).
- one-sided zero boundary convention (``tv_operators_CPU.py:115-127``).
- z/t channels pre-scaled by sqrt(reg) in both D and D_T
  (``tv_operators_CPU.py:133,143,419``).
- static-mask factor on time channels: applied to channel values in D
  (``tv_operators_CPU.py:148-151``) and to the accumulated time update after
  the scatter in D_T (``tv_operators_CPU.py:430-446``).
- scheme normalizations: hybrid 1/sqrt(2), central 1/2
  (``tv_operators_CPU.py:154,358,448,658``).
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from ..core.schemes import BWD, CTR, FWD, channel_weight, scheme_channels

__all__ = [
    "compute_L21_norm",
    "compute_L11_norm",
    "compute_huber_norm",
    "tv_norm",
    "abs_d_channel",
    "abs_dt_channel",
    "precond_maps",
    "D",
    "D_T",
    "D_upwind",
    "D_downwind",
    "D_central",
    "D_hybrid",
    "D_T_upwind",
    "D_T_downwind",
    "D_T_central",
    "D_T_hybrid",
]


def mask_enabled(mask_static) -> bool:
    """The reference's "disabled" sentinel is any bool (``tv_operators_CPU.py:148``:
    ``isinstance(mask_static, bool)``); we additionally accept None and []."""
    if mask_static is None or isinstance(mask_static, bool):
        return False
    if isinstance(mask_static, (list, tuple)) and len(mask_static) == 0:
        return False
    return True


def check_volume(img, ndim: int = 4, what: str = "img"):
    """All operator entry points require the canonical rank — the reference
    silently assumes it and crashes confusingly otherwise (its GPU docstrings
    even claim 2D/3D input works, SURVEY.md section 2.4.7).  2D/3D images are
    handled by ``models.TVDenoiser`` / ``utils.as_volume``."""
    if img.ndim != ndim:
        expect = "(Nz, M, N_row, N_col)" if ndim == 4 else "(Nz, Nd, M, N_row, N_col)"
        raise ValueError(
            f"{what} must be rank {ndim} with layout {expect}, got shape "
            f"{tuple(img.shape)}; wrap 2D/3D images with utils.as_volume or "
            f"use models.TVDenoiser which accepts 2D/3D/4D"
        )


def _sl(ndim: int, axis: int, a, b):
    s = [slice(None)] * ndim
    s[axis] = slice(a, b)
    return tuple(s)


def _pad(arr, axis: int, before: int, after: int):
    # F.pad lists (before, after) pairs from the LAST axis backwards
    pads = [0, 0] * (arr.ndim - 1 - axis) + [before, after]
    return F.pad(arr, pads)


def d_channel(img, axis: int, kind: str):
    """One unweighted difference channel with the zero-slot boundary convention.

    FWD: d[i] = f[i+1]-f[i] at slots [0, L-2]   (``tv_operators_CPU.py:265``)
    BWD: d[i] = f[i]-f[i-1] at slots [1, L-1]   (``tv_operators_CPU.py:199``)
    CTR: d[i] = f[i+1]-f[i-1] at slots [1, L-2] (``tv_operators_CPU.py:331``)
    """
    nd = img.ndim
    if kind == CTR:
        d = img[_sl(nd, axis, 2, None)] - img[_sl(nd, axis, None, -2)]
        return _pad(d, axis, 1, 1)
    d = img[_sl(nd, axis, 1, None)] - img[_sl(nd, axis, None, -1)]
    if kind == FWD:
        return _pad(d, axis, 0, 1)
    return _pad(d, axis, 1, 0)


def dt_channel(y, axis: int, kind: str):
    """Exact adjoint scatter of one channel.

    Reads only the channel's valid slots (the reference ignores values parked
    in zero slots, e.g. ``tv_operators_CPU.py:555-556`` reads ``img[:,0,:,:-1,:]``)
    and scatter-adds with opposite signs:

    FWD: out[i+1] += y[i], out[i]   -= y[i]  for i in [0, L-2]
    BWD: out[i]   += y[i], out[i-1] -= y[i]  for i in [1, L-1]
    CTR: out[i+1] += y[i], out[i-1] -= y[i]  for i in [1, L-2]
    """
    nd = y.ndim
    if kind == FWD:
        t = y[_sl(nd, axis, None, -1)]
        return _pad(t, axis, 1, 0) - _pad(t, axis, 0, 1)
    if kind == BWD:
        t = y[_sl(nd, axis, 1, None)]
        return _pad(t, axis, 1, 0) - _pad(t, axis, 0, 1)
    t = y[_sl(nd, axis, 1, -1)]
    return _pad(t, axis, 2, 0) - _pad(t, axis, 0, 2)


def abs_d_channel(img, axis: int, kind: str):
    """|D| row pattern: like :func:`d_channel` but summing |entries|
    (x[i+1] + x[i] instead of the difference) — used for diagonal
    preconditioning (Pock & Chambolle 2011, doi 10.1109/ICCV.2011.6126441)."""
    nd = img.ndim
    if kind == CTR:
        s = img[_sl(nd, axis, 2, None)] + img[_sl(nd, axis, None, -2)]
        return _pad(s, axis, 1, 1)
    s = img[_sl(nd, axis, 1, None)] + img[_sl(nd, axis, None, -1)]
    if kind == FWD:
        return _pad(s, axis, 0, 1)
    return _pad(s, axis, 1, 0)


def abs_dt_channel(y, axis: int, kind: str):
    """|D^T| column pattern: scatter of |entries| (both signs +)."""
    nd = y.ndim
    if kind == FWD:
        t = y[_sl(nd, axis, None, -1)]
        return _pad(t, axis, 1, 0) + _pad(t, axis, 0, 1)
    if kind == BWD:
        t = y[_sl(nd, axis, 1, None)]
        return _pad(t, axis, 1, 0) + _pad(t, axis, 0, 1)
    t = y[_sl(nd, axis, 1, -1)]
    return _pad(t, axis, 2, 0) + _pad(t, axis, 0, 2)


def precond_maps(
    shape,
    scheme: str = "hybrid",
    reg_z_over_reg: float = 1.0,
    reg_time: float = 0.0,
    sigma_A_rows: float = 1.0,
    *,
    fidelity_colsum=None,
    grouped: bool = False,
    dtype=torch.float32,
    device,
):
    """Diagonal preconditioners for CP on ``K = [A; D]`` (alpha = 1):
    per-dual-slot ``sigma = 1/sum_i |K_ji|`` and per-pixel
    ``tau = 1/sum_j |K_ji|`` — dead dual slots get sigma = 0 (they carry
    no information and stay at zero).  The fidelity block's column sums
    default to the scalar ``sigma_A_rows`` (``A = I`` denoising); for a
    general forward operator pass ``fidelity_colsum = |A|^T 1`` — exact
    whenever A has nonnegative coefficients (CT projectors, blurs and
    masks), where ``|A|^T 1 = A^T 1``.  ``grouped`` gives one step per
    pixel group (the iso/Huber channel-group prox is exact only for a
    scalar step per group): the group minimum of the per-channel bounds,
    ``1/max(row sums)``, which is below every row-sum bound.  Returns
    ``(sigma_D_map, tau_map)`` in ``dtype`` on ``device``."""
    sigma_D, col_sum = precond_parts(shape, scheme, reg_z_over_reg, reg_time,
                                     grouped=grouped, dtype=dtype,
                                     device=device)
    fid = sigma_A_rows if fidelity_colsum is None else fidelity_colsum
    den = col_sum + fid
    tau = 1.0 / torch.where(den > 0, den, 1.0)
    return sigma_D, tau


def precond_parts(shape, scheme: str = "hybrid", reg_z_over_reg: float = 1.0,
                  reg_time: float = 0.0, *, grouped: bool = False,
                  dtype=torch.float32, device, table_dims=None):
    """The D block of :func:`precond_maps`: ``(sigma_D_map, |D|^T 1)``.
    ``table_dims``: the ``(Nz, M)`` the channel table is taken at, where
    ``shape`` is a window of a larger volume (``parallel.halo``'s
    ``grid_precond_maps``)."""
    Nz, M = table_dims or (shape[0], shape[1])
    chans, norm = scheme_channels(scheme, Nz, M, reg_z_over_reg, reg_time)
    ones = torch.ones(tuple(shape), dtype=dtype, device=device)
    row_sums = []
    col_sum = None
    for ch in chans:
        w = abs(channel_weight(ch, reg_z_over_reg, reg_time)) * norm
        rs = abs_d_channel(ones, ch.axis, ch.kind) * w
        row_sums.append(rs)
        # |D^T| column contribution: scatter |w| over the channel's valid slots
        valid = (rs > 0).to(dtype)
        cs = abs_dt_channel(valid, ch.axis, ch.kind) * w
        col_sum = cs if col_sum is None else col_sum + cs
    rows = torch.stack(row_sums, dim=1)
    if grouped:
        rows = torch.amax(rows, dim=1, keepdim=True)
    live = rows > 0
    sigma_D = torch.where(live, 1.0 / torch.where(live, rows, 1.0), 0.0)
    return sigma_D, col_sum


# torch's CPU sqrt kernel can return values off by up to 3e-4 relative
# (float32) on its first call in a process when that call runs on several
# threads (torch 2.13.0+cpu on an 8-core AVX-512 CPU, about one process in
# five; tests/test_torch_first_sqrt.py).  A first call on one element, which
# runs on one thread, avoids it.
for _dtype in (torch.float32, torch.float64):
    torch.sqrt(torch.ones(1, dtype=_dtype))


def _safe_sqrt(s):
    """sqrt that maps 0 to 0 through a where (the JAX package's double-where
    form, kept so the primal is bit-identical to it)."""
    zero = s == 0
    return torch.where(zero, torch.zeros_like(s),
                       torch.sqrt(torch.where(zero, torch.ones_like(s), s)))


def compute_L21_norm(D_img, return_array: bool = False):
    """L2,1 norm of a difference image: sum_i sqrt(sum_j D[i,j]^2).

    Mirrors ``pytv/tv_operators_CPU.py:45-74``: square, sum over the channel
    axis (axis 1), sqrt, global sum; optionally also returns the
    ``(Nz, M, N_row, N_col)`` array of per-pixel L2 norms.
    """
    out = _safe_sqrt(torch.sum(torch.square(D_img), dim=1))
    l21 = torch.sum(out)
    if return_array:
        return l21, out
    return l21


def compute_L11_norm(D_img, return_array: bool = False):
    """Anisotropic L1,1 norm of a difference image: sum |D| (framework
    extension; the reference is isotropic-only)."""
    out = torch.sum(torch.abs(D_img), dim=1)
    total = torch.sum(out)
    if return_array:
        return total, out
    return total


def compute_huber_norm(D_img, delta: float, return_array: bool = False):
    """Huber-smoothed L2,1 norm: per-pixel gradient magnitude n = |D[i,:]|_2
    scored ``n^2/(2 delta)`` below ``delta`` and ``n - delta/2`` above
    (Chambolle & Pock 2011 section 6.2).  Optionally also returns the
    per-pixel magnitude array."""
    n = _safe_sqrt(torch.sum(torch.square(D_img), dim=1))
    val = torch.sum(torch.where(n <= delta, torch.square(n) / (2.0 * delta),
                                n - delta / 2.0))
    if return_array:
        return val, n
    return val


def tv_norm(D_img, norm: str = "iso", return_array: bool = False,
            huber_delta: float = 1.0):
    """The TV reduction for any norm type ('iso', 'aniso', 'huber')."""
    if norm == "aniso":
        return compute_L11_norm(D_img, return_array=return_array)
    if norm == "huber":
        return compute_huber_norm(D_img, huber_delta, return_array=return_array)
    return compute_L21_norm(D_img, return_array=return_array)


def _as_like(arr, ref):
    """A weight field as a tensor of ``ref``'s dtype on its device."""
    return torch.as_tensor(arr, device=ref.device).to(ref.dtype)


def _as_mask(mask_static, ref):
    """A static mask as a bool tensor on ``ref``'s device (nonzero = on)."""
    return torch.as_tensor(mask_static, device=ref.device).bool()


def D(
    img,
    scheme: str = "hybrid",
    reg_z_over_reg: float = 1.0,
    reg_time: float = 0.0,
    mask_static=False,
    factor_reg_static: float = 0.0,
    weight_time=None,
):
    """Discrete gradient operator; output ``(Nz, Nd, M, N_row, N_col)``.

    Parity: ``pytv/tv_operators_CPU.py:76-358`` (all four ``D_<scheme>``).
    ``weight_time`` (broadcastable to ``(Nz, M, N_row, N_col)``) multiplies
    the time channels, and :func:`D_T` applies it before the scatter, so the
    pair stays exactly adjoint for any weight field.
    """
    check_volume(img)
    Nz, M = img.shape[0], img.shape[1]
    chans, norm = scheme_channels(scheme, Nz, M, reg_z_over_reg, reg_time)
    use_mask = mask_enabled(mask_static)
    sqrt_factor = math.sqrt(factor_reg_static) if use_mask else 1.0
    mask = _as_mask(mask_static, img) if use_mask else None
    wt = _as_like(weight_time, img) if weight_time is not None else None

    outs = []
    for ch in chans:
        d = d_channel(img, ch.axis, ch.kind)
        w = channel_weight(ch, reg_z_over_reg, reg_time)
        if w != 1.0:
            d = d * w
        if ch.weight == "t":
            if use_mask:
                d = torch.where(mask, d * sqrt_factor, d)
            if wt is not None:
                d = d * wt
        outs.append(d)
    D_img = torch.stack(outs, dim=1)
    if norm != 1.0:
        D_img = D_img * norm
    return D_img


def D_T(
    D_img,
    scheme: str = "hybrid",
    reg_z_over_reg: float = 1.0,
    reg_time: float = 0.0,
    mask_static=False,
    factor_reg_static: float = 0.0,
    weight_time=None,
):
    """Exact transpose of :func:`D`; output ``(Nz, M, N_row, N_col)``.

    Parity: ``pytv/tv_operators_CPU.py:360-658`` (all four ``D_T_<scheme>``).
    The static-mask factor is applied to the *accumulated time update* after
    the scatter, exactly as the reference does (``tv_operators_CPU.py:430-446``).
    """
    check_volume(D_img, 5, "D_img")
    Nz, M = D_img.shape[0], D_img.shape[2]
    chans, norm = scheme_channels(scheme, Nz, M, reg_z_over_reg, reg_time)
    if D_img.shape[1] != len(chans):
        raise ValueError(
            f"D_img has {D_img.shape[1]} channels but scheme {scheme!r} with "
            f"Nz={Nz}, M={M}, reg_z_over_reg={reg_z_over_reg}, "
            f"reg_time={reg_time} expects {len(chans)}"
        )
    use_mask = mask_enabled(mask_static)
    sqrt_factor = math.sqrt(factor_reg_static) if use_mask else 1.0
    wt = _as_like(weight_time, D_img) if weight_time is not None else None

    out = None
    out_time = None
    for i, ch in enumerate(chans):
        y = D_img[:, i]
        w = channel_weight(ch, reg_z_over_reg, reg_time)
        if w != 1.0:
            y = y * w
        if ch.weight == "t" and wt is not None:
            y = y * wt  # pre-scatter (exact transpose of D's weighting)
        contrib = dt_channel(y, ch.axis, ch.kind)
        if use_mask and ch.weight == "t":
            out_time = contrib if out_time is None else out_time + contrib
        else:
            out = contrib if out is None else out + contrib
    if out is None:
        out = torch.zeros((Nz, M, D_img.shape[3], D_img.shape[4]),
                          dtype=D_img.dtype, device=D_img.device)
    if out_time is not None:
        mask = _as_mask(mask_static, D_img)
        out = out + torch.where(mask, out_time * sqrt_factor, out_time)
    if norm != 1.0:
        out = out * norm
    return out


def _scheme_partial(fn, scheme):
    partial = functools.partial(fn, scheme=scheme)
    partial.__name__ = f"{fn.__name__}_{scheme}"
    partial.__qualname__ = partial.__name__
    partial.__doc__ = f"{fn.__name__}(..., scheme={scheme!r}); see :func:`{fn.__name__}`."
    return partial


D_upwind = _scheme_partial(D, "upwind")
D_downwind = _scheme_partial(D, "downwind")
D_central = _scheme_partial(D, "central")
D_hybrid = _scheme_partial(D, "hybrid")
D_T_upwind = _scheme_partial(D_T, "upwind")
D_T_downwind = _scheme_partial(D_T, "downwind")
D_T_central = _scheme_partial(D_T, "central")
D_T_hybrid = _scheme_partial(D_T, "hybrid")
