"""The numbers that decide ``correct``: what a timed solve produced against
the plain reference's solve of the same inputs.

- ``loss_rel``: the largest ``|loss_i - ref_i| / |ref_i|`` over every
  iteration of every solve in the window;
- ``x_rel_l2``: ``||x - x_ref|| / ||x_ref - x_start||`` of the sampled
  solve's output, ``x_start`` the solver's starting point (the noisy
  volume for denoising, zero for a reconstruction): the error against
  what the solve changed;
- ``x_max_rel``: ``max |x - x_ref| / (max x_ref - min x_ref)``.

A non-finite reading is ``None``, and fails its limit."""

from __future__ import annotations

import math

import torch


def _finite(v: float):
    return v if math.isfinite(v) else None


def numbers(x, losses, x_ref, ref_losses, x_start=None, block: int = 4):
    """The three readings; the volumes are compared ``block`` z-planes at a
    time in float64."""
    L = torch.stack([lo.double().cpu() for lo in losses])
    R = ref_losses.double().cpu()[None]
    loss_rel = float(torch.max(torch.abs(L - R) / torch.abs(R)))
    err2 = base2 = 0.0
    err_max = 0.0
    hi, lo = -math.inf, math.inf
    for z0 in range(0, x_ref.shape[0], block):
        r = x_ref[z0:z0 + block].double()
        d = x[z0:z0 + block].to(r.device).double() - r
        err2 += float(torch.sum(d * d))
        m = float(torch.max(torch.abs(d)))
        if not math.isfinite(m) or m > err_max:  # a NaN stays
            err_max = m
        s = r if x_start is None else r - x_start[z0:z0 + block].double()
        base2 += float(torch.sum(s * s))
        hi, lo = max(hi, float(torch.max(r))), min(lo, float(torch.min(r)))
    return {"loss_rel": _finite(loss_rel),
            "x_rel_l2": _finite(math.sqrt(err2 / base2)),
            "x_max_rel": _finite(err_max / (hi - lo))}


def judge(readings: dict, limits: dict):
    """``(correct, checks)``: each number ``limits`` names, with its
    limit; correct when every one is finite and within it."""
    checks, ok = {}, True
    for name, limit in limits.items():
        v = readings.get(name)
        checks[name] = {"value": v, "limit": limit}
        ok = ok and v is not None and v <= limit
    return ok, checks
