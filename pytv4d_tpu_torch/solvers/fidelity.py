"""Data-fidelity terms of the primal-dual denoising solver.

The port of ``pytv4d_tpu/solvers/fidelity.py``:

- ``'l2'``  — ``F(v) = weight/2 ||v - b||^2`` (Gaussian noise; the default),
- ``'l1'``  — ``F(v) = weight ||v - b||_1`` (impulsive noise; TV-L1,
  Chan & Esedoglu 2005),
- ``'kl'``  — ``F(v) = weight * sum(v - b log v)`` (Poisson log-likelihood;
  Chambolle & Pock 2011 section 6.3.2 give the conjugate prox used here).

``weight`` may be a scalar or a tensor broadcastable to ``b``; every formula
below is pointwise.
"""

from __future__ import annotations

import torch

FIDELITIES = ("l2", "l1", "kl")


def _any(x, op) -> bool:
    """``any(op(x))``; a tensor reduces on its own device and only the one
    flag crosses to the host."""
    if isinstance(x, torch.Tensor):
        return bool(torch.any(op(x)))
    return bool(torch.any(op(torch.as_tensor(x))))


def validate_fidelity(fidelity: str, b, weight) -> None:
    """Eager argument checks: the fidelity name, ``weight > 0`` and, for
    ``'kl'``, ``b >= 0``."""
    if fidelity not in FIDELITIES:
        raise ValueError(
            f"fidelity must be one of {FIDELITIES}, got {fidelity!r}"
        )
    if _any(weight, lambda w: w <= 0):
        raise ValueError("fidelity_weight must be positive")
    if fidelity == "kl" and _any(b, lambda v: v < 0):
        raise ValueError(
            "fidelity='kl' requires nonnegative data b (Poisson counts)"
        )


def fidelity_dual_prox(y, Ax, b, sigma, fidelity: str = "l2", weight=1.0):
    """``prox_{sigma F*}(y + sigma A x_bar)`` for the data term ``F``.

    - l2: the linear resolvent ``(y + sigma (Ax - b)) / (1 + sigma/w)``;
    - l1: the box projection ``clip(y + sigma (Ax - b), -w, w)``;
    - kl: the root ``p = ((w+q) - sqrt((q-w)^2 + 4 sigma w b)) / 2`` of the
      pointwise prox quadratic, ``q = y + sigma Ax``.
    """
    if fidelity == "l1":
        return torch.clamp(y + sigma * (Ax - b), -weight, weight)
    if fidelity == "kl":
        q = y + sigma * Ax
        s = q - weight
        return 0.5 * (q + weight - torch.sqrt(s * s + 4.0 * sigma * weight * b))
    return (y + sigma * (Ax - b)) / (1.0 + sigma / weight)


def fidelity_loss(Ax, b, fidelity: str = "l2", weight=1.0):
    """The data term of the reported objective.

    For ``'kl'`` the nonnegative Csiszar form ``sum w (Ax - b + b log(b /
    Ax))`` is reported: zero at a perfect fit and finite for ``b = 0``."""
    if fidelity == "l1":
        return torch.sum(weight * torch.abs(Ax - b))
    if fidelity == "kl":
        ax = torch.clamp_min(Ax, 1e-30)
        ent = torch.where(b > 0.0, b * torch.log(torch.clamp_min(b, 1e-30) / ax),
                          torch.zeros_like(b))
        return torch.sum(weight * (Ax - b + ent))
    return 0.5 * torch.sum(weight * torch.square(Ax - b))


def fidelity_conjugate(y, b, fidelity: str = "l2", weight=1.0):
    """``(y_feasible, F*(y_feasible))``: the convex conjugate of the data
    term, with ``y`` first projected onto ``dom F*`` so the value is finite
    for any input (used by duality-gap certificates).

    - l2: ``F* = <y, b> + sum y^2/(2w)`` (``w = 0`` forces ``y = 0``),
    - l1: ``F* = <y, b>`` on the box ``|y| <= w``,
    - kl: ``F* = -sum w b log(1 - y/w)`` on ``y <= (1 - 1e-6) w``.
    """
    w = torch.as_tensor(weight, dtype=y.dtype, device=y.device)
    zero = torch.zeros((), dtype=y.dtype, device=y.device)
    if fidelity == "l1":
        y = torch.minimum(torch.maximum(y, -w), w)
        return y, torch.sum(y * b)
    live = w > 0
    if fidelity == "kl":
        y = torch.where(live, torch.minimum(y, (1.0 - 1e-6) * w), zero)
        safe_w = torch.where(live, w, torch.ones_like(w))
        val = -torch.sum(torch.where(live & (b > 0.0),
                                     w * b * torch.log1p(-y / safe_w), zero))
        return y, val
    y = torch.where(live, y, zero)
    safe_w = torch.where(live, w, torch.ones_like(w))
    val = torch.sum(y * b) + torch.sum(
        torch.where(live, torch.square(y) / (2.0 * safe_w), zero))
    return y, val
