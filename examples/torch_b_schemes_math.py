"""The four discretization schemes on hand-computable examples: the
PyTorch/CUDA twin of ``examples/b_schemes_math.py`` (the reference's
``examples/b_TV_discretizations_math.ipynb`` content as a script).

For the 5x5 single-hot image A (A[2,2] = 1):

    TV_upwind(A) = TV_downwind(A) = 2 + sqrt(2)
    TV_central(A) = 2
    TV_hybrid(A) = 3 sqrt(2)

Each scheme is an ordered list of finite-difference channels
(``pytv4d_tpu_torch.core.schemes``); D maps an image to its per-pixel
difference vectors, the TV is the L2,1 norm of that stack, and D_T is the
exact adjoint.  Runs on the CUDA device (``--device cpu`` for the CPU; no
fallback):

    python examples/torch_b_schemes_math.py [--device cpu]
"""

# Allow running from a repo checkout without installation.
import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse
import math

import numpy as np
import torch

import pytv4d_tpu_torch as pytv
from pytv4d_tpu_torch.core.schemes import scheme_channels

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda)")
dev = torch.device(parser.parse_args().device)
if dev.type == "cuda" and not torch.cuda.is_available():
    raise RuntimeError("no CUDA device; pass --device cpu to run on the CPU")


def on(a):
    return torch.as_tensor(a, device=dev)


def host(t):
    return t.cpu().numpy()


A = np.zeros((1, 1, 5, 5))
A[0, 0, 2, 2] = 1.0

print("single-hot 5x5 image A; analytic TV values:")
for scheme, want in [
    ("upwind", 2 + math.sqrt(2)),
    ("downwind", 2 + math.sqrt(2)),
    ("central", 2.0),
    ("hybrid", 3 * math.sqrt(2)),
]:
    tv, G = getattr(pytv, f"tv_{scheme}")(on(A))
    chans, norm = scheme_channels(scheme, 1, 1)
    print(
        f"  {scheme:9s}: TV = {float(tv):.10f} (analytic {want:.10f}); "
        f"Nd = {len(chans)}, normalization = {norm:.4f}"
    )

print("\nchannel tables (axis, kind) per scheme on a (6, 3, N, N) volume with"
      " reg_time > 0:")
names = {0: "z", 1: "t", 2: "row", 3: "col"}
for scheme in ("upwind", "downwind", "central", "hybrid"):
    chans, norm = scheme_channels(scheme, 6, 3, 1.0, 1.0)
    desc = ", ".join(f"{names[c.axis]}-{c.kind}" for c in chans)
    print(f"  {scheme:9s}: [{desc}] x {norm:.4f}")

print("\nexact subgradient matrices of the single-hot image (closed forms "
      "verified; note G at the hot pixel EQUALS the TV value — TV is "
      "1-homogeneous, so <G, A> = TV(A)):")
s2 = math.sqrt(2)
expect = {
    "upwind": {(1, 2): -1.0, (2, 1): -1.0, (3, 2): -s2 / 2, (2, 3): -s2 / 2,
               (2, 2): 2 + s2},
    "central": {(0, 2): -0.5, (2, 0): -0.5, (2, 4): -0.5, (4, 2): -0.5,
                (2, 2): 2.0},
    "hybrid": {(1, 2): -3 * s2 / 4, (2, 1): -3 * s2 / 4, (3, 2): -3 * s2 / 4,
               (2, 3): -3 * s2 / 4, (2, 2): 3 * s2},
}
for scheme, entries in expect.items():
    _, G = getattr(pytv, f"tv_{scheme}")(on(A))
    G = host(G)[0, 0]
    for (i, j), want in entries.items():
        assert abs(G[i, j] - want) < 1e-6, (scheme, (i, j), G[i, j], want)
    print(f"--- {scheme} ---")
    print(np.array_str(G, precision=4, suppress_small=True))

# Boundary convention: the last forward-difference slot of a ramp is zero.
ramp = np.arange(5.0)[None, None, :, None] * np.ones((1, 1, 5, 5))
D_r = host(pytv.D_upwind(on(ramp)))[0, 0, 0]
assert np.all(D_r[:-1] == 1.0) and np.all(D_r[-1] == 0.0)
print("\nramp forward row differences (zero last slot = one-sided boundary):")
print(D_r[:, 0])

# Central small-axis fallback: Nz == 2 silently uses the forward difference
# along z (the reference documents this; its CPU implementation crashes on it).
chans2, _ = scheme_channels("central", 2, 1)
assert chans2[-1].kind == "fwd"
print("central @ Nz=2: z channel kind =", chans2[-1].kind, "(fallback)")

# Adjointness by construction: <Y, D X> == <D^T Y, X> to fp precision.
rng = np.random.default_rng(0)
X = rng.random((4, 2, 8, 8))
for scheme in ("upwind", "downwind", "central", "hybrid"):
    D_X = host(getattr(pytv, f"D_{scheme}")(on(X), reg_time=0.5))
    Y = rng.random(D_X.shape)
    lhs = float(np.sum(D_X * Y))
    rhs = float(np.sum(
        host(getattr(pytv, f"D_T_{scheme}")(on(Y), reg_time=0.5)) * X))
    assert abs(lhs - rhs) < 1e-9
    print(f"adjointness {scheme:9s}: <Y, D X> = {lhs:.10f}, "
          f"<D^T Y, X> = {rhs:.10f}")
print("OK")
