"""4D time-resolved TV denoising, sharded over a (z, t) grid of shards: the
PyTorch/CUDA twin of ``examples/c_4d_sharded.py``.  The grid lives on the
one device (``parallel.make_mesh``); a mesh across processes and cards is
``parallel.multihost``.  Runs on the CUDA device (``--device cpu`` for the
CPU; no fallback):

    python examples/torch_c_4d_sharded.py [--device cpu]
"""

# Allow running from a repo checkout without installation.
import os as _os
import sys as _sys

_sys.path.insert(0, _os.path.dirname(_os.path.dirname(_os.path.abspath(__file__))))

import argparse

import numpy as np
import torch

from pytv4d_tpu_torch.core.config import TVConfig
from pytv4d_tpu_torch.parallel import (
    gather_volume,
    make_mesh,
    make_sharded_cp_solver,
    shard_d_volume,
    shard_volume,
)
from pytv4d_tpu_torch.solvers.cp import chambolle_pock, init_state

parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
parser.add_argument("--device", default="cuda",
                    help="torch device to run on (default: cuda)")
dev = torch.device(parser.parse_args().device)
if dev.type == "cuda" and not torch.cuda.is_available():
    raise RuntimeError("no CUDA device; pass --device cpu to run on the CPU")

z, t = 2, 2
mesh = make_mesh(z=z, t=t, device=dev)
print(f"mesh: {dict(mesh.shape)} shards on one {dev.type} device")

Nz, M, N = 4 * z, 4 * t, 128
cfg = TVConfig(scheme="hybrid", reg_time=0.5)
rng = np.random.default_rng(0)
noisy = torch.as_tensor(rng.random((Nz, M, N, N)), dtype=torch.float32,
                        device=dev)

# Option 1 — the unsharded plain solver on the whole volume: the reference
# the sharded solve must reproduce.
res = chambolle_pock(noisy, n_iter=50, reg=1.0, cfg=cfg, fused=False)
print(f"unsharded path: final loss {float(res.loss[-1]):.2f}")

# Option 2 — explicit halo exchange (parallel/halo.py): one plane per
# neighbour per stencil application, the loss summed over shards.
solve = make_sharded_cp_solver(mesh, cfg, noisy.shape, reg=1.0, n_iter=50)
st = init_state(noisy, cfg)
x, y_A, y_D, losses = solve(
    shard_volume(noisy, mesh),
    shard_volume(st.x, mesh),
    shard_volume(st.y_A, mesh),
    shard_d_volume(st.y_D, mesh),
)
rel = abs(float(losses[-1]) - float(res.loss[-1])) / float(res.loss[-1])
err = float((gather_volume(x) - res.x).abs().max())
print(f"halo path:      final loss {float(losses[-1]):.2f} (relative "
      f"difference {rel:.1e}; x within {err:.1e})")
assert rel < 1e-5 and err < 1e-4
print("OK")
