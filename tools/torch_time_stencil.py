"""Per-launch times of the stencil kernels B1-B4 on one GPU, for comparing two
trees of the repo in one run.

    python3 tools/torch_time_stencil.py [--root DIR]

Imports ``pytv4d_tpu_torch`` from ``DIR`` (default: this checkout), builds
``csrc/cp_fused.cu`` and ``csrc/tv_fused.cu`` there, and prints the time of
one launch of B1 (CP pass A), B2 (CP pass B), B3 (TV norms) and B4 (TV
subgradient) at (32, 8, 256, 256) float32, hybrid ``reg_time=0.5``: the mean
of 50 launches between two CUDA events, best of 5.  To compare a parent
commit with the working tree, unpack the parent with ``git archive`` into a
git-ignored directory and run parent, tree, tree, parent.

Where the tree has the sharded modes (``kernels.fused.cp_dual_boundary``), a
second line times them on one z-shard of that volume, (8, 8, 256, 256): B1
and B2 on the whole shard, with ``interior`` and in ``halo_mode``, B3 and B4
in ``halo_mode``, and the two boundary kernels B8 (which builds
``csrc/cp_boundary.cu``).
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import torch

SHAPE = (32, 8, 256, 256)


def launch_ms(fn, n=50, repeats=5):
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(repeats):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        torch.cuda.synchronize()
        best = min(best, a.elapsed_time(b) / n)
    return best


def main():
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    if "--root" in sys.argv:
        root = os.path.abspath(sys.argv[sys.argv.index("--root") + 1])
    sys.path.insert(0, root)  # the tree to time, ahead of any other copy
    from pytv4d_tpu_torch.core.config import TVConfig
    from pytv4d_tpu_torch.core.schemes import num_channels
    from pytv4d_tpu_torch.kernels import fused

    dev = torch.device("cuda", 0)
    cfg = TVConfig(scheme="hybrid", reg_time=0.5)
    Nz, M, Nr, Nc = SHAPE
    Nd = num_channels(cfg.scheme, Nz, M, cfg.reg_z_over_reg, cfg.reg_time)
    x0 = torch.as_tensor(np.random.default_rng(0).random(SHAPE),
                         dtype=torch.float32, device=dev)
    x, y_A = x0.clone(), torch.zeros_like(x0)
    y_D = torch.zeros((Nz, M, Nd, Nr, Nc), device=dev)
    dk = dict(cfg=cfg, sigma_D=0.5, sigma_A=1.0, reg=1.0)
    norms, _ = fused.tv_norms(x, cfg=cfg)
    ms = {
        "B1": launch_ms(lambda: fused.cp_dual(x, x0, y_A, y_D, **dk)),
        "B2": launch_ms(lambda: fused.cp_primal(x, x0, y_A, y_D, cfg=cfg,
                                                tau=0.1)),
        "B3": launch_ms(lambda: fused.tv_norms(x, cfg=cfg)),
        "B4": launch_ms(lambda: fused.tv_subgrad(x, norms, cfg=cfg)),
    }
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(f"[stencil times] {os.path.relpath(root)} {SHAPE} f32: "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in ms.items())
          + f"; card {smi.stdout.strip()}", flush=True)
    if not hasattr(fused, "cp_dual_boundary"):
        return

    # one z-shard of the volume, as the sharded solvers hand it over
    nz = Nz // 4
    shard = (nz, M, Nr, Nc)
    td = dict(table_dims=(Nz, M))
    xs, x0s, yAs = (t[nz:2 * nz].contiguous() for t in (x, x0, y_A))
    yDs = y_D[nz:2 * nz].contiguous()
    x1 = torch.zeros((nz + 2, M + 2, Nr, Nc), device=dev)
    x1[:, 1:-1] = x[nz - 1:2 * nz + 1]
    x2 = torch.zeros((nz + 4, M + 4, Nr, Nc), device=dev)
    x2[:, 2:-2] = x[nz - 2:2 * nz + 2]
    y1 = torch.zeros((nz + 2, M + 2, Nd, Nr, Nc), device=dev)
    n1 = torch.ones((nz + 2, M + 2, Nr, Nc), device=dev)
    x_halo = torch.stack([x[nz - 1], x[2 * nz]])
    y_halo = torch.zeros((2, M, Nd, Nr, Nc), device=dev)
    pk = dict(cfg=cfg, tau=0.1)
    tv = fused.cp_dual(xs, x0s, yAs, yDs, interior=True, **dk, **td)[2]
    fid = fused.cp_primal(xs, x0s, yAs, yDs, interior=True, **pk, **td)[1]
    halo = dict(halo_mode=True, **td)
    ms = {
        "B1": launch_ms(lambda: fused.cp_dual(xs, x0s, yAs, yDs, **dk)),
        "B1 interior": launch_ms(lambda: fused.cp_dual(
            xs, x0s, yAs, yDs, interior=True, **dk, **td)),
        "B1 halo": launch_ms(lambda: fused.cp_dual(x1, x0s, yAs, yDs, **dk,
                                                   **halo)),
        "B8 dual": launch_ms(lambda: fused.cp_dual_boundary(
            xs, x_halo, x0s, yAs, yDs, tv, **dk, **td)),
        "B2": launch_ms(lambda: fused.cp_primal(xs, x0s, yAs, yDs, **pk)),
        "B2 interior": launch_ms(lambda: fused.cp_primal(
            xs, x0s, yAs, yDs, interior=True, **pk, **td)),
        "B2 halo": launch_ms(lambda: fused.cp_primal(
            xs, x0s, yAs, yDs, y_ext=y1, **pk, **halo)),
        "B8 primal": launch_ms(lambda: fused.cp_primal_boundary(
            xs, x0s, yAs, yDs, y_halo, fid, **pk, **td)),
        "B3 halo": launch_ms(lambda: fused.tv_norms(x1, cfg=cfg, **halo)),
        "B4 halo": launch_ms(lambda: fused.tv_subgrad(x2, n1, cfg=cfg,
                                                      **halo)),
    }
    print(f"[stencil times, one z-shard] {os.path.relpath(root)} {shard} "
          f"f32: " + ", ".join(f"{k} {v:.4f} ms" for k, v in ms.items()),
          flush=True)


if __name__ == "__main__":
    main()
