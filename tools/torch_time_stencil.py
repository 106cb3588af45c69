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


if __name__ == "__main__":
    main()
