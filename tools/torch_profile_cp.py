"""Where the time of the PyTorch/CUDA port's CP solver goes, on one GPU.

    python3 tools/torch_profile_cp.py [--out chiprun_out/profile_cp.json]

Cells: cameraman ``(1, 1, 256, 256)`` f32, hybrid, reg 25 (the README
recipe), and ``(32, 8, 256, 256)`` hybrid ``reg_time=0.5``, reg 1 in f32,
f32 with a bf16 dual, and bf16 primary and dual.  For each cell:

- ``it_s``: whole ``chambolle_pock`` calls of ``--iters`` iterations timed
  with CUDA events after a 5-iteration warm-up call, three times;
- ``device_ms_per_it`` and ``by_kernel``: one such call recorded by
  ``torch.profiler``; the device time of every CUDA kernel, copy and memset
  in it, per iteration;
- ``idle_share``: 1 - device ms per iteration / wall ms per iteration of the
  fastest unprofiled call;
- ``B1_ms`` / ``B2_ms``: each CP kernel alone, 50 launches between CUDA
  events, three times.

Prints the card, one line per cell, and writes all of it to ``--out`` as
JSON.  Imports the port only (no jax); needs a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pytv4d_tpu_torch.core.config import TVConfig  # noqa: E402
from pytv4d_tpu_torch.core.schemes import num_channels  # noqa: E402
from pytv4d_tpu_torch.kernels import fused  # noqa: E402
from pytv4d_tpu_torch.models import add_noise  # noqa: E402
from pytv4d_tpu_torch.solvers.cp import chambolle_pock, default_tau  # noqa: E402
from pytv4d_tpu_torch.utils import cameraman  # noqa: E402
from pytv4d_tpu_torch.utils.profiling import time_iterations  # noqa: E402

DEV = torch.device("cuda", 0)
MAIN_4D = (32, 8, 256, 256)


def _cells():
    noisy = add_noise(cameraman().reshape(1, 1, 256, 256), 100, seed=0)
    yield ("cameraman f32", torch.as_tensor(noisy, dtype=torch.float32),
           TVConfig(), 25.0, None)
    base = torch.as_tensor(np.random.default_rng(0).random(MAIN_4D),
                           dtype=torch.float32)
    cfg = TVConfig(scheme="hybrid", reg_time=0.5)
    yield "4D f32", base, cfg, 1.0, None
    yield "4D f32+bf16dual", base, cfg, 1.0, torch.bfloat16
    yield "4D bf16+bf16dual", base.to(torch.bfloat16), cfg, 1.0, torch.bfloat16


def _device_time(noisy, cfg, reg, dual, n_iter):
    """Device ms per iteration of one solver call, by kernel name."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        chambolle_pock(noisy, n_iter=n_iter, reg=reg, cfg=cfg, dual_dtype=dual,
                       return_dual=False)
        torch.cuda.synchronize(DEV)
    by_kernel = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms, count = by_kernel.get(e.name, (0.0, 0))
            by_kernel[e.name] = (ms + e.time_range.elapsed_us() / 1e3, count + 1)
    if not by_kernel:
        raise RuntimeError("torch.profiler recorded no device activity")
    by_kernel = {k[:70]: [ms / n_iter, count / n_iter]
                 for k, (ms, count) in sorted(by_kernel.items(),
                                              key=lambda kv: -kv[1][0])}
    return sum(v[0] for v in by_kernel.values()), by_kernel


def _launch_ms(noisy, cfg, reg, dual, n=50):
    """ms per launch of B1 and B2 on the cell's fresh state."""
    shape = tuple(noisy.shape)
    Nd = num_channels(cfg.scheme, shape[0], shape[1], cfg.reg_z_over_reg,
                      cfg.reg_time)
    x0, x = noisy, noisy.clone()
    y_A = torch.zeros_like(noisy)
    y_D = torch.zeros((shape[0], shape[1], Nd) + shape[2:],
                      dtype=dual or noisy.dtype, device=DEV)
    dual_kw = dict(cfg=cfg, sigma_D=0.5, sigma_A=1.0, reg=reg)
    prim_kw = dict(cfg=cfg, tau=default_tau(cfg, shape[0], shape[1]))
    out = {}
    for name, call in (
            ("B1_ms", lambda: fused.cp_dual(x, x0, y_A, y_D, **dual_kw)),
            ("B2_ms", lambda: fused.cp_primal(x, x0, y_A, y_D, **prim_kw))):
        call()
        torch.cuda.synchronize(DEV)
        out[name] = []
        for _ in range(3):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(n):
                call()
            end.record()
            torch.cuda.synchronize(DEV)
            out[name].append(start.elapsed_time(end) / n)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default="chiprun_out/profile_cp.json")
    ap.add_argument("--iters", type=int, default=100)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("torch_profile_cp: needs a CUDA device")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(card, flush=True)
    result = {"card": card, "torch": torch.__version__, "iters": args.iters,
              "cells": {}}
    for name, noisy, cfg, reg, dual in _cells():
        noisy = noisy.to(DEV)

        def solve(n):
            chambolle_pock(noisy, n_iter=n, reg=reg, cfg=cfg, dual_dtype=dual,
                           return_dual=False)

        it_s = [time_iterations(solve, args.iters, DEV, repeats=1)
                for _ in range(3)]
        device_ms, by_kernel = _device_time(noisy, cfg, reg, dual, args.iters)
        wall_ms = 1e3 / max(it_s)
        cell = {"it_s": it_s, "wall_ms_per_it": wall_ms,
                "device_ms_per_it": device_ms,
                "idle_share": 1.0 - device_ms / wall_ms,
                "by_kernel": by_kernel, **_launch_ms(noisy, cfg, reg, dual)}
        result["cells"][name] = cell
        print(f"{name}: {max(it_s):.1f} it/s, wall {wall_ms:.4f} ms/it, device "
              f"{device_ms:.4f} ms/it, idle {100 * cell['idle_share']:.1f}%, "
              f"B1 {min(cell['B1_ms']):.4f} ms, B2 {min(cell['B2_ms']):.4f} ms",
              flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(f"wrote {args.out}", flush=True)


if __name__ == "__main__":
    main()
