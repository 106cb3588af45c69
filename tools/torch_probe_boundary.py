"""Where a launch of the boundary kernels B8 spends its host time, on one GPU.

    python3 tools/torch_probe_boundary.py

Builds ``csrc/cp_boundary.cu`` and ``csrc/specialised_cp.cu`` (the
interior launches whose partials B8 fills) and prints what ptxas reports
for each B8 kernel.  Then, on one z-shard (8, 8, 256, 256) of the (32, 8, 256, 256) f32
hybrid ``reg_time=0.5`` volume, microseconds per call (200 calls with no
synchronisation between them, best of 5) of ``cp_dual_boundary`` and
``cp_primal_boundary`` and of the parts of the dual's wrapper: its checks
(``_check_boundary``, a call of a kind that passed), its launch parameters
(``_params``), the table id, the device guard (``torch.cuda.device``), the
stream query (``torch.cuda.current_stream(...).cuda_stream``, which builds a
stream object, beside the raw handle ``kernels.fused._stream_handle`` takes),
the pointers, and the ctypes call of the C entry point alone (the kernel
launch and ``cudaGetLastError``); and each kernel's own time on the device
(``torch.profiler`` over 50 launches).  Every host time is taken with the
calls queued behind a kernel that keeps the device busy, so that none waits
for it.  Last, whether a kernel's own time depends on the state it is
given: the kernels alone on the random state above and on a CP state (x0
in [0.5, 1.5), x near it, the duals after one pass A over the whole volume,
as ``chip_smoke.py`` phase 25 makes it), in turns (random, CP, random, CP),
with the card's SM clock beside each; and the wrappers' host time once
more, after ``torch.profiler`` has run in the process.  Imports the port only (no jax);
needs a CUDA device and nvcc.
"""

from __future__ import annotations

import ctypes
import os
import re
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pytv4d_tpu_torch.core.config import TVConfig  # noqa: E402
from pytv4d_tpu_torch.core.schemes import AXIS_Z, num_channels  # noqa: E402
from pytv4d_tpu_torch.kernels import build, fused, tables  # noqa: E402
from pytv4d_tpu_torch.utils.profiling import device_time  # noqa: E402

DEV = torch.device("cuda", 0)
SHAPE = (32, 8, 256, 256)


def host_us(fn, n=200, repeats=5):
    """Host microseconds per call of ``fn``, best of ``repeats`` runs of n
    calls with no synchronisation between them, queued behind a kernel that
    keeps the device busy for longer than they take (so that no call waits
    for the device)."""
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(repeats):
        torch.cuda._sleep(200_000_000)
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        best = min(best, time.perf_counter() - t0)
        torch.cuda.synchronize()
    return best / n * 1e6


def main():
    for name in ("cp_boundary", "specialised_cp"):
        path, seconds, log = build.build(name)
        if not log:
            with open(path + ".log") as f:
                log = f.read()
        if name == "cp_boundary":
            for kernel in ("bnd_dual_kernel", "bnd_primal_kernel"):
                regs, spills = [], []
                for entry in re.split(r"Compiling entry function '",
                                      log)[1:]:
                    if kernel not in entry.split("'")[0]:
                        continue
                    regs.append(int(re.search(r"Used (\d+) registers",
                                              entry).group(1)))
                    spills.append(int(re.search(
                        r"(\d+) bytes spill stores", entry).group(1)))
                print(f"[build] {kernel} x{len(regs)}: {min(regs)}-"
                      f"{max(regs)} registers, spill stores <= "
                      f"{max(spills)} B; nvcc {seconds:.1f} s", flush=True)

    cfg = TVConfig(scheme="hybrid", reg_time=0.5)
    Nz, M, Nr, Nc = SHAPE
    nz = Nz // 4
    Nd = num_channels(cfg.scheme, Nz, M, cfg.reg_z_over_reg, cfg.reg_time)
    rng = np.random.default_rng(0)

    def arr(*shape):
        return torch.as_tensor(rng.random(shape), dtype=torch.float32,
                               device=DEV)

    x, x0, y_A = arr(nz, M, Nr, Nc), arr(nz, M, Nr, Nc), arr(nz, M, Nr, Nc)
    y_D = arr(nz, M, Nd, Nr, Nc)
    x_halo, y_halo = arr(2, M, Nr, Nc), arr(2, M, Nd, Nr, Nc)
    td = (Nz, M)
    dk = dict(cfg=cfg, sigma_D=0.5, sigma_A=1.0, reg=1.0, table_dims=td)
    pk = dict(cfg=cfg, tau=0.1, table_dims=td)
    tv = fused.cp_dual(x, x0, y_A, y_D, interior=True, **dk)[2]
    fid = fused.cp_primal(x, x0, y_A, y_D, interior=True, **pk)[1]

    def dual():
        fused.cp_dual_boundary(x, x_halo, x0, y_A, y_D, tv, **dk)

    def primal():
        fused.cp_primal_boundary(x, x0, y_A, y_D, y_halo, fid, **pk)

    # the dual wrapper's parts, each alone
    p = fused._params(cfg, tuple(x.shape), False, sigma_D=0.5, sigma_A=1.0,
                      reg=1.0, fidelity="l2", fid_weight=1.0, table_dims=td,
                      sharded=True)
    lib = fused._lib("cp_boundary")
    tid = tables.boundary_table_id(cfg, *td)
    args = (x, x_halo, x0, y_A, y_D, None, tv)
    ptrs = [None if a is None else a.data_ptr() for a in args]
    stream = torch.cuda.current_stream(DEV).cuda_stream

    def guard():
        with torch.cuda.device(x.device):
            pass

    def c_call():
        lib.cp_dual_boundary_launch(ctypes.byref(p), tid, 0, 0, *ptrs, stream)

    parts = {
        "checks": lambda: fused._check_boundary(
            x, x_halo, x0, y_A, y_D, tv, None, cfg, td, "x_halo"),
        "_params": lambda: fused._params(
            cfg, tuple(x.shape), False, sigma_D=0.5, sigma_A=1.0, reg=1.0,
            fidelity="l2", fid_weight=1.0, table_dims=td, sharded=True),
        "table id": lambda: tables.boundary_table_id(cfg, *td),
        "device guard": guard,
        "stream object": lambda: torch.cuda.current_stream(
            x.device).cuda_stream,
        "stream handle": lambda: fused._stream_handle(x.device),
        "pointers": lambda: [None if a is None else a.data_ptr()
                             for a in args],
        "ctypes launch": c_call,
    }
    wrappers = {"B8 dual": dual, "B8 primal": primal}
    whole = {k: host_us(fn) for k, fn in wrappers.items()}
    split = {k: host_us(fn) for k, fn in parts.items()}
    on_dev = {k: device_time(lambda: [fn() for _ in range(50)], 50, DEV)[0]
              * 1e3 for k, fn in wrappers.items()}
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit "
                   "--format=csv,noheader").read().strip()
    turns = state_turns(cfg, x_halo, y_halo, dk, pk, (x, x0, y_A, y_D))
    # the wrappers' host time again, now that torch.profiler has run in
    # this process (chip_smoke.py's phase 25 measures late, after it)
    again = {k: host_us(fn) for k, fn in wrappers.items()}
    print(f"[host per launch] one z-shard {(nz, M, Nr, Nc)} f32, us per call "
          f"(200 calls queued behind a busy device, best of 5): "
          + ", ".join(f"{k} {v:.1f}" for k, v in whole.items())
          + "; the dual wrapper's parts: "
          + ", ".join(f"{k} {v:.2f}" for k, v in split.items())
          + "; on the device (torch.profiler): "
          + ", ".join(f"{k} {v:.1f}" for k, v in on_dev.items())
          + f"; card {smi}", flush=True)
    print("[state] B8 dual / primal alone on the device, us (torch.profiler, "
          "50 launches), by state in turns: "
          + ", ".join(f"{name} {d:.1f} / {p:.1f} (SM {clk} MHz)"
                      for name, d, p, clk in turns)
          + "; host per launch after torch.profiler has run: "
          + ", ".join(f"{k} {v:.1f} us" for k, v in again.items()),
          flush=True)


def state_turns(cfg, x_halo, y_halo, dk, pk, random_state):
    """The B8 kernels alone on ``random_state`` and on a CP state of the
    same shard, in turns: ``[(name, dual us, primal us, SM MHz)]``."""
    from pytv4d_tpu_torch.parallel import fused_halo, make_mesh, shard_volume

    gen = torch.Generator(device=DEV).manual_seed(99)
    x0 = torch.rand(SHAPE, generator=gen, device=DEV) + 0.5
    x = x0 + 0.1 * torch.rand(SHAPE, generator=gen, device=DEV)
    y_A = torch.zeros_like(x0)
    Nd = random_state[3].shape[2]
    y_D = torch.zeros((SHAPE[0], SHAPE[1], Nd) + SHAPE[2:], device=DEV)
    fused.cp_dual(x, x0, y_A, y_D, cfg=cfg, sigma_D=0.5, sigma_A=1.0,
                  reg=1.0)
    mesh = make_mesh(4, 1)
    xs, x0s, yAs, yDs = (shard_volume(t, mesh, False) for t in
                         (x, x0, y_A, y_D))
    chans = fused.scheme_channels(cfg.scheme, SHAPE[0], SHAPE[1],
                                  cfg.reg_z_over_reg, cfg.reg_time)[0]
    cp_state = (xs[1][0], x0s[1][0], yAs[1][0], yDs[1][0])
    cp_halo = (fused_halo._halo_planes(
        xs, 0, fused_halo._axis_ghost_kind(chans, AXIS_Z))[1][0],
        fused_halo._sparse_channel_halo(yDs, 0, chans, AXIS_Z)[1][0])

    def alone(state, halos):
        xx, xx0, ya, yd = state
        tv = fused.cp_dual(xx, xx0, ya, yd, interior=True, **dk)[2]
        fid = fused.cp_primal(xx, xx0, ya, yd, interior=True, **pk)[1]
        out = []
        for fn in (lambda: fused.cp_dual_boundary(xx, halos[0], xx0, ya, yd,
                                                  tv, **dk),
                   lambda: fused.cp_primal_boundary(xx, xx0, ya, yd,
                                                    halos[1], fid, **pk)):
            out.append(device_time(lambda: [fn() for _ in range(50)], 50,
                                   DEV)[0] * 1e3)
        # the SM clock while the card is busy (a sleeping kernel)
        torch.cuda._sleep(2_000_000_000)
        clk = os.popen("nvidia-smi --query-gpu=clocks.sm "
                       "--format=csv,noheader,nounits").read().strip()
        torch.cuda.synchronize()
        return (*out, clk)

    turns = []
    for name in ("random", "CP", "random", "CP"):
        state, halos = ((random_state, (x_halo, y_halo)) if name == "random"
                        else (cp_state, cp_halo))
        turns.append((name, *alone(state, halos)))
    return turns


if __name__ == "__main__":
    main()
