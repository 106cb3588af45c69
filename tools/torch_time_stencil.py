"""Per-launch times of the stencil kernels B1-B5 and the 4D CP and GD
iteration on one GPU, for comparing two trees of the repo in one run.

    python3 tools/torch_time_stencil.py [--root DIR] [--only SECTIONS]
    python3 tools/torch_time_stencil.py --ab PARENT_DIR [--only SECTIONS]

``--only`` runs the named lines alone, a comma-separated subset of
``stencil,b2,gd,tgv,shard,b5,resident`` (all by default; ``--ab`` passes it
on).

Imports ``pytv4d_tpu_torch`` from ``DIR`` (default: this checkout), which
builds its kernels there on first use, and prints one line of times at
(32, 8, 256, 256), hybrid ``reg_time=0.5`` unless named: B1 (CP pass A) in
float32, with a bf16 dual and in bf16, and for the upwind and central
schemes; B2 (CP pass B); B3 (TV norms) and B4 (TV subgradient) in float32,
in bf16, with the aniso and huber norms and for upwind and central; B5
(pass A for inverse problems) in float32, with a bf16 dual, in bf16 and
for upwind and central, also at the CT path's (16, 4, 512, 512) ("B5 CT");
each the
mean of 50 launches between two CUDA events, best of 5; B1's and B5's
launches also print a hash of their outputs after one launch.  Then ms per iteration of ``chambolle_pock`` and
``subgradient_descent`` at that volume: (a 60-iteration solve - a
20-iteration one) / 40, best of 3.  ``--ab PARENT_DIR`` runs the script
on PARENT_DIR, this checkout, this checkout and PARENT_DIR again, one
process each, so that both trees are timed in turns on one card: unpack
the parent commit with ``git archive`` into a git-ignored directory first.

The ``b2`` line times B2 (CP pass B) on that unsharded volume in float32,
with a bf16 dual and in bf16, in place from a seeded state: CUDA events
and the device's ms per launch (``torch.profiler`` over 50 launches, each
recorded), beside the bound (each array once: x, x0, y_A and the dual read,
x' written, over the HBM rate) and its share of it; and the hash of x'
after one launch from that state in each storage pair for each variant of
the call the wrapper takes (in place; out of place with x itself as x0, as
the inverse solver calls it; ``nonneg`` with the l1 fidelity; kl; a time
multiplier plane), and in float32 for the four schemes at (4, 3, 64, 96)
and at the odd width (2, 2, 24, 71), and a 2D (1, 1, 256, 256) volume, so
that two trees' x' can be compared bit for bit; with the fidelity partials'
sum after the in-place launch (the partials' blocks may differ between
trees: equal to round-off, not bit for bit).

The ``gd`` line times pass 2 (B4) at (32, 8, 256, 256) and at the
denoising cells' (96, 16, 512, 512), hybrid ``reg_time=0.5``, float32,
from a seeded x0 and an x near it: the standalone instance, which stores G
(``tv_subgrad``), and, where the tree has it, the instance that takes the
subgradient-descent step in its epilogue (``tv_gd_step``: x' and the
fidelity partials, reg 25, step 5e-3), each by CUDA events and on the
device (``torch.profiler``, every launch recorded); ms per iteration of
``subgradient_descent`` at both shapes; the registers ``ptxas`` gave each
pass 2 instance of that table (the library's build log); and the hash of
the standalone G in float32 for the four schemes, in bf16, for the aniso
and huber norms, with a time multiplier plane, at the odd width (2, 2,
24, 71) and one element off alignment, so that two trees' G can be
compared bit for bit.

A second line times the TGV kernels: B6's two passes per launch in the 4d
and 2d modes in float32 and the 4d mode in bf16, and B7 as
``tgv_resident_solve`` dispatches it (a 300-iteration cameraman-sized
solve, best of 3, and ms per iteration at (32, 8, 256, 256) with the loss,
between a 20- and a 60-iteration solve); where the tree has the on-chip
kernel it is that one, and the L2 kernel is timed beside it.  Each B6 pass
and each B7 solve also prints a hash of its outputs, so that two trees'
results can be compared bit for bit.

Where the tree has the sharded modes (``kernels.fused.cp_dual_boundary``), a
third line times them on one z-shard of that volume, (8, 8, 256, 256): B1
and B2 on the whole shard, with ``interior`` and in ``halo_mode``, B3 and B4
in ``halo_mode``, and the two boundary kernels B8; for B8 also the host's
microseconds per launch (200 calls queued behind a busy device),
the kernel's own time on the device (``torch.profiler`` over 50 launches)
and the hashes of its outputs (y_A and y_D after B1 ``interior`` + B8 dual,
x after B2 ``interior`` + B8 primal, from seeded states), and ms per
iteration of the 4-z-shard solve of the whole volume on the overlapped and
on the ghost-plane step beside the unsharded one: wall (marginal, as for
CP above) and device (``torch.profiler`` over a 20-iteration solve).  B3
and B4 in ``halo_mode`` are also timed in bf16 and on a shard of a (2 x 2)
grid, (16, 4, 256, 256), in float32 and bf16, on operands the sharded TV
builds (``parallel.fused_halo``: the neighbours' and ghost planes), with a
hash of the norms and of G after one launch each, and their host
microseconds per launch as B8's.  A line of its own times B1 and B2 on
that z-shard in both sharded modes, f32 and bf16 (primary and dual), from
seeded states (x and the dual extended by one plane a side for
``halo_mode``): CUDA events and the device's ms (``torch.profiler``) per
launch, and the hashes of y_A' and y_D' after one B1 launch and of x'
after one B2 launch, so that two trees' outputs can be compared bit for
bit.  Another line then splits
the device time (``torch.profiler``) of the grid calls that run B3 and B4
in their halo mode -- ``tv_and_subgrad`` on 4 z-shards and on a (2 x 2)
grid (10 calls) and a 20-iteration ``subgradient_descent`` on 4 z-shards
-- into B3, B4, the copies that build the extended operands (kernels
named ``Cat``, ``copy``, ``Memcpy`` or ``where``) and the rest, per call
or iteration, and appends each kernel's time to
``chiprun_out/tv_grid_split.jsonl``.

The ``b5`` lines time B5 in ``halo_mode`` on a z-shard of that volume,
(8, 8, 256, 256), and on one of 4 z-shards and of a (2 x 2) grid of the CT
cell (16, 4, 512, 512) -- (4, 4, 512, 512) and (8, 2, 512, 512) -- in
float32, with a bf16 dual and in bf16, from seeded states: CUDA events and
the device's ms per launch beside the bound (the bytes of the planes its
table reads) and its share of it, and a hash of y_D' after one launch, so
that two trees' outputs can be compared bit for bit; then the device ms per
iteration of a 10-iteration fused ``cp_reconstruct`` of the CT cell's
sinogram (96 angles) as 4 z-shards, split into B5, B2, B3 and the rest,
beside its wall ms per iteration.

A fourth line times the whole-solve kernels B9 as the factories launch
them (``make_resident_cp_solver`` / ``make_resident_gd_solver``: a
300-iteration solve, best of 5) at cameraman size (1, 1, 256, 256), at
the coupled (4, 2, 64, 64) and at (8, 4, 128, 128), hybrid ``reg_time=0.5``
(the last's CP too large for the on-chip kernel), reg 25, from a seeded
volume, with a hash of the final state (x, y_A, y_D; GD's x) and the last
loss; and the z-marching pass A B10 per launch at (32, 8, 256, 256) hybrid
``reg_time=0.5`` in float32, with a bf16 dual and in bf16, with a hash of
y_A' and y_D' after one launch from seeded states and the hash of B1's on
the same inputs (equal where the two are bit for bit).
"""

from __future__ import annotations

import concurrent.futures
import hashlib
import os
import re
import subprocess
import sys
import time

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


def iteration_ms(solve, repeats=3):
    """Marginal ms per iteration of ``solve(n_iter)``: set-up cancels."""
    def best(n):
        solve(n)
        torch.cuda.synchronize()
        out = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            solve(n)
            torch.cuda.synchronize()
            out = min(out, time.perf_counter() - t0)
        return out
    return (best(60) - best(20)) / 40 * 1e3


def host_us(fn, n=200):
    """Host microseconds per call of ``fn``: n calls with no synchronisation
    between them, queued behind a kernel that keeps the device busy for
    longer than they take, so that none waits for the device."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


def digest(*tensors):
    """The first 12 hex digits of a SHA-256 over the tensors' bytes."""
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.detach().contiguous().view(torch.uint8).cpu().numpy()
                 .tobytes())
    return h.hexdigest()[:12]


def tgv_times(dev):
    """ms per launch of B6's passes and of B7's solves, with the hashes of
    their outputs (module docstring)."""
    from pytv4d_tpu_torch.kernels import tgv_resident, tgv_stream

    ms, hashes = {}, {}
    rng = np.random.default_rng(3)
    for mode, dtype, tag in (("4d", torch.float32, "4d"),
                             ("2d", torch.float32, "2d"),
                             ("4d", torch.bfloat16, "4d bf16")):
        n = {"2d": 2, "4d": 4}[mode]
        Nz, M, Nr, Nc = SHAPE

        def arr(*s):
            return torch.as_tensor(rng.standard_normal(s), dtype=dtype,
                                   device=dev)

        x, x0 = arr(*SHAPE), arr(*SHAPE)
        w, p = arr(Nz, n, M, Nr, Nc), arr(Nz, n, M, Nr, Nc)
        q = arr(Nz, n * (n + 1) // 2, M, Nr, Nc)
        xb, wb = x.clone(), w.clone()
        kw = dict(mode=mode, alpha1=1.0, alpha0=2.0)
        tgv_stream.tgv_pq(xb, wb, p, q, **kw)
        tgv_stream.tgv_xw(x, x0, p, w, q, xb, wb, mode=mode)
        hashes[f"B6 {tag}"] = digest(x, xb, w, wb, p, q)
        ms[f"B6 PQ {tag}"] = launch_ms(lambda: tgv_stream.tgv_pq(
            xb, wb, p, q, **kw))
        ms[f"B6 XW {tag}"] = launch_ms(lambda: tgv_stream.tgv_xw(
            x, x0, p, w, q, xb, wb, mode=mode))
        del x, x0, w, p, q, xb, wb
    cam = torch.as_tensor(rng.random((1, 1, 256, 256)), dtype=torch.float32,
                          device=dev)
    vol = torch.as_tensor(rng.random(SHAPE), dtype=torch.float32, device=dev)
    solvers = {"B7": tgv_resident.tgv_resident_solve}
    if hasattr(tgv_resident, "solve_l2"):
        def l2(x, n, alpha1, alpha0):
            prm = tgv_stream.tgv_params(tuple(x.shape), "2d", alpha1, alpha0,
                                        1.0, "iso", 1.0)
            return tgv_resident.solve_l2(x, n, prm, True)

        solvers["B7 L2"] = l2
    for name, solve in solvers.items():
        hashes[f"{name} cam"] = digest(*solve(cam, 20, 25.0, 50.0)[:6])
        hashes[f"{name} 4D"] = digest(*solve(vol, 20, 1.0, 2.0)[:6])
        ms[f"{name} cam 300 its"] = launch_ms(
            lambda: solve(cam, 300, 25.0, 50.0), n=1, repeats=3)
        ms[f"{name} 4D per it"] = (
            launch_ms(lambda: solve(vol, 60, 1.0, 2.0), n=1, repeats=3)
            - launch_ms(lambda: solve(vol, 20, 1.0, 2.0), n=1,
                        repeats=3)) / 40
    return ms, hashes


def resident_times(dev):
    """ms of B9's solves and B10's launches, with the hashes of their
    outputs and B9's last losses (module docstring)."""
    from pytv4d_tpu_torch.core.config import TVConfig
    from pytv4d_tpu_torch.core.schemes import num_channels
    from pytv4d_tpu_torch.kernels import fused, resident, zstream
    from pytv4d_tpu_torch.solvers.cp import default_tau

    ms, hashes, losses = {}, {}, {}
    rng = np.random.default_rng(5)
    for tag, shape, cfg in (
            ("cam", (1, 1, 256, 256), TVConfig()),
            ("coupled", (4, 2, 64, 64),
             TVConfig(scheme="hybrid", reg_time=0.5)),
            ("(8,4,128,128)", (8, 4, 128, 128),
             TVConfig(scheme="hybrid", reg_time=0.5))):
        Nz, M, Nr, Nc = shape
        Nd = num_channels(cfg.scheme, Nz, M, cfg.reg_z_over_reg,
                          cfg.reg_time)
        x0 = torch.as_tensor(100.0 * rng.random(shape), dtype=torch.float32,
                             device=dev)
        z = torch.zeros_like(x0)
        y_D = torch.zeros((Nz, Nd, M, Nr, Nc), device=dev)
        cp = resident.make_resident_cp_solver(
            cfg, shape, 300, "float32", reg=25.0, sigma_D=0.5, sigma_A=1.0,
            tau=default_tau(cfg, Nz, M))
        gd = resident.make_resident_gd_solver(cfg, shape, 300, "float32",
                                              reg=25.0, step_size=5e-3)
        out = cp(x0, x0, z, y_D)
        hashes[f"B9 CP {tag}"] = digest(*out[:3])
        losses[f"B9 CP {tag}"] = float(out[3][-1])
        gx, gl = gd(x0, x0)
        hashes[f"B9 GD {tag}"] = digest(gx)
        losses[f"B9 GD {tag}"] = float(gl[-1])
        ms[f"B9 CP {tag} 300 its"] = launch_ms(lambda: cp(x0, x0, z, y_D),
                                               n=1)
        ms[f"B9 GD {tag} 300 its"] = launch_ms(lambda: gd(x0, x0), n=1)
    cfg = TVConfig(scheme="hybrid", reg_time=0.5)
    Nz, M, Nr, Nc = SHAPE
    Nd = num_channels(cfg.scheme, Nz, M, cfg.reg_z_over_reg, cfg.reg_time)
    dk = dict(cfg=cfg, sigma_D=0.5, sigma_A=1.0, reg=1.0)
    bf16 = torch.bfloat16
    for tag, (x_dt, d_dt) in (("f32", (torch.float32, torch.float32)),
                              ("bf16 dual", (torch.float32, bf16)),
                              ("bf16", (bf16, bf16))):
        def arr(*s, dtype):
            return torch.as_tensor(rng.random(s, dtype=np.float32),
                                   device=dev).to(dtype)

        x, x0, y_A = (arr(*SHAPE, dtype=x_dt) for _ in range(3))
        y_D = arr(Nz, M, Nd, Nr, Nc, dtype=d_dt)
        for name, dual in (("B10", zstream.cp_dual_zstream),
                           ("B1 on B10's inputs", fused.cp_dual)):
            got = [y_A.clone(), y_D.clone()]
            dual(x, x0, *got, **dk)
            hashes[f"{name} {tag}"] = digest(*got)
        ms[f"B10 {tag}"] = launch_ms(lambda: zstream.cp_dual_zstream(
            x, x0, y_A, y_D, **dk))
        del x, x0, y_A, y_D
    return ms, hashes, losses


GD_SHAPES = (SHAPE, (96, 16, 512, 512))


def gd_step_times(cfg, dev):
    """Pass 2, standalone and with the GD epilogue (module docstring):
    ``(ms, device ms, ms per GD iteration, registers, G hashes)``."""
    from pytv4d_tpu_torch.core.config import TVConfig
    from pytv4d_tpu_torch.core.schemes import SCHEMES
    from pytv4d_tpu_torch.kernels import build, fused, tables
    from pytv4d_tpu_torch.kernels.dispatch import t_plane_multiplier
    from pytv4d_tpu_torch.solvers.gd import subgradient_descent

    def seeded(shape, seed=26):
        gen = torch.Generator(device=dev).manual_seed(seed)
        x0 = 255 * torch.rand(shape, generator=gen, device=dev)
        return x0 + 20 * torch.rand(shape, generator=gen, device=dev), x0

    ms, on_dev, its = {}, {}, {}
    gd_kw = dict(cfg=cfg, reg=25.0, step_size=5e-3)
    for shape in GD_SHAPES:
        x, x0 = seeded(shape)
        norms, _ = fused.tv_norms(x, cfg=cfg)
        runs = {"B4": lambda: fused.tv_subgrad(x, norms, cfg=cfg)}
        if hasattr(fused, "tv_gd_step"):
            runs["B4 GD"] = lambda: fused.tv_gd_step(x, x0, norms, **gd_kw)
        for name, run in runs.items():
            ms[f"{name} {shape}"] = launch_ms(run)
            on_dev[f"{name} {shape}"] = traced_ms(run,
                                                  "tv_subgrad_spec_kernel")
        del x, norms, runs
        its[f"GD {shape}"] = iteration_ms(lambda n: subgradient_descent(
            x0, n_iter=n, **gd_kw))
        del x0
        torch.cuda.empty_cache()

    # ptxas's registers of each pass 2 instance of cfg's table
    path = build._library_path(os.path.join(build.CSRC, "specialised.cu"))
    with open(path + ".log") as f:
        log = f.read()
    chans = tables.TABLES[tables.table_id(cfg, *SHAPE[:2])]
    code = len(chans)  # csrc/tables.cuh's code of the table
    for i, (axis, kind) in enumerate(chans):
        code |= (axis | fused._KIND[kind] << 2) << (4 + 4 * i)
    regs = {}
    for entry in log.split("Compiling entry function '")[1:]:
        name = entry.split("'")[0]
        m = re.search(r"tv_subgrad_spec_kernelILy(\d+)E(f|13__nv_bfloat16)"
                      r"((?:Lb[01]E)+)", name)
        if m and int(m[1]) == code:
            tag = (f"{m[1]} {'f32' if m[2] == 'f' else 'bf16'} "
                   f"{m[3].replace('Lb', '').replace('E', '')}")
            regs[tag] = int(re.search(r"Used (\d+) registers", entry)[1])

    hashes = {}
    cases = [*((s, TVConfig(scheme=s, reg_time=0.5), torch.float32)
               for s in SCHEMES),
             ("bf16", cfg, torch.bfloat16),
             ("aniso", TVConfig(scheme="central", reg_time=0.5,
                                norm="aniso"), torch.float32),
             ("huber", TVConfig(scheme="hybrid", reg_time=0.5, norm="huber",
                                huber_delta=0.3), torch.float32)]
    for shape in ((4, 3, 64, 96), (2, 2, 24, 71)):
        for name, c, dt in cases:
            x = seeded(shape, 7)[0].to(dt)
            norms, _ = fused.tv_norms(x, cfg=c)
            hashes[f"{name} {shape}"] = digest(fused.tv_subgrad(x, norms,
                                                                cfg=c))
    x = seeded((4, 3, 64, 96), 7)[0]
    gen = torch.Generator(device=dev).manual_seed(9)
    mask = torch.rand((1, 1, 64, 96), generator=gen, device=dev) < 0.5
    tm = t_plane_multiplier(tuple(x.shape), cfg, mask, 1.0 + mask.float(),
                            device=dev).float().contiguous()
    norms, _ = fused.tv_norms(x, tm, cfg=cfg)
    hashes["tmul"] = digest(fused.tv_subgrad(x, norms, tm, cfg=cfg))
    off = torch.empty(x.numel() + 1, device=dev)[1:].view(x.shape).copy_(x)
    norms, _ = fused.tv_norms(off, cfg=cfg)
    hashes["off alignment"] = digest(fused.tv_subgrad(off, norms, cfg=cfg))
    return ms, on_dev, its, regs, hashes


def card():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    return smi.stdout.strip()


def main():
    here = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    only = {"stencil", "b2", "gd", "tgv", "shard", "b5", "resident"}
    if "--only" in sys.argv:
        only = set(sys.argv[sys.argv.index("--only") + 1].split(","))
    if "--ab" in sys.argv:
        parent = sys.argv[sys.argv.index("--ab") + 1]
        for root in (parent, here, here, parent):
            subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--root", root, "--only", ",".join(sorted(only))],
                           check=True)
        return
    root = here
    if "--root" in sys.argv:
        root = os.path.abspath(sys.argv[sys.argv.index("--root") + 1])
    sys.path.insert(0, root)  # the tree to time, ahead of any other copy
    import pytv4d_tpu_torch.kernels  # noqa: F401  (every library registers)
    from pytv4d_tpu_torch.core.config import TVConfig
    from pytv4d_tpu_torch.core.schemes import num_channels
    from pytv4d_tpu_torch.kernels import fused
    from pytv4d_tpu_torch.solvers.cp import chambolle_pock
    from pytv4d_tpu_torch.solvers.gd import subgradient_descent

    from pytv4d_tpu_torch.kernels import build

    # the tree's libraries, one nvcc each, all at once
    with concurrent.futures.ThreadPoolExecutor(len(fused._ENTRY_POINTS)) as p:
        list(p.map(build.build, fused._ENTRY_POINTS))
    dev = torch.device("cuda", 0)
    cfg = TVConfig(scheme="hybrid", reg_time=0.5)
    Nz, M, Nr, Nc = SHAPE
    x0 = torch.as_tensor(np.random.default_rng(0).random(SHAPE),
                         dtype=torch.float32, device=dev)
    x, y_A = x0.clone(), torch.zeros_like(x0)

    def dual(c, dtype=torch.float32):
        Nd = num_channels(c.scheme, Nz, M, c.reg_z_over_reg, c.reg_time)
        return torch.zeros((Nz, M, Nd, Nr, Nc), dtype=dtype, device=dev)

    hashes = {}

    def b1(key, c, x_dt=torch.float32, d_dt=torch.float32):
        a = [t.to(x_dt) for t in (x, x0, y_A)] + [dual(c, d_dt)]

        def fn():
            fused.cp_dual(*a, cfg=c, sigma_D=0.5, sigma_A=1.0, reg=1.0)
        fn()
        hashes[key] = digest(a[2], a[3])
        return launch_ms(fn)

    def b3(c, x_dt=torch.float32):
        xb = x.to(x_dt)
        return launch_ms(lambda: fused.tv_norms(xb, cfg=c))

    def b4(c, x_dt=torch.float32):
        xb = x.to(x_dt)
        norms, _ = fused.tv_norms(xb, cfg=c)
        return launch_ms(lambda: fused.tv_subgrad(xb, norms, cfg=c))

    ct_shape = (16, 4, 512, 512)
    x_ct = torch.as_tensor(np.random.default_rng(1).random(ct_shape),
                           dtype=torch.float32, device=dev)

    def b5(key, c, x_dt=torch.float32, d_dt=torch.float32, xs=x):
        Nd = num_channels(c.scheme, *xs.shape[:2], c.reg_z_over_reg,
                          c.reg_time)
        xb = xs.to(x_dt)
        y = torch.zeros((*xs.shape[:2], Nd, *xs.shape[2:]), dtype=d_dt,
                        device=dev)

        def fn():
            fused.tv_dual(xb, y, cfg=c, sigma_D=0.5, reg=1.0)
        fn()
        hashes[key] = digest(y)
        return launch_ms(fn)

    y_D = dual(cfg)
    up, ctr = (TVConfig(scheme=s, reg_time=0.5) for s in ("upwind",
                                                          "central"))
    aniso = TVConfig(scheme="hybrid", reg_time=0.5, norm="aniso")
    huber = TVConfig(scheme="hybrid", reg_time=0.5, norm="huber",
                     huber_delta=0.3)
    bf16 = torch.bfloat16
    if "stencil" in only:
        ms = {
            "B1": b1("B1", cfg),
            "B1 bf16 dual": b1("B1 bf16 dual", cfg, d_dt=torch.bfloat16),
            "B1 bf16": b1("B1 bf16", cfg, torch.bfloat16, torch.bfloat16),
            "B1 upwind": b1("B1 upwind", up),
            "B1 central": b1("B1 central", ctr),
            "B2": launch_ms(lambda: fused.cp_primal(x, x0, y_A, y_D, cfg=cfg,
                                                    tau=0.1)),
            "B3": b3(cfg),
            "B3 bf16": b3(cfg, bf16),
            "B3 aniso": b3(aniso),
            "B3 huber": b3(huber),
            "B3 upwind": b3(up),
            "B3 central": b3(ctr),
            "B4": b4(cfg),
            "B4 bf16": b4(cfg, bf16),
            "B4 aniso": b4(aniso),
            "B4 huber": b4(huber),
            "B4 upwind": b4(up),
            "B4 central": b4(ctr),
            "B5": b5("B5", cfg),
            "B5 bf16 dual": b5("B5 bf16 dual", cfg, d_dt=bf16),
            "B5 bf16": b5("B5 bf16", cfg, bf16, bf16),
            "B5 upwind": b5("B5 upwind", up),
            "B5 central": b5("B5 central", ctr),
            "B5 CT": b5("B5 CT", cfg, xs=x_ct),
            "B5 CT bf16 dual": b5("B5 CT bf16 dual", cfg, d_dt=bf16, xs=x_ct),
            "B5 CT bf16": b5("B5 CT bf16", cfg, bf16, bf16, xs=x_ct),
            "B5 CT upwind": b5("B5 CT upwind", up, xs=x_ct),
            "B5 CT central": b5("B5 CT central", ctr, xs=x_ct),
        }
        its = {
            "CP": iteration_ms(lambda n: chambolle_pock(
                x0, n_iter=n, reg=1.0, cfg=cfg, return_dual=False)),
            "GD": iteration_ms(lambda n: subgradient_descent(
                x0, n_iter=n, reg=1.0, step_size=5e-3, cfg=cfg)),
        }
        print(f"[stencil times] {os.path.relpath(root)} {SHAPE} f32 hybrid "
              f"reg_time=0.5 unless named, ms per launch: "
              + ", ".join(f"{k} {v:.4f}" for k, v in ms.items())
              + "; ms per iteration: "
              + ", ".join(f"{k} {v:.4f}" for k, v in its.items())
              + "; output hashes: "
              + ", ".join(f"{k} {v}" for k, v in hashes.items())
              + f"; card {card()}", flush=True)
    del x_ct
    if "b2" in only:
        b2_ms, b2_dev, b2_bound, b2_hash, b2_fid = b2_times(cfg, dev)
        print(f"[B2 unsharded] {os.path.relpath(root)} {SHAPE} hybrid "
              f"reg_time=0.5, per launch, CUDA events / device "
              f"(torch.profiler, 50 of 50 launches), bound (device share): "
              + ", ".join(f"{k} {b2_ms[k]:.4f} / {b2_dev[k]:.4f} ms, bound "
                          f"{b2_bound[k]:.4f} ({b2_bound[k] / b2_dev[k]:.1%})"
                          for k in b2_ms)
              + "; x' hashes after one launch from seeded states: "
              + ", ".join(f"{k} {v}" for k, v in b2_hash.items())
              + "; fidelity partial sums: "
              + ", ".join(f"{k} {v!r}" for k, v in b2_fid.items())
              + f"; card {card()}", flush=True)
    if "gd" in only:
        gd_ms, gd_dev, gd_its, gd_regs, gd_hash = gd_step_times(cfg, dev)
        print(f"[B4 GD step] {os.path.relpath(root)} hybrid reg_time=0.5 "
              f"f32, per launch, CUDA events / device (torch.profiler, 50 "
              f"of 50 launches): "
              + ", ".join(f"{k} {gd_ms[k]:.4f} / {gd_dev[k]:.4f} ms"
                          for k in gd_ms)
              + "; ms per GD iteration: "
              + ", ".join(f"{k} {v:.4f}" for k, v in gd_its.items())
              + "; registers (table, storage, template flags): "
              + ", ".join(f"{k} {v}" for k, v in gd_regs.items())
              + "; standalone G hashes: "
              + ", ".join(f"{k} {v}" for k, v in gd_hash.items())
              + f"; card {card()}", flush=True)
    if "tgv" in only:
        tgv_ms, tgv_hash = tgv_times(dev)
        print(f"[tgv times] {os.path.relpath(root)} {SHAPE} f32 unless "
              f"named, ms: "
              + ", ".join(f"{k} {v:.4f}" for k, v in tgv_ms.items())
              + "; output hashes: "
              + ", ".join(f"{k} {v}" for k, v in tgv_hash.items())
              + f"; card {card()}", flush=True)
    if "resident" in only:
        res_ms, res_hash, res_loss = resident_times(dev)
        print(f"[resident and zstream times] {os.path.relpath(root)}, ms: "
              + ", ".join(f"{k} {v:.4f}" for k, v in res_ms.items())
              + "; last losses: "
              + ", ".join(f"{k} {v!r}" for k, v in res_loss.items())
              + "; output hashes: "
              + ", ".join(f"{k} {v}" for k, v in res_hash.items())
              + f"; card {card()}", flush=True)
    if "b5" in only:
        b5_ms, b5_dev, b5_hash, b5_bound = b5_halo_times(cfg, dev)
        print(f"[B5 halo] {os.path.relpath(root)} hybrid reg_time=0.5, one "
              f"shard + its planes, per launch, CUDA events / device "
              f"(torch.profiler), bound (device share): "
              + ", ".join(f"{k} {b5_ms[k]:.4f} / {b5_dev[k]:.4f} ms, "
                          f"bound {b5_bound[k]:.4f} "
                          f"({b5_bound[k] / b5_dev[k]:.1%})"
                          for k in b5_ms)
              + "; y_D' hashes after one launch from seeded states: "
              + ", ".join(f"{k} {v}" for k, v in b5_hash.items())
              + f"; card {card()}", flush=True)
        total, split, wall = ct_grid_split(cfg, dev)
        print(f"[CT grid split] {os.path.relpath(root)} {CT_SHAPE} x "
              f"{CT_ANGLES} angles as 4 z-shards, fused cp_reconstruct, ms "
              f"per iteration: device {total:.4f} = "
              + ", ".join(f"{k} {v:.4f}" for k, v in split.items())
              + f"; wall {wall:.4f}; card {card()}", flush=True)
    if "shard" not in only or not hasattr(fused, "cp_dual_boundary"):
        return

    # one z-shard of the volume, as the sharded solvers hand it over
    Nd = y_D.shape[2]
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
    dk = dict(cfg=cfg, sigma_D=0.5, sigma_A=1.0, reg=1.0)
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
    tv_hash = {}
    for tag, mesh_zt, x_dt in (("", (4, 1), torch.bfloat16),
                               (" 2x2", (2, 2), torch.float32),
                               (" 2x2", (2, 2), torch.bfloat16)):
        if x_dt == torch.bfloat16:
            tag += " bf16"
        h1, h2, hn = halo_tv_operands(x.to(x_dt), cfg, mesh_zt, dev)
        hm = dict(cfg=cfg, halo_mode=True, table_dims=(Nz, M))
        ms[f"B3 halo{tag}"] = launch_ms(lambda: fused.tv_norms(h1, **hm))
        ms[f"B4 halo{tag}"] = launch_ms(lambda: fused.tv_subgrad(h2, hn,
                                                                 **hm))
        tv_hash[f"B3 halo{tag}"] = digest(fused.tv_norms(h1, **hm)[0])
        tv_hash[f"B4 halo{tag}"] = digest(fused.tv_subgrad(h2, hn, **hm))
        del h1, h2, hn
    h1, h2, hn = halo_tv_operands(x, cfg, (4, 1), dev)
    tv_hash = {"B3 halo": digest(fused.tv_norms(h1, **halo, cfg=cfg)[0]),
               "B4 halo": digest(fused.tv_subgrad(h2, hn, **halo, cfg=cfg)),
               **tv_hash}
    del h1, h2, hn
    tv_host = {"B3 halo": host_us(lambda: fused.tv_norms(x1, cfg=cfg, **halo)),
               "B4 halo": host_us(lambda: fused.tv_subgrad(x2, n1, cfg=cfg,
                                                           **halo))}
    # B8 from seeded states: the hashes of its outputs, then the host's and
    # the device's share of a launch
    rng = np.random.default_rng(4)

    def seeded(*shape):
        return torch.as_tensor(0.1 * rng.standard_normal(shape),
                               dtype=torch.float32, device=dev)

    bx, bx0 = xs.clone(), x0s.clone()
    bA, bD = seeded(*shard), seeded(nz, M, Nd, Nr, Nc)
    bxh, byh = seeded(2, M, Nr, Nc) + 0.5, seeded(2, M, Nd, Nr, Nc)
    btv = fused.cp_dual(bx, bx0, bA, bD, interior=True, **dk, **td)[2]
    fused.cp_dual_boundary(bx, bxh, bx0, bA, bD, btv, **dk, **td)
    b8_hash = {"B8 dual": digest(bA, bD)}
    bfid = fused.cp_primal(bx, bx0, bA, bD, interior=True, **pk, **td)[1]
    fused.cp_primal_boundary(bx, bx0, bA, bD, byh, bfid, **pk, **td)
    b8_hash["B8 primal"] = digest(bx)
    sums = (float(btv.sum()), float(bfid.sum()))

    from pytv4d_tpu_torch.utils.profiling import device_time

    b8 = {"B8 dual": lambda: fused.cp_dual_boundary(
              xs, x_halo, x0s, yAs, yDs, tv, **dk, **td),
          "B8 primal": lambda: fused.cp_primal_boundary(
              xs, x0s, yAs, yDs, y_halo, fid, **pk, **td)}
    b8_host = {k: host_us(fn) for k, fn in b8.items()}
    b8_dev = {k: device_time(lambda: [fn() for _ in range(50)], 50, dev)[0]
              for k, fn in b8.items()}
    step_wall, step_dev = sharded_steps(x0, cfg, dev)
    print(f"[stencil times, one z-shard] {os.path.relpath(root)} {shard} "
          f"f32: " + ", ".join(f"{k} {v:.4f} ms" for k, v in ms.items())
          + "; B8 host per launch: "
          + ", ".join(f"{k} {v:.1f} us" for k, v in b8_host.items())
          + "; B8 on the device (torch.profiler): "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in b8_dev.items())
          + "; B8 output hashes: "
          + ", ".join(f"{k} {v}" for k, v in b8_hash.items())
          + f" (TV / fidelity partial sums {sums[0]:.6e} / {sums[1]:.6e})"
          + f"; {SHAPE} as 4 z-shards, ms per iteration wall / device: "
          + ", ".join(f"{k} {step_wall[k]:.4f} / {step_dev[k]:.4f}"
                      for k in step_wall)
          + "; B3 / B4 halo host per launch: "
          + ", ".join(f"{k} {v:.1f} us" for k, v in tv_host.items())
          + "; B3 / B4 halo output hashes (norms / G after one launch, on "
          "the sharded TV's operands; the (2 x 2) grid's shard (16, 4, 256, "
          "256)): " + ", ".join(f"{k} {v}" for k, v in tv_hash.items())
          + f"; card {card()}", flush=True)
    cp_ms, cp_dev, cp_hash = cp_shard_modes(cfg, dev)
    print(f"[sharded CP kernels] {os.path.relpath(root)} one z-shard {shard} "
          f"+ its planes, hybrid reg_time=0.5, per launch, CUDA events / "
          f"device (torch.profiler): "
          + ", ".join(f"{k} {cp_ms[k]:.4f} / {cp_dev[k]:.4f} ms"
                      for k in cp_ms)
          + "; output hashes (y_A', y_D' after one B1 launch, x' after one "
          "B2 launch, from seeded states): "
          + ", ".join(f"{k} {v}" for k, v in cp_hash.items())
          + f"; card {card()}", flush=True)
    split = tv_grid_split(x0, cfg, dev, root)
    print(f"[sharded TV split] {os.path.relpath(root)} {SHAPE} f32 hybrid "
          f"reg_time=0.5, device ms (torch.profiler) and wall ms: "
          + "; ".join(f"{k} {v[0]:.4f} = " + ", ".join(
              f"{part} {t:.4f}" for part, t in v[1].items())
              + f" (wall {v[2]:.4f}, host {v[3]:.4f})"
              for k, v in split.items())
          + f"; card {card()}", flush=True)


def halo_tv_operands(vol, cfg, mesh_zt, dev):
    """What the sharded TV hands B3 and B4 in their halo mode on the second
    shard along z of ``vol`` cut by a (z, t) mesh: x extended by one and by
    two planes per side in z and t, and the norms extended by one (safe
    divisors at the ghost planes)."""
    from pytv4d_tpu_torch.core.schemes import AXIS_T, AXIS_Z, scheme_channels
    from pytv4d_tpu_torch.kernels import fused
    from pytv4d_tpu_torch.parallel import fused_halo as fh
    from pytv4d_tpu_torch.parallel import make_mesh, shard_volume
    from pytv4d_tpu_torch.parallel.mesh import grid_map

    chans, _ = scheme_channels(cfg.scheme, *vol.shape[:2], cfg.reg_z_over_reg,
                               cfg.reg_time)
    gz = fh._axis_ghost_kind(chans, AXIS_Z)
    gt = fh._axis_ghost_kind(chans, AXIS_T)
    xs = shard_volume(vol, make_mesh(*mesh_zt, device=dev), mesh_zt[1] > 1)
    x1 = fh._extend_axis(fh._extend_axis(xs, 0, gz), 1, gt)
    x2 = fh._extend_axis2(fh._extend_axis2(xs, 0, gz), 1, gt)
    mode = dict(cfg=cfg, halo_mode=True, table_dims=tuple(vol.shape[:2]))
    n1 = fh._extend_norms(grid_map(lambda e: fused.tv_norms(e, **mode)[0],
                                   x1))
    return x1[1][0], x2[1][0], n1[1][0]


def cp_shard_modes(cfg, dev):
    """B1 and B2 on one z-shard of :data:`SHAPE` (its second) in both
    sharded modes, f32 and bf16 (primary and dual), from seeded states: ms
    per launch (CUDA events, :func:`launch_ms`), the device's ms
    (``torch.profiler`` over 50 launches) and the hashes of y_A' and y_D'
    after one B1 launch and of x' after one B2 launch (written to a copy
    of x).  ``halo_mode`` takes x and the dual extended by one plane a side
    in z and t, ``interior`` the shard alone."""
    from pytv4d_tpu_torch.core.schemes import num_channels
    from pytv4d_tpu_torch.kernels import fused
    from pytv4d_tpu_torch.utils.profiling import device_time

    Nz, M, Nr, Nc = SHAPE
    nz = Nz // 4
    Nd = num_channels(cfg.scheme, Nz, M, cfg.reg_z_over_reg, cfg.reg_time)
    rng = np.random.default_rng(20)
    td = dict(table_dims=(Nz, M))
    dk = dict(cfg=cfg, sigma_D=0.5, sigma_A=1.0, reg=1.0, **td)
    pk = dict(cfg=cfg, tau=0.1, **td)
    ms, on_dev, hashes = {}, {}, {}
    for dtype in (torch.float32, torch.bfloat16):
        def seeded(*shape):
            return torch.as_tensor(rng.standard_normal(shape),
                                   dtype=torch.float32, device=dev).to(dtype)

        x, x0, y_A = (seeded(nz, M, Nr, Nc) for _ in range(3))
        x1 = seeded(nz + 2, M + 2, Nr, Nc)
        y_D = seeded(nz, M, Nd, Nr, Nc)
        y1 = seeded(nz + 2, M + 2, Nd, Nr, Nc)
        runs = {
            "B1 halo": lambda a, d, o: fused.cp_dual(
                x1, x0, a, d, halo_mode=True, **dk),
            "B1 interior": lambda a, d, o: fused.cp_dual(
                x, x0, a, d, interior=True, **dk),
            "B2 halo": lambda a, d, o: fused.cp_primal(
                x, x0, a, d, y_ext=y1, halo_mode=True, out=o, **pk),
            "B2 interior": lambda a, d, o: fused.cp_primal(
                x, x0, a, d, interior=True, out=o, **pk)}
        tag = "" if dtype == torch.float32 else " bf16"
        for name, run in runs.items():
            a, d, o = y_A.clone(), y_D.clone(), x.clone()
            run(a, d, o)
            hashes[name + tag] = digest(o) if "B2" in name else digest(a, d)
            ms[name + tag] = launch_ms(lambda: run(a, d, o))
            on_dev[name + tag] = device_time(
                lambda: [run(a, d, o) for _ in range(50)], 50, dev)[0]
            del a, d, o
        del x, x0, y_A, x1, y_D, y1
    return ms, on_dev, hashes


def traced_ms(run, key, n=50, traces=3):
    """The device ms of one launch of the kernel whose name holds ``key``,
    the mean over a ``torch.profiler`` trace of ``n`` calls of ``run`` (one
    launch each) that recorded all ``n``.  A trace can drop the first
    records of its window, so it opens with 32 small kernels of its own and
    a pause of 50 ms on the host before the ``n`` calls, and closes with
    one more small kernel; a trace that lost records all the same is taken
    again, up to ``traces`` times, then it raises."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    mark = torch.zeros(1, device="cuda")
    for _ in range(traces):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(32):
                mark.add_(1.0)
            torch.cuda.synchronize()
            time.sleep(0.05)
            for _ in range(n):
                run()
            mark.add_(1.0)
            torch.cuda.synchronize()
        ms = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
              if e.device_type == DeviceType.CUDA and key in e.name]
        if len(ms) == n:
            return sum(ms) / n
    raise RuntimeError(f"no trace kept all {n} launches of {key}: "
                       f"{len(ms)}")


def b2_bound(shape, Nd, x_dt, d_dt):
    """The least ms of B2 on an unsharded ``shape``: x, x0, y_A and the Nd
    dual channels read and x' written, each once, over the HBM rate, or
    4 operations a channel and 8 a voxel over the float32 rate."""
    from pytv4d_tpu_torch.utils.profiling import H100_HBM_PEAK_GBPS

    vox = int(np.prod(shape))
    n_bytes = (4 * x_dt.itemsize + Nd * d_dt.itemsize) * vox
    return max(n_bytes / (H100_HBM_PEAK_GBPS * 1e9),
               (4 * Nd + 8) * vox / H100_F32_PEAK_FLOPS) * 1e3


def b2_times(cfg, dev):
    """B2 on an unsharded volume (module docstring): ``(ms, device ms,
    bounds, x' hashes, fidelity partial sums)``."""
    from pytv4d_tpu_torch.core.config import TVConfig
    from pytv4d_tpu_torch.core.schemes import SCHEMES, num_channels
    from pytv4d_tpu_torch.kernels import fused

    rng = np.random.default_rng(22)

    def seeded(shape, c):
        Nd = num_channels(c.scheme, *shape[:2], c.reg_z_over_reg,
                          c.reg_time)
        arrs = [rng.random(shape, dtype=np.float32) for _ in range(3)]
        y = 0.3 * rng.standard_normal((*shape[:2], Nd, *shape[2:]),
                                      dtype=np.float32)
        tm = 0.5 + rng.random(shape[2:], dtype=np.float32)
        return [torch.as_tensor(a, device=dev) for a in (*arrs, y, tm)]

    def variants(x, x0, y_A, y_D, tm, c):
        pk = dict(cfg=c, tau=0.1)
        return {"in place": lambda o: fused.cp_primal(o, x0, y_A, y_D, **pk),
                "out of place, x0 = x": lambda o: fused.cp_primal(
                    x, x, y_A, y_D, out=o, **pk),
                "nonneg l1": lambda o: fused.cp_primal(
                    o, x0, y_A, y_D, fidelity="l1", fid_weight=0.7,
                    nonneg=True, **pk),
                "kl": lambda o: fused.cp_primal(
                    o, x0, y_A, y_D, fidelity="kl", fid_weight=0.7, **pk),
                "tmul": lambda o: fused.cp_primal(o, x0, y_A, y_D, tm,
                                                  **pk)}

    bf16 = torch.bfloat16
    ms, on_dev, bounds, hashes, fids = {}, {}, {}, {}, {}
    Nd = num_channels(cfg.scheme, *SHAPE[:2], cfg.reg_z_over_reg,
                      cfg.reg_time)
    base = seeded(SHAPE, cfg)
    for tag, (x_dt, d_dt) in (("f32", (torch.float32, torch.float32)),
                              ("bf16 dual", (torch.float32, bf16)),
                              ("bf16", (bf16, bf16))):
        x, x0, y_A = (a.to(x_dt) for a in base[:3])
        y_D = base[3].to(d_dt)
        for name, run in variants(x, x0, y_A, y_D, base[4], cfg).items():
            o = x.clone()
            fid = run(o)[1]
            hashes[f"B2 {tag} {name}"] = digest(o)
            if name == "in place":
                fids[f"B2 {tag}"] = float(fid.double().sum())
        key, xs = f"B2 {tag}", x.clone()

        def launch():
            fused.cp_primal(xs, x0, y_A, y_D, cfg=cfg, tau=0.1)
        ms[key] = launch_ms(launch)
        on_dev[key] = traced_ms(launch, "cp_primal")
        bounds[key] = b2_bound(SHAPE, Nd, x_dt, d_dt)
        del x, x0, y_A, y_D, xs
    del base
    for shape, c in [*((s, TVConfig(scheme=k, reg_time=0.5))
                       for k in SCHEMES
                       for s in ((4, 3, 64, 96), (2, 2, 24, 71))),
                     ((1, 1, 256, 256), TVConfig())]:
        x, x0, y_A, y_D, tm = seeded(shape, c)
        for name, run in variants(x, x0, y_A, y_D, tm, c).items():
            if shape[1] == 1 and name == "tmul":
                continue  # one time step: no time channel to multiply
            o = x.clone()
            run(o)
            hashes[f"B2 {c.scheme} {shape} {name}"] = digest(o)
    return ms, on_dev, bounds, hashes, fids


# B5's halo-mode shards: a z-shard of SHAPE, and one of 4 z-shards and of a
# (2 x 2) grid of the CT cell, with the whole volume's (Nz, M)
B5_SHARDS = {"z4": ((8, 8, 256, 256), SHAPE[:2]),
             "CT z4": ((4, 4, 512, 512), (16, 4)),
             "CT 2x2": ((8, 2, 512, 512), (16, 4))}


# float32 operations/s of the H100 SXM outside the tensor cores (data sheet)
H100_F32_PEAK_FLOPS = 67e12


def b5_halo_bound(shard, dims, cfg, x_dt, d_dt):
    """The least ms of B5 in its halo mode on ``shard`` of a volume whose
    (Nz, M) is ``dims``: the bytes it must move -- x_bar at the shard and
    at one plane beyond each face along z and t that the table's channels
    read (FWD the one above, BWD the one below, CTR both), the dual read
    and written -- over the HBM rate, or 10 operations a channel and voxel
    over the float32 rate, whichever is larger."""
    from pytv4d_tpu_torch.core.schemes import AXIS_T, AXIS_Z, scheme_channels
    from pytv4d_tpu_torch.utils.profiling import H100_HBM_PEAK_GBPS

    nz, m, Nr, Nc = shard
    chans, _ = scheme_channels(cfg.scheme, *dims, cfg.reg_z_over_reg,
                               cfg.reg_time)
    own, Nd = nz * m, len(chans)
    x_planes = own + sum(
        face * sum(any(c.kind in kinds for c in chans if c.axis == a)
                   for kinds in (("bwd", "ctr"), ("fwd", "ctr")))
        for a, face in ((AXIS_Z, m), (AXIS_T, nz)))
    n_bytes = (x_planes * x_dt.itemsize
               + 2 * own * Nd * d_dt.itemsize) * Nr * Nc
    return max(n_bytes / (H100_HBM_PEAK_GBPS * 1e9),
               10 * Nd * own * Nr * Nc / H100_F32_PEAK_FLOPS) * 1e3


def b5_halo_times(cfg, dev):
    """B5 in its halo mode on each shard of :data:`B5_SHARDS`, f32, with a
    bf16 dual and in bf16, from seeded states (x_bar extended by one plane
    a side in z and t): ms per launch (CUDA events, :func:`launch_ms`),
    the device's ms (``torch.profiler`` over 50 launches), the hash of
    y_D' after one launch and the bound (:func:`b5_halo_bound`)."""
    from pytv4d_tpu_torch.core.schemes import num_channels
    from pytv4d_tpu_torch.kernels import fused
    from pytv4d_tpu_torch.utils.profiling import device_time

    rng = np.random.default_rng(21)
    bf16 = torch.bfloat16
    ms, on_dev, hashes, bounds = {}, {}, {}, {}
    for tag, (shard, dims) in B5_SHARDS.items():
        nz, m, Nr, Nc = shard
        Nd = num_channels(cfg.scheme, *dims, cfg.reg_z_over_reg,
                          cfg.reg_time)
        kw = dict(cfg=cfg, sigma_D=0.5, reg=1.0, halo_mode=True,
                  table_dims=dims)
        x1 = torch.as_tensor(rng.standard_normal((nz + 2, m + 2, Nr, Nc)),
                             dtype=torch.float32, device=dev)
        y0 = torch.as_tensor(0.3 * rng.standard_normal((nz, m, Nd, Nr, Nc)),
                             dtype=torch.float32, device=dev)
        for name, (x_dt, d_dt) in (("", (torch.float32, torch.float32)),
                                   (" bf16 dual", (torch.float32, bf16)),
                                   (" bf16", (bf16, bf16))):
            key = f"B5 halo {tag}{name}"
            xb, y = x1.to(x_dt), y0.to(d_dt)
            fused.tv_dual(xb, y, **kw)
            hashes[key] = digest(y)
            ms[key] = launch_ms(lambda: fused.tv_dual(xb, y, **kw))
            on_dev[key] = device_time(
                lambda: [fused.tv_dual(xb, y, **kw) for _ in range(50)], 50,
                dev)[0]
            bounds[key] = b5_halo_bound(shard, dims, cfg, x_dt, d_dt)
            del xb, y
        del x1, y0
    return ms, on_dev, hashes, bounds


CT_SHAPE, CT_ANGLES = (16, 4, 512, 512), 96  # the CT cell
# the fused sharded CT step's kernels, by a substring of their names
CT_PARTS = {"B5": "tv_dual", "B2": "cp_primal", "B3": "tv_norms"}


def ct_grid_split(cfg, dev, n_iter=10):
    """Device ms per iteration (``torch.profiler``) of an ``n_iter``
    -iteration fused ``cp_reconstruct`` of the CT cell's seeded sinogram
    handed over as 4 z-shards (``chip_smoke.py`` phase 32's solve; the
    spectral pair, ``nonneg``), split into B5, B2, B3 (:data:`CT_PARTS`)
    and the rest, and the wall ms per iteration (host clock to a
    synchronisation, best of 3)."""
    from pytv4d_tpu_torch.models.ct import (cp_reconstruct, estimate_op_norm,
                                            make_projector, radon,
                                            sinogram_sharding)
    from pytv4d_tpu_torch.parallel import make_mesh, shard
    from pytv4d_tpu_torch.utils.profiling import device_time

    rng = np.random.default_rng(32)
    vol = torch.as_tensor(rng.random(CT_SHAPE, dtype=np.float32),
                          device=dev)
    angles = np.linspace(0.0, np.pi, CT_ANGLES, endpoint=False)
    sino = radon(vol, angles)
    A, A_T = make_projector(CT_SHAPE, angles)
    kw = dict(n_iter=n_iter, reg=0.5, cfg=cfg, nonneg=True,
              op_norm=float(estimate_op_norm(A, A_T, CT_SHAPE, device=dev)))
    grid = shard(sino, sinogram_sharding(make_mesh(4, 1, device=dev)))
    del vol, sino

    def run():
        cp_reconstruct(grid, angles, CT_SHAPE, **kw)

    run()
    wall = float("inf")
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall = min(wall, (time.perf_counter() - t0) * 1e3 / n_iter)
    total, by_kernel = device_time(run, n_iter, dev)
    split = dict.fromkeys((*CT_PARTS, "rest"), 0.0)
    for k, v in by_kernel.items():
        split[next((p for p, key in CT_PARTS.items() if key in k),
                   "rest")] += v
    return total, split, wall


COPY_KERNELS = ("Cat", "copy", "Memcpy", "where")


def tv_grid_split(vol, cfg, dev, root):
    """Device ms (``torch.profiler``) of the grid calls that run B3 and B4 in
    their halo mode, per call or iteration, split into B3, B4, the copies
    (:data:`COPY_KERNELS`) and the rest, the wall ms (host clock to a
    synchronisation, best of 5, before the profiler runs) and the host's ms
    (the calls queued behind a kernel that keeps the device busy for a
    second: a call that waits for the device shows it): ``{call: (total,
    split, wall, host)}``; each
    kernel's time is appended to ``chiprun_out/tv_grid_split.jsonl``."""
    import json

    from pytv4d_tpu_torch import tv_and_subgrad
    from pytv4d_tpu_torch.parallel import make_mesh, shard_volume
    from pytv4d_tpu_torch.solvers.gd import subgradient_descent
    from pytv4d_tpu_torch.utils.profiling import device_time

    grids = {k: shard_volume(vol, make_mesh(*m, device=dev), m[1] > 1)
             for k, m in (("z4", (4, 1)), ("2x2", (2, 2)))}
    kw = dict(scheme=cfg.scheme, reg_time=cfg.reg_time)
    runs = {f"tv_and_subgrad {k}, a call": (
                lambda g=g: [tv_and_subgrad(g, **kw) for _ in range(10)], 10)
            for k, g in grids.items()}
    runs["subgradient_descent z4, an iteration"] = (
        lambda: subgradient_descent(grids["z4"], n_iter=20, reg=1.0,
                                    step_size=5e-3, cfg=cfg), 20)
    out, rows = {}, []
    for name, (run, n) in runs.items():
        run()
        wall = float("inf")
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall = min(wall, (time.perf_counter() - t0) * 1e3 / n)
        torch.cuda.synchronize()
        torch.cuda._sleep(2_000_000_000)
        t0 = time.perf_counter()
        run()
        host = (time.perf_counter() - t0) * 1e3 / n
        torch.cuda.synchronize()
        total, by_kernel = device_time(run, n, dev)
        split = dict.fromkeys(("B3", "B4", "copies", "rest"), 0.0)
        for k, v in by_kernel.items():
            part = ("B3" if "tv_norms" in k else "B4" if "tv_subgrad" in k
                    else "copies" if any(c in k for c in COPY_KERNELS)
                    else "rest")
            split[part] += v
        out[name] = (total, split, wall, host)
        rows.append(dict(tree=os.path.relpath(root), call=name, total=total,
                         split=split, wall=wall, host=host,
                         by_kernel=by_kernel))
    os.makedirs("chiprun_out", exist_ok=True)
    with open(os.path.join("chiprun_out", "tv_grid_split.jsonl"), "a") as f:
        for row in rows:
            f.write(json.dumps(row) + "\n")
    return out


def sharded_steps(vol, cfg, dev):
    """ms per iteration of the 4-z-shard CP solve of ``vol`` on the
    overlapped and the ghost-plane step and of the unsharded solve: wall
    (:func:`iteration_ms`) and device (``torch.profiler`` over 20
    iterations)."""
    from pytv4d_tpu_torch.kernels.fused import to_internal_layout
    from pytv4d_tpu_torch.parallel import (make_mesh,
                                           make_sharded_cp_solver_fused,
                                           shard_volume)
    from pytv4d_tpu_torch.solvers.cp import chambolle_pock, init_state
    from pytv4d_tpu_torch.utils.profiling import device_time

    mesh = make_mesh(4, 1, device=dev)
    st = init_state(vol, cfg)
    args = [shard_volume(t, mesh, False) for t in (
        vol, st.x, st.y_A, to_internal_layout(st.y_D))]

    def sharded(overlap):
        def run(n):
            make_sharded_cp_solver_fused(
                mesh, cfg, tuple(vol.shape), reg=1.0, n_iter=n,
                shard_time=False, overlap=overlap)(*args)
        return run

    paths = {"overlap": sharded(True), "ghost": sharded(False),
             "unsharded": lambda n: chambolle_pock(
                 vol, n_iter=n, reg=1.0, cfg=cfg, return_dual=False)}
    wall = {k: iteration_ms(run) for k, run in paths.items()}
    on_dev = {k: device_time(lambda: run(20), 20, dev)[0]
              for k, run in paths.items()}
    return wall, on_dev


if __name__ == "__main__":
    main()
