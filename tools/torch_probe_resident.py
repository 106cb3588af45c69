"""What launch shape the whole-solve CP / GD kernels (B9) should take: an A/B
on one GPU.

    python3 tools/torch_probe_resident.py

Builds ``csrc/resident.cu`` (and the per-launch kernels it is compared
with) and prints what ptxas reports.  Then, at (1, 1, 256, 256), at the
coupled (4, 2, 64, 64) hybrid ``reg_time=0.5`` and at (8, 4, 128, 128),
times the shipped launch shape (a cooperative grid of
``kernels.resident.THREADS``-thread blocks with ``grid.sync()``) against
blocks of 512 and 1024 threads and against ONE thread-block cluster of 8 or
16 blocks with ``cluster.sync()``: ms per iteration between a 50- and a
300-iteration solve, best of 3, CUDA events, for CP and GD, with a check that
every shape gives the first one's state bit for bit; and the host loop over
B1 + B2 and over B3 + B4 beside them.  The cluster is a variant of the
source that this script writes into ``pytv4d_tpu_torch/_build/probe_*/`` (a
copy of ``csrc/`` with the barrier, the launch attribute and the block limit
of ``resident.cu`` rewritten).  ``chip_smoke.py`` holds the shipped kernels
against their plain versions.  Imports the port only (no jax); needs a CUDA
device and nvcc.
"""

from __future__ import annotations

import concurrent.futures
import os
import re
import shutil
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pytv4d_tpu_torch.core.config import TVConfig  # noqa: E402
from pytv4d_tpu_torch.core.schemes import num_channels  # noqa: E402
from pytv4d_tpu_torch.kernels import build, fused, resident  # noqa: E402
from pytv4d_tpu_torch.solvers.cp import default_tau  # noqa: E402

DEV = torch.device("cuda", 0)
LIBS = ("resident", "cp_fused", "tv_fused")
# (blocks of one cluster, or None for the shipped cooperative grid; threads)
LAUNCHES = [(None, 256), (None, 512), (None, 1024),
            (8, 1024), (16, 1024), (16, 512)]
# what make_cluster_variant rewrites in resident.cu
GRID_SYNC = "  cg::this_grid().sync();\n"
GRID_ATTR = ("  attr[0].id = cudaLaunchAttributeCooperative;\n"
             "  attr[0].val.cooperative = 1;\n")
MAX_BLOCKS = "int resident_max_blocks(int threads) {\n"


def log(msg):
    print(msg, flush=True)


def best_ms(fn, repeats=3):
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(repeats):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        best = min(best, a.elapsed_time(b))
    return best


def make_cluster_variant(csrc, blocks):
    """A copy of ``csrc`` whose resident.cu runs as one thread-block cluster
    of at most ``blocks`` blocks with ``cluster.sync()``; returns its
    directory."""
    out = os.path.join(build.BUILD_DIR, f"probe_cluster{blocks}")
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(csrc, out)
    path = os.path.join(out, "resident.cu")
    with open(path) as f:
        text = f.read()
    if not all(text.count(s) == 1 for s in (GRID_SYNC, GRID_ATTR, MAX_BLOCKS)):
        raise RuntimeError("resident.cu no longer has the lines this probe "
                           "rewrites")
    text = text.replace(GRID_SYNC, "  cg::this_cluster().sync();\n")
    text = text.replace(
        GRID_ATTR,
        "  cudaFuncSetAttribute((const void*)kernel,\n"
        "      cudaFuncAttributeNonPortableClusterSizeAllowed, 1);\n"
        "  attr[0].id = cudaLaunchAttributeClusterDimension;\n"
        "  attr[0].val.clusterDim.x = (unsigned)blocks;\n"
        "  attr[0].val.clusterDim.y = 1;\n"
        "  attr[0].val.clusterDim.z = 1;\n")
    text = text.replace(MAX_BLOCKS, MAX_BLOCKS + f"  return {blocks};\n")
    with open(path, "w") as f:
        f.write(text)
    return out


def do_build():
    with concurrent.futures.ThreadPoolExecutor(len(LIBS)) as pool:
        built = dict(zip(LIBS, pool.map(build.build, LIBS)))
    for name, (path, seconds, text) in built.items():
        regs = re.findall(r"Used (\d+) registers", text)
        spills = re.findall(r"(\d+) bytes stack frame, (\d+) bytes spill "
                            r"stores, (\d+) bytes spill loads", text)
        log(f"[build] {name}: {seconds:.1f} s; registers {regs}; "
            f"(stack, spill stores, spill loads) {spills}")
        fused._lib(name)


def cp_inputs(shape, cfg, gen):
    Nz, M, Nr, Nc = shape
    Nd = num_channels(cfg.scheme, Nz, M, cfg.reg_z_over_reg, cfg.reg_time)
    x0 = torch.rand(shape, generator=gen, device=DEV)
    x = x0 + 0.1 * torch.rand(shape, generator=gen, device=DEV)
    y_A = 0.1 * torch.randn(shape, generator=gen, device=DEV)
    y_D = 0.1 * torch.randn((Nz, Nd, M, Nr, Nc), generator=gen, device=DEV)
    return x0, x, y_A, y_D


def time_resident():
    cases = [((1, 1, 256, 256), TVConfig()),
             ((4, 2, 64, 64), TVConfig(scheme="hybrid", reg_time=0.5)),
             ((8, 4, 128, 128), TVConfig(scheme="hybrid", reg_time=0.5))]
    csrc, shipped = build.CSRC, resident.THREADS
    for shape, cfg in cases:
        gen = torch.Generator(device=DEV).manual_seed(3)
        x0, x, y_A, y_D = cp_inputs(shape, cfg, gen)
        y_A.zero_()
        y_D.zero_()
        x0 = 100.0 * x0
        x = x0.clone()
        kw = dict(reg=25.0, sigma_D=0.5, sigma_A=1.0,
                  tau=default_tau(cfg, shape[0], shape[1]))
        first = None
        for cluster, threads in LAUNCHES:
            build.CSRC = (csrc if cluster is None
                          else make_cluster_variant(csrc, cluster))
            fused._lib.cache_clear()
            resident.THREADS = threads
            shape_name = (f"cooperative grid, {threads}-thread blocks"
                          if cluster is None else
                          f"one cluster of <= {cluster} x {threads} threads")
            try:
                def cp(n):
                    return resident.make_resident_cp_solver(
                        cfg, shape, n, "float32", **kw)(x0, x, y_A, y_D)

                def gd(n):
                    return resident.make_resident_gd_solver(
                        cfg, shape, n, "float32", reg=25.0,
                        step_size=5e-3)(x0, x)

                out = cp(50)
                if first is None:
                    first = out
                same = all(torch.equal(a, b) for a, b in zip(out[:3],
                                                             first[:3]))
                cp_ms = (best_ms(lambda: cp(300)) - best_ms(lambda: cp(50))) / 250
                gd_ms = (best_ms(lambda: gd(300)) - best_ms(lambda: gd(50))) / 250
                one = best_ms(lambda: cp(300))
                log(f"[B9 launch shape] {shape} {shape_name}: CP "
                    f"{cp_ms:.5f} ms/it, "
                    f"GD {gd_ms:.5f} ms/it marginal; one 300-it CP solve "
                    f"{one:.3f} ms; state bit-equal to the first shape: "
                    f"{same}")
            except RuntimeError as e:
                log(f"[B9 launch shape] {shape} {shape_name}: {e}")
        build.CSRC, resident.THREADS = csrc, shipped
        fused._lib.cache_clear()

        # the host loop over the per-launch kernels
        y_int = fused.to_internal_layout(y_D)

        def host_cp(n):
            xx, ya, yd = x.clone(), y_A.clone(), y_int.clone()
            for _ in range(n):
                fused.cp_step_fused_internal(xx, ya, yd, x0, cfg=cfg, **kw)

        def host_gd(n):
            xx = x.clone()
            for _ in range(n):
                tv, G = fused.tv_and_subgrad_fused(xx, cfg)
                xx = xx - 5e-3 * ((xx - x0) + 25.0 * G)

        h_cp = (best_ms(lambda: host_cp(300)) - best_ms(lambda: host_cp(50))) / 250
        h_gd = (best_ms(lambda: host_gd(300)) - best_ms(lambda: host_gd(50))) / 250
        log(f"[B9 vs host loop] {shape}: host loop B1+B2 {h_cp:.5f} ms/it, "
            f"B3+B4+update {h_gd:.5f} ms/it (wall, CUDA events)")


def main():
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    log(f"card: {smi.stdout.strip()}; torch {torch.__version__}")
    do_build()
    time_resident()


if __name__ == "__main__":
    main()
