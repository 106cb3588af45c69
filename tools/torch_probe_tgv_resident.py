"""What bounds the whole-solve TGV kernels (B7): an A/B of the on-chip
kernel's launch shape against the L2 kernel on one GPU.

    python3 tools/torch_probe_tgv_resident.py

Times ``tgv_onchip_kernel`` (``csrc/tgv_onchip.cu``, one cluster per slice
with the slice's state in its shared memory) with clusters of 16 and, where
a slice fits, of 8 blocks, each with blocks of 1024 and (where 8 pixels a
thread cover a band) of 512 threads, and
``tgv_resident_kernel`` (``csrc/tgv_resident.cu``, the state in global
memory) beside each, with and without the loss, at 1, 16 and 256 slices of
256 x 256 and of 256 x 160 (where 8 blocks hold a slice with the loss too).
Each line is the marginal time of one iteration (between a 20- and a
120-iteration solve, best of 5, CUDA events) in microseconds, with the
clusters the card holds at once (``cudaOccupancyMaxActiveClusters``).
Before timing, every launch shape's state after 50 iterations must equal
the L2 kernel's bit for bit (its losses to 1e-5).  Last, what an iteration
of the shipped shape at 256 x 256 (1024 threads, 4 pixels a thread) is
made of: the instructions ``cuobjdump -sass`` lists between its cluster
barriers (PQ, XW, loss; a static count over the 4 pixels, both the
interior and the edge-row paths), by opcode.  Imports the port only (no
jax); needs a CUDA device and nvcc.
"""

from __future__ import annotations

import collections
import os
import re
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pytv4d_tpu_torch.kernels import build, tgv_resident  # noqa: E402
from pytv4d_tpu_torch.kernels.tgv_stream import tgv_params  # noqa: E402

SLICES = ((1, 1), (16, 1), (32, 8))
WIDTHS = ((256, 256), (256, 160))


def best_ms(fn, repeats=5):
    fn()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end))
    return best


def marginal_us(solve):
    return (best_ms(lambda: solve(120)) - best_ms(lambda: solve(20))) * 10.0


def launch_shapes(shape, loss):
    """The (cluster, threads) pairs the on-chip kernel can take for
    ``shape``: 16 and 8 blocks, 1024 and 512 threads."""
    out = []
    for cluster in (16, 8):
        for threads in (1024, 512):
            try:
                tgv_resident.onchip_launch_shape(shape, loss, cluster, threads)
            except ValueError:
                continue
            out.append((cluster, threads))
    return out


def sass_phases(kernel="tgv_onchip_kernelILi1024ELi4ELb1E"):
    """Per phase of ``kernel`` (the text between two cluster barriers in
    its SASS): the number of instructions and the most frequent opcodes."""
    cuobjdump = os.path.join(os.path.dirname(build.find_nvcc()), "cuobjdump")
    path, _, _ = build.build("tgv_onchip")
    sass = subprocess.run([cuobjdump, "-sass", path], capture_output=True,
                          text=True, check=True).stdout
    body = next(part for part in re.split(r"\n\s*Function : ", sass)[1:]
                if kernel in part.split("\n")[0])
    ins = [ln.split("*/", 1)[1].split(";")[0].strip()
           for ln in body.split("\n")
           if re.match(r"\s*/\*[0-9a-f]{4,}\*/", ln)]
    cuts = [i for i, ln in enumerate(ins) if "UCGABAR_ARV" in ln]
    out = []
    for name, a, b in zip(("PQ", "XW", "loss and the final store"), cuts,
                          cuts[1:]):
        ops = collections.Counter(
            ln.split()[1 if ln.startswith("@") else 0].split(".")[0]
            for ln in ins[a:b] if ln)
        top = ", ".join(f"{op} {n}" for op, n in ops.most_common(8))
        out.append(f"{name} {b - a} ({top})")
    return out


def main():
    if not torch.cuda.is_available():
        sys.exit("this probe needs an NVIDIA GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(card.stdout.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    for width in WIDTHS:
        for loss in (True, False):
            # the same state from every launch shape
            shape = (1, 1) + width
            x = torch.rand(shape, generator=gen, device=dev)
            prm = tgv_params(shape, "2d", 1.0, 2.0, 1.0, "iso", 1.0)
            ref = tgv_resident.solve_l2(x, 50, prm, loss)
            for cluster, threads in launch_shapes(shape, loss):
                got = tgv_resident.solve_onchip(x, 50, prm, loss, cluster,
                                                threads)
                torch.cuda.synchronize()
                same = all(torch.equal(a.view(torch.int32),
                                       b.view(torch.int32))
                           for a, b in zip(got[:6], ref[:6]))
                rel = (float(((got[6] - ref[6]).abs() / ref[6]).max())
                       if loss else 0.0)
                if not same or rel > 1e-5:
                    raise RuntimeError(
                        f"{width} loss={loss} C={cluster} threads={threads}: "
                        f"state equal {same}, losses {rel:.3g} relative")
            for slices in SLICES:
                shape = slices + width
                x = torch.rand(shape, generator=gen, device=dev)
                prm = tgv_params(shape, "2d", 1.0, 2.0, 1.0, "iso", 1.0)
                times = []
                for cluster, threads in launch_shapes(shape, loss):
                    us = marginal_us(lambda n: tgv_resident.solve_onchip(
                        x, n, prm, loss, cluster, threads))
                    held = tgv_resident.max_active_clusters(shape, loss,
                                                            cluster, threads)
                    times.append(f"C={cluster} x {threads} threads {us:.2f} "
                                 f"({held} clusters at once)")
                l2 = marginal_us(lambda n: tgv_resident.solve_l2(x, n, prm,
                                                                 loss))
                times.append(f"L2 kernel {l2:.2f}")
                print(f"{shape} {'with' if loss else 'without'} the loss, "
                      f"us per iteration: " + "; ".join(times), flush=True)
    print("tgv_onchip_kernel<1024, 4, loss> SASS instructions between "
          "cluster barriers, 4 pixels a thread: "
          + "; ".join(sass_phases()), flush=True)


if __name__ == "__main__":
    main()
