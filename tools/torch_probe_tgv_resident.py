"""What bounds the whole-solve TGV kernel (B7): an A/B of its launch shape on
one GPU.

    python3 tools/torch_probe_tgv_resident.py

Builds variants of ``pytv4d_tpu_torch/csrc/tgv_resident.cu`` into
``pytv4d_tpu_torch/_build/probe_*/`` (copies of ``csrc/`` with the block
size changed and, for some, the ``__threadfence()`` before each cluster
barrier removed), runs each with 8 and with 4 blocks per cluster, checks
that every variant gives the first one's iterates bit for bit (and its
losses to 1e-5), and prints the marginal
time of one iteration (between a 20- and a 120-iteration solve, best of 5,
CUDA events) without and with the loss at one 256 x 256 slice, one
512 x 512 slice, 16 slices and 256 slices of 256 x 256.  The shipped kernel
is the first line (1024 threads, fence, cluster of 8).  Imports the port
only (no jax); needs a CUDA device and nvcc.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from pytv4d_tpu_torch.kernels import build, fused, tgv_resident  # noqa: E402

SHAPES = [(1, 1, 256, 256), (1, 1, 512, 512), (16, 1, 256, 256),
          (32, 8, 256, 256)]
VARIANTS = [(1024, True), (1024, False), (512, True), (512, False),
            (256, False)]  # (threads per block, fence before the barrier)


def make_variant(csrc, block, fence):
    """A copy of ``csrc`` whose tgv_resident.cu has the given block size and
    keeps or drops the fences; returns its directory."""
    out = os.path.join(build.BUILD_DIR,
                       f"probe_b{block}_{'fence' if fence else 'nofence'}")
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(csrc, out)
    path = os.path.join(out, "tgv_resident.cu")
    with open(path) as f:
        text = f.read()
    changed = text.replace("#define RES_BLOCK 1024",
                           f"#define RES_BLOCK {block}")
    if not fence:
        changed = "".join(ln for ln in changed.splitlines(keepends=True)
                          if ln.strip() != "__threadfence();")
    if (changed == text) != (block == 1024 and fence):
        raise RuntimeError("tgv_resident.cu no longer has the lines this "
                           "probe rewrites")
    with open(path, "w") as f:
        f.write(changed)
    return out


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


def marginal_us(x, compute_loss):
    def solve(n):
        return tgv_resident.tgv_resident_solve(x, n, 1.0, 2.0,
                                               compute_loss=compute_loss)

    return (best_ms(lambda: solve(120)) - best_ms(lambda: solve(20))) * 10.0


def main():
    if not torch.cuda.is_available():
        sys.exit("this probe needs an NVIDIA GPU")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    print(card.stdout.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    xs = [torch.rand(s, generator=gen, device=dev) for s in SHAPES]
    csrc, cluster = build.CSRC, tgv_resident.CLUSTER_SIZE
    first = None
    try:
        for block, fence in VARIANTS:
            build.CSRC = make_variant(csrc, block, fence)
            fused._lib.cache_clear()
            for blocks in (8, 4):
                tgv_resident.CLUSTER_SIZE = blocks
                out = tgv_resident.tgv_resident_solve(xs[0], 50, 1.0, 2.0)
                torch.cuda.synchronize()
                first = first or out
                # the same iterates bit for bit; the loss sums over another
                # number of blocks, so it may round differently
                err = max(float((a - b).abs().max())
                          for a, b in zip(out[:6], first[:6]))
                rel = float(((out[6] - first[6]).abs() / first[6]).max())
                if err != 0.0 or rel > 1e-5:
                    raise RuntimeError(f"variant differs: state by {err}, "
                                       f"losses by {rel} relative")
                times = "; ".join(
                    f"{s}: {marginal_us(x, False):.1f} / "
                    f"{marginal_us(x, True):.1f}" for s, x in zip(SHAPES, xs))
                print(f"{block} threads, {'fence' if fence else 'no fence'}, "
                      f"cluster of {blocks}: us per iteration without / with "
                      f"the loss: {times}", flush=True)
    finally:
        build.CSRC, tgv_resident.CLUSTER_SIZE = csrc, cluster
        fused._lib.cache_clear()


if __name__ == "__main__":
    main()
