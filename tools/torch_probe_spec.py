"""A/B of the specialised B1 / B4 kernels' design choices on one GPU.

    python3 tools/torch_probe_spec.py

Three parts, each against the shipped ``csrc/specialised.cu``:

- build: the eight sources of ``kernels/build.py`` compiled all at once, as
  ``chip_smoke.py`` phase 2 does, first with the shipped flags, then with
  ``specialised.cu`` compiled without ``-split-compile``; the wall time of
  each round and ``specialised.cu``'s own seconds, kernels, registers and
  spills.
- offsets: the shipped 32-bit offsets within a plane (``Offset``) against
  a variant with 64-bit ones, hybrid tables only; one launch of B1 and B4
  for the hybrid
  ``reg_time=0.5`` table at (32, 8, 256, 256) in five norm/storage cases,
  and of B1 at the north-star (96, 16, 512, 512) in bf16, as its phase of
  ``chip_smoke.py`` stores it.
- widths: B1's columns per thread (``VEC``: 2, or 4 with 16-byte
  accesses) and B4's rows per thread (``RPT``: 1, 2 or 4), in variants of
  the source restricted to the hybrid tables; one launch of each at
  (32, 8, 256, 256) for the hybrid ``reg_time=0.5`` table, iso in float32,
  with a bf16 dual and in bf16, aniso in float32 and bf16.

Variants are written under ``pytv4d_tpu_torch/_build/variants/``
(git-ignored).  A time is the mean of 50 launches between two CUDA events,
best of 5; every variant's outputs must equal the shipped kernel's bit for
bit.  The last line is the card's name and power limit.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import os
import re
import shutil
import subprocess
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from pytv4d_tpu_torch.core.config import TVConfig  # noqa: E402
from pytv4d_tpu_torch.kernels import build, fused, tables  # noqa: E402

SOURCES = ("cp_fused", "tv_fused", "tgv_stream", "tgv_resident", "resident",
           "cp_zstream", "cp_boundary", "specialised")
WIDTHS = ((2, 2), (4, 1), (2, 1), (4, 2), (4, 4))  # (VEC, RPT), shipped first
SHAPE = (32, 8, 256, 256)
OUT = os.path.join(build.BUILD_DIR, "variants")
DEV = torch.device("cuda", 0)

# B1's vector accesses at four columns per thread
FOUR_WIDE = r"""__device__ __forceinline__ void ld_vec(const float* p, float (&v)[VEC]) {
  const float4 a = *reinterpret_cast<const float4*>(p);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}
__device__ __forceinline__ void ld_vec(const __nv_bfloat16* p,
                                       float (&v)[VEC]) {
  const uint2 b = *reinterpret_cast<const uint2*>(p);
  const unsigned a[2] = {b.x, b.y};
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    v[2 * j] = __uint_as_float(a[j] << 16);
    v[2 * j + 1] = __uint_as_float(a[j] & 0xffff0000u);
  }
}
__device__ __forceinline__ void st_vec(float* p, const float (&v)[VEC]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ unsigned bf16_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}
__device__ __forceinline__ void st_vec(__nv_bfloat16* p,
                                       const float (&v)[VEC]) {
  *reinterpret_cast<uint2*>(p) =
      make_uint2(bf16_bits(v[0]) | bf16_bits(v[1]) << 16,
                 bf16_bits(v[2]) | bf16_bits(v[3]) << 16);
}

"""


def edit(path, pattern, repl):
    with open(path) as f:
        text = f.read()
    new, n = re.subn(pattern, repl, text, flags=re.S)
    if n == 0:
        raise RuntimeError(f"{path}: no match for {pattern!r}")
    with open(path, "w") as f:
        f.write(new)


def variant(name, hybrid_only=True, edits=()):
    """A copy of csrc/ with ``edits`` (pattern, replacement) applied to
    specialised.cu; with ``hybrid_only`` it instantiates the hybrid tables
    alone."""
    d = os.path.join(OUT, name)
    shutil.copytree(build.CSRC, d)
    if hybrid_only:
        edit(os.path.join(d, "tables.cuh"),
             r"(#define CHANNEL_TABLES\(X\)).*?CENTRAL_FWD_TABLES\(X\)",
             r"\1 HYBRID_TABLES(X)")
    for pattern, repl in edits:
        edit(os.path.join(d, "specialised.cu"), pattern, repl)
    return d


def compile_(src, flags):
    """nvcc ``src`` with ``flags``: (seconds, library, ptxas report)."""
    so = src[:-3] + ".so"
    t0 = time.perf_counter()
    proc = subprocess.run([build.find_nvcc(), *flags, "-o", so, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise build.BuildError(proc.stderr)
    log = proc.stdout + proc.stderr
    regs = {}
    for entry in re.split(r"Compiling entry function '", log)[1:]:
        kind = "B1" if "cp_dual" in entry.split("'")[0] else "B4"
        regs.setdefault(kind, []).append(
            int(re.search(r"Used (\d+) registers", entry).group(1)))
    spills = [tuple(map(int, m)) for m in re.findall(
        r"(\d+) bytes stack frame, (\d+) bytes spill stores", log)]
    return time.perf_counter() - t0, so, regs, spills


def report(regs, spills):
    if not regs or not spills:
        return "no ptxas report"
    n = sum(len(v) for v in regs.values())
    return (f"{n} kernels, " + ", ".join(
        f"{k} {min(v)}-{max(v)} registers" for k, v in sorted(regs.items()))
        + f", stack frame <= {max(s[0] for s in spills)} B, spill stores <= "
        f"{max(s[1] for s in spills)} B")


def part_build():
    rounds = (("shipped flags", build.nvcc_flags("specialised")),
              ("specialised.cu without -split-compile", build.NVCC_FLAGS))
    for i, (what, spec_flags) in enumerate(rounds):
        d = variant(f"build{i}", hybrid_only=False)
        jobs = [(os.path.join(d, f"{s}.cu"),
                 spec_flags if s == "specialised" else build.nvcc_flags(s))
                for s in SOURCES]
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
            done = list(pool.map(lambda j: compile_(*j), jobs))
        wall = time.perf_counter() - t0
        sec, _, regs, spills = done[-1]
        print(f"[build, {what}] {len(jobs)} sources in parallel {wall:.1f} s;"
              f" specialised.cu {sec:.1f} s, {report(regs, spills)}",
              flush=True)


def bind(path):
    lib = ctypes.CDLL(path)
    ptr, cint = ctypes.c_void_p, ctypes.c_int
    pp = ctypes.POINTER(fused._Params)
    _, _, launches = fused._ENTRY_POINTS["specialised"]
    for fn_name, (n_int, n_ptr) in launches.items():
        getattr(lib, fn_name).argtypes = ([pp] + [cint] * n_int
                                          + [ptr] * (n_ptr + 1))
    lib.spec_num_parts.restype = ctypes.c_longlong
    return lib


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


class Case:
    """One volume's operands for B1 and B4 of the hybrid ``reg_time=0.5``
    table in ``norm``, with x in ``x_dt`` and the dual in ``d_dt``."""

    def __init__(self, shape, norm, x_dt, d_dt):
        gen = torch.Generator(device=DEV).manual_seed(0)
        self.shape, self.norm, self.x_dt, self.d_dt = shape, norm, x_dt, d_dt
        self.cfg = TVConfig(scheme="hybrid", reg_time=0.5, norm=norm)
        self.tid = tables.table_id(self.cfg, *shape[:2])
        self.p = fused._params(self.cfg, shape, False, sigma_D=0.5,
                               sigma_A=1.0, reg=0.5)
        x0 = torch.rand(shape, generator=gen, device=DEV)
        self.x = (x0 + 0.1).to(x_dt)
        self.x0 = x0.to(x_dt)
        self.y_A = torch.rand(shape, generator=gen, device=DEV).to(x_dt)
        self.y_D = torch.rand((*shape[:2], 8, *shape[2:]), generator=gen,
                              device=DEV).to(d_dt)
        norms, _ = fused.tv_norms(self.x, cfg=self.cfg)
        self.norms = None if norm == "aniso" else norms
        self.flags = (int(x_dt == torch.bfloat16),
                      int(d_dt == torch.bfloat16))
        self.stream = torch.cuda.current_stream(DEV).cuda_stream

    def title(self):
        return (f"{self.norm} x {str(self.x_dt)[6:]} dual "
                f"{str(self.d_dt)[6:]} {self.shape}")

    def kernels(self, lib):
        """B1 and B4 of ``lib``, each writing its own copy of the outputs;
        and those outputs after one launch of each."""
        y_A, y_D = self.y_A.clone(), self.y_D.clone()
        parts = torch.empty(lib.spec_num_parts(*self.shape), device=DEV)
        g = torch.empty(self.shape, dtype=self.x_dt, device=DEV)
        n_ptr = None if self.norms is None else self.norms.data_ptr()

        def b1():
            code = lib.spec_cp_dual_launch(
                ctypes.byref(self.p), self.tid, *self.flags,
                self.x.data_ptr(), self.x0.data_ptr(), y_A.data_ptr(),
                y_D.data_ptr(), None, parts.data_ptr(), self.stream)
            assert code == 0, code

        def b4():
            code = lib.spec_tv_subgrad_launch(
                ctypes.byref(self.p), self.tid, self.flags[0],
                self.x.data_ptr(), n_ptr, None, g.data_ptr(), self.stream)
            assert code == 0, code

        b1()
        b4()
        torch.cuda.synchronize()
        return b1, b4, (y_A.clone(), y_D.clone(), g.clone())


def same(a, b):
    return all(torch.equal(u, v) for u, v in zip(a, b))


def part_offsets():
    d = variant("offsets64", edits=[(r"typedef int Offset;",
                                     "typedef int64_t Offset;")])
    sec, so, regs, spills = compile_(os.path.join(d, "specialised.cu"),
                                     build.nvcc_flags("specialised"))
    print(f"[offsets, build] 64-bit: nvcc {sec:.1f} s, {report(regs, spills)}",
          flush=True)
    libs = {"int": fused._lib("specialised"), "int64_t": bind(so)}
    f32, bf16 = torch.float32, torch.bfloat16
    north = (96, 16, 512, 512)
    for shape, norm, x_dt, d_dt, which in (
            (SHAPE, "iso", f32, f32, "B1 B4"), (SHAPE, "iso", f32, bf16, "B1"),
            (SHAPE, "iso", bf16, bf16, "B1 B4"),
            (SHAPE, "aniso", f32, f32, "B1 B4"),
            (north, "iso", bf16, bf16, "B1")):
        case = Case(shape, norm, x_dt, d_dt)
        runs = {k: case.kernels(lib) for k, lib in libs.items()}
        if not same(runs["int"][2], runs["int64_t"][2]):
            raise RuntimeError(f"{case.title()}: 64-bit offsets change the "
                               f"outputs")
        line = []
        for i, kernel in enumerate(("B1", "B4")):
            if kernel in which:
                # shipped, variant, variant, shipped
                t = [launch_ms(runs[k][i])
                     for k in ("int", "int64_t", "int64_t", "int")]
                line.append(f"{kernel} int {t[0]:.4f} / {t[3]:.4f}, int64_t "
                            f"{t[1]:.4f} / {t[2]:.4f}")
        print(f"[offsets, ms per launch, {case.title()}] " + "; ".join(line)
              + "; outputs bit-equal", flush=True)
        del case, runs
        torch.cuda.empty_cache()


def part_widths():
    f32, bf16 = torch.float32, torch.bfloat16
    with concurrent.futures.ThreadPoolExecutor(len(WIDTHS)) as pool:
        def make(w):
            vec, rpt = w
            edits = [(r"constexpr int VEC = \d+;",
                      f"constexpr int VEC = {vec};"),
                     (r"constexpr int RPT = \d+;",
                      f"constexpr int RPT = {rpt};")]
            if vec == 4:
                edits.append((r"__device__ __forceinline__ void ld_vec\(const "
                              r"float\* p.*?(?=// The n <= VEC)",
                              FOUR_WIDE.replace("\\", "\\\\")))
            d = variant(f"vec{vec}_rpt{rpt}", edits=edits)
            return w, compile_(os.path.join(d, "specialised.cu"),
                               build.nvcc_flags("specialised"))
        built = list(pool.map(make, WIDTHS))
    for (vec, rpt), (sec, _, regs, spills) in built:
        print(f"[widths, build] VEC {vec} RPT {rpt}: nvcc {sec:.1f} s, "
              f"{report(regs, spills)}", flush=True)
    libs = {w: bind(so) for w, (_, so, _, _) in built}
    for norm, x_dt, d_dt in (("iso", f32, f32), ("iso", f32, bf16),
                             ("iso", bf16, bf16), ("aniso", f32, f32),
                             ("aniso", bf16, bf16)):
        case, line, ref = Case(SHAPE, norm, x_dt, d_dt), [], None
        for w, lib in libs.items():
            b1, b4, outs = case.kernels(lib)
            ref = ref or outs
            if not same(outs, ref):
                raise RuntimeError(f"VEC, RPT {w}: outputs differ from the "
                                   f"shipped widths'")
            line.append(f"VEC {w[0]} RPT {w[1]}: B1 {launch_ms(b1):.4f}, "
                        f"B4 {launch_ms(b4):.4f}")
        print(f"[widths, ms per launch, {case.title()}] " + "; ".join(line),
              flush=True)
        del case
        torch.cuda.empty_cache()


def main():
    shutil.rmtree(OUT, ignore_errors=True)
    part_build()
    part_offsets()
    part_widths()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip())


if __name__ == "__main__":
    main()
