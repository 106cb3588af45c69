"""A/B of the specialised kernels' design choices on one GPU.

    python3 tools/torch_probe_spec.py [build] [offsets] [widths] [norms]
                                      [dual] [anatomy] [primal]

Seven parts (all without arguments), each against the shipped sources:

- build: the ten sources of ``kernels/build.py`` compiled all at once, as
  ``chip_smoke.py`` phase 2 does, first with the shipped flags, then with
  ``specialised.cu`` and ``specialised_tv.cu`` compiled without
  ``-split-compile``; the wall time of each round and the two sources' own
  seconds, kernels, registers and spills.
- offsets: the shipped 32-bit offsets within a plane (``Offset``) against
  a variant with 64-bit ones, hybrid tables only; one launch of B1 and B4
  for the hybrid
  ``reg_time=0.5`` table at (32, 8, 256, 256) in five norm/storage cases,
  and of B1 at the north-star (96, 16, 512, 512) in bf16, as its phase of
  ``chip_smoke.py`` stores it.
- widths: B1's columns per thread (``VEC``: 2, or 4 with 16-byte
  accesses, which ``specialised.cuh`` provides) and B4's rows per thread (``RPT``: 1, 2 or 4), in variants of
  the source restricted to the hybrid tables; one launch of each at
  (32, 8, 256, 256) for the hybrid ``reg_time=0.5`` table, iso in float32,
  with a bf16 dual and in bf16, aniso in float32 and bf16.
- norms: B3 (``specialised_tv.cu``) with its march along t (shipped),
  along z and without a march (every out-of-plane neighbour from global
  memory), with other depths of the ring (``AHEAD``), tile shapes
  (``NORMS_TC`` x ``NORMS_TR``) and register caps (``NORMS_MIN_BLOCKS``);
  hybrid ``reg_time=0.5`` at (32, 8, 256, 256) iso in float32 and bf16,
  aniso in float32, and at (16, 4, 512, 512) iso in float32.
- dual: B5's columns per thread (``VEC_TV`` 2 or 4), hybrid
  ``reg_time=0.5`` at (32, 8, 256, 256) in float32, with a bf16 dual and in
  bf16, and at (16, 4, 512, 512) in float32.
- anatomy: B3 with its norm arithmetic, its store or its across copies cut
  out, alone and together, iso in float32 and bf16 at (32, 8, 256, 256):
  what its time is made of (these variants' norms are not checked).
- primal: B2's columns per thread on an unsharded volume (``VEC_B`` 2 or
  4 in ``specialised.cu``: 8- or 16-byte f32 accesses, 4- or 8-byte bf16
  ones), hybrid ``reg_time=0.5`` at (32, 8, 256, 256) in each of the four
  storage pairs, out of place from one seeded state (x' must be bit-equal
  across the variants and the shipped kernel), and the shipped kernel at
  (16, 4, 512, 512) in float32.

Variants are written under ``pytv4d_tpu_torch/_build/variants/``
(git-ignored), restricted to the hybrid tables.  A time is the mean of 50
launches between two CUDA events, best of 5; in the norms and dual parts
each kernel is timed twice, the variants in order and then in reverse.
Every variant's outputs but the anatomy part's must equal the shipped
kernel's bit for bit.  The
last line is the card's name and power limit.
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

SOURCES = ("tgv_stream", "tgv_resident", "tgv_onchip", "resident",
           "resident_onchip", "cp_zstream", "cp_boundary", "specialised",
           "specialised_tv", "specialised_cp")
SPECIALISED = ("specialised", "specialised_tv")
# kernel id by the name of its template
KINDS = {"cp_dual_spec": "B1", "cp_primal_spec": "B2",
         "tv_subgrad_spec": "B4",
         "tv_norms_spec": "B3", "tv_dual_spec": "B5"}
WIDTHS = ((2, 2), (4, 1), (2, 1), (4, 2), (4, 4))  # (VEC, RPT), shipped first
SHAPE = (32, 8, 256, 256)
OUT = os.path.join(build.BUILD_DIR, "variants")
DEV = torch.device("cuda", 0)

def edit(path, pattern, repl):
    with open(path) as f:
        text = f.read()
    new, n = re.subn(pattern, repl, text, flags=re.S)
    if n == 0:
        raise RuntimeError(f"{path}: no match for {pattern!r}")
    with open(path, "w") as f:
        f.write(new)


def variant(name, hybrid_only=True, edits=(), source="specialised.cu"):
    """A copy of csrc/ with ``edits`` (pattern, replacement) applied to
    ``source``; with ``hybrid_only`` it instantiates the hybrid tables
    alone."""
    d = os.path.join(OUT, name)
    shutil.copytree(build.CSRC, d)
    if hybrid_only:
        edit(os.path.join(d, "tables.cuh"),
             r"(#define CHANNEL_TABLES\(X\)).*?CENTRAL_FWD_TABLES\(X\)",
             r"\1 HYBRID_TABLES(X)")
        # the check that each table of TABLES_WITH_Z has a z channel reads
        # tables the variant leaves out
        edit(os.path.join(d, "tables.cuh"),
             r"\nTABLES_WITH_Z\(TABLE_HAS_Z\)\n", "\n")
    for pattern, repl in edits:
        edit(os.path.join(d, source), pattern, repl)
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
        name = entry.split("'")[0]
        kind = next((k for t, k in KINDS.items() if t in name), "other")
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
    rounds = (("shipped flags", True),
              ("the specialised sources without -split-compile", False))
    for i, (what, split) in enumerate(rounds):
        d = variant(f"build{i}", hybrid_only=False)
        jobs = [(os.path.join(d, f"{s}.cu"),
                 build.nvcc_flags(s) if split or s not in SPECIALISED
                 else build.NVCC_FLAGS) for s in SOURCES]
        t0 = time.perf_counter()
        with concurrent.futures.ThreadPoolExecutor(len(jobs)) as pool:
            done = dict(zip(SOURCES, pool.map(lambda j: compile_(*j), jobs)))
        wall = time.perf_counter() - t0
        print(f"[build, {what}] {len(jobs)} sources in parallel {wall:.1f} s;"
              + ";".join(f" {s}.cu {done[s][0]:.1f} s, "
                         f"{report(done[s][2], done[s][3])}"
                         for s in SPECIALISED), flush=True)


def bind(path, name="specialised"):
    lib = ctypes.CDLL(path)
    ptr, cint = ctypes.c_void_p, ctypes.c_int
    pp = ctypes.POINTER(fused._Params)
    prefix, _, launches = fused._ENTRY_POINTS[name]
    for fn_name, (n_int, n_ptr) in launches.items():
        getattr(lib, fn_name).argtypes = ([pp] + [cint] * n_int
                                          + [ptr] * (n_ptr + 1))
        count = fused._num_parts_name(lib, prefix, fn_name)
        if hasattr(lib, count):
            getattr(lib, count).restype = ctypes.c_longlong
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
                                     "typedef int64_t Offset;")],
                source="specialised.cuh")
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


def _const(name, value):
    return (rf"constexpr int {name} = [^;]+;", f"constexpr int {name} = {value};")


# B3's variants: (label, edits of specialised_tv.cu); the shipped source is
# timed beside them from its own library
NORMS_VARIANTS = (
    ("no march", (_const("MARCH", -1),)),
    ("march along z", (_const("MARCH", "AX_Z"),)),
    ("AHEAD 2", (_const("AHEAD", 2),)),
    ("AHEAD 4", (_const("AHEAD", 4),)),
    ("64 x 8 tile", (_const("NORMS_TR", 8),)),
    ("64 x 32 tile", (_const("NORMS_TR", 32),)),
    ("32 x 16 tile", (_const("NORMS_TC", 32),)),
    ("min 3 blocks", (_const("NORMS_MIN_BLOCKS", 3),)),
)
DUAL_VARIANTS = (("VEC_TV 4", (_const("VEC_TV", 4),)),)
# B3 with parts of its work cut out, to see what its time is made of (the
# norms then differ from the shipped kernel's: not checked)
_NO_COMPUTE = (r"spec_d<T>\(p, pos, len, tof\(cur\.x\[i\]\[cx\]\), xm, xp, "
               r"tm\[j\], d\);\n      float n;\n      part \+= spec_norm<T>\(p, d, n\);",
               "float n = tof(cur.x[i][cx]) + xm[0] + xp[0] + xm[1] + xp[1] + "
               "xm[2] + xp[2] + xm[3] + xp[3];\n      part += n;")
_NO_STORE = (r"nz\[q\[j\]\] = n;", "if (n == 1234.5f) nz[q[j]] = n;")
_NO_ACROSS = (r"if constexpr \(ACROSS >= 0\) \{\n      constexpr unsigned NB",
              "if constexpr (ACROSS >= 100) {\n      constexpr unsigned NB")
ANATOMY_VARIANTS = (
    ("no norm arithmetic", (_NO_COMPUTE,)),
    ("no store", (_NO_STORE,)),
    ("no across copies", (_NO_ACROSS,)),
    ("no arithmetic, no store", (_NO_COMPUTE, _NO_STORE)),
    ("copies alone", (_NO_COMPUTE, _NO_STORE, _NO_ACROSS)),
)


def build_variants(tag, variants):
    """Compile each variant of specialised_tv.cu (hybrid tables), all at
    once; {label: library}, the shipped one first."""
    def make(item):
        i, (label, edits) = item
        d = variant(f"{tag}{i}", edits=edits, source="specialised_tv.cu")
        return label, compile_(os.path.join(d, "specialised_tv.cu"),
                               build.nvcc_flags("specialised_tv"))
    with concurrent.futures.ThreadPoolExecutor(len(variants)) as pool:
        built = list(pool.map(make, enumerate(variants)))
    libs = {"shipped": fused._lib("specialised_tv")}
    for label, (sec, so, regs, spills) in built:
        print(f"[{tag}, build] {label}: nvcc {sec:.1f} s, "
              f"{report(regs, spills)}", flush=True)
        libs[label] = bind(so, "specialised_tv")
    return libs


def timed_in_turns(runs):
    """{label: ms}: each run timed in order, then in reverse; "a / b"."""
    first = {k: launch_ms(f) for k, f in runs.items()}
    second = {k: launch_ms(runs[k]) for k in reversed(list(runs))}
    return {k: f"{first[k]:.4f} / {second[k]:.4f}" for k in runs}


def part_norms():
    libs = build_variants("norms", NORMS_VARIANTS)
    f32, bf16 = torch.float32, torch.bfloat16
    stream = torch.cuda.current_stream(DEV).cuda_stream
    for shape, norm, x_dt in ((SHAPE, "iso", f32), (SHAPE, "iso", bf16),
                              (SHAPE, "aniso", f32),
                              ((16, 4, 512, 512), "iso", f32)):
        cfg = TVConfig(scheme="hybrid", reg_time=0.5, norm=norm)
        tid = tables.table_id(cfg, *shape[:2])
        p = fused._params(cfg, shape, False)
        gen = torch.Generator(device=DEV).manual_seed(0)
        x = torch.rand(shape, generator=gen, device=DEV).to(x_dt)
        runs, ref = {}, None
        for label, lib in libs.items():
            norms = torch.empty(shape, device=DEV)
            parts = torch.empty(lib.spectv_norms_num_parts(*shape),
                                device=DEV)

            def run(lib=lib, norms=norms, parts=parts):
                code = lib.spectv_norms_launch(
                    ctypes.byref(p), tid, int(x_dt == bf16), x.data_ptr(),
                    None, norms.data_ptr(), parts.data_ptr(), stream)
                assert code == 0, code

            run()
            torch.cuda.synchronize()
            tv = float(parts.double().sum())
            ref = ref or (norms, tv)
            if not (torch.equal(norms, ref[0])
                    and abs(tv - ref[1]) <= 1e-6 * abs(ref[1])):
                raise RuntimeError(f"B3 {label}: outputs differ from the "
                                   f"shipped kernel's")
            runs[label] = run
        print(f"[norms, ms per launch, {norm} x {str(x_dt)[6:]} {shape}] "
              + "; ".join(f"{k} {v}" for k, v in timed_in_turns(runs).items())
              + "; norms bit-equal", flush=True)
        torch.cuda.empty_cache()


def part_dual():
    libs = build_variants("dual", DUAL_VARIANTS)
    f32, bf16 = torch.float32, torch.bfloat16
    stream = torch.cuda.current_stream(DEV).cuda_stream
    for shape, x_dt, d_dt in ((SHAPE, f32, f32), (SHAPE, f32, bf16),
                              (SHAPE, bf16, bf16),
                              ((16, 4, 512, 512), f32, f32)):
        cfg = TVConfig(scheme="hybrid", reg_time=0.5)
        tid = tables.table_id(cfg, *shape[:2])
        p = fused._params(cfg, shape, False, sigma_D=0.5, reg=0.5)
        gen = torch.Generator(device=DEV).manual_seed(0)
        x = torch.rand(shape, generator=gen, device=DEV).to(x_dt)
        y0 = torch.rand((*shape[:2], 8, *shape[2:]), generator=gen,
                        device=DEV).to(d_dt)
        runs, ref = {}, None
        for label, lib in libs.items():
            y = y0.clone()
            parts = torch.empty(lib.spectv_dual_num_parts(*shape),
                                device=DEV)

            def run(lib=lib, y=y, parts=parts):
                code = lib.spectv_dual_launch(
                    ctypes.byref(p), tid, int(x_dt == bf16),
                    int(d_dt == bf16), x.data_ptr(), y.data_ptr(),
                    parts.data_ptr(), stream)
                assert code == 0, code

            run()
            torch.cuda.synchronize()
            ref = ref if ref is not None else y.clone()
            if not torch.equal(y, ref):
                raise RuntimeError(f"B5 {label}: y_D' differs from the "
                                   f"shipped kernel's")
            runs[label] = run
        print(f"[dual, ms per launch, x {str(x_dt)[6:]} dual "
              f"{str(d_dt)[6:]} {shape}] "
              + "; ".join(f"{k} {v}" for k, v in timed_in_turns(runs).items())
              + "; y_D' bit-equal", flush=True)
        del y0, runs
        torch.cuda.empty_cache()


def part_anatomy():
    libs = build_variants("anatomy", ANATOMY_VARIANTS)
    stream = torch.cuda.current_stream(DEV).cuda_stream
    for x_dt in (torch.float32, torch.bfloat16):
        cfg = TVConfig(scheme="hybrid", reg_time=0.5)
        tid = tables.table_id(cfg, *SHAPE[:2])
        p = fused._params(cfg, SHAPE, False)
        gen = torch.Generator(device=DEV).manual_seed(0)
        x = torch.rand(SHAPE, generator=gen, device=DEV).to(x_dt)
        runs = {}
        for label, lib in libs.items():
            norms = torch.empty(SHAPE, device=DEV)
            parts = torch.empty(lib.spectv_norms_num_parts(*SHAPE),
                                device=DEV)

            def run(lib=lib, norms=norms, parts=parts):
                code = lib.spectv_norms_launch(
                    ctypes.byref(p), tid, int(x_dt == torch.bfloat16),
                    x.data_ptr(), None, norms.data_ptr(), parts.data_ptr(),
                    stream)
                assert code == 0, code

            runs[label] = run
        print(f"[anatomy, ms per launch, iso x {str(x_dt)[6:]} {SHAPE}] "
              + "; ".join(f"{k} {v}" for k, v in timed_in_turns(runs).items()),
              flush=True)


def part_primal():
    def make(vec):
        d = variant(f"primal_vec{vec}", edits=[(
            r"constexpr int VEC_B = \d+;", f"constexpr int VEC_B = {vec};")])
        return vec, compile_(os.path.join(d, "specialised.cu"),
                             build.nvcc_flags("specialised"))

    with concurrent.futures.ThreadPoolExecutor(4) as pool:
        # the shipped libraries (B3's for the cases' norms) beside them
        shipped = [pool.submit(build.build, n)
                   for n in ("specialised", "specialised_tv")]
        built = list(pool.map(make, (2, 4)))
        for job in shipped:
            job.result()
    libs = {"shipped": fused._lib("specialised")}
    for vec, (sec, so, regs, spills) in built:
        print(f"[primal, build] VEC_B {vec}: nvcc {sec:.1f} s, "
              f"{report(regs, spills)}", flush=True)
        libs[f"VEC_B {vec}"] = bind(so)
    f32, bf16 = torch.float32, torch.bfloat16
    stream = torch.cuda.current_stream(DEV).cuda_stream
    for shape, x_dt, d_dt, labels in (
            (SHAPE, f32, f32, libs), (SHAPE, f32, bf16, libs),
            (SHAPE, bf16, f32, libs), (SHAPE, bf16, bf16, libs),
            ((16, 4, 512, 512), f32, f32, ("shipped",))):
        case = Case(shape, "iso", x_dt, d_dt)
        runs, ref = {}, None
        for label in labels:
            lib = libs[label]
            out = torch.empty_like(case.x)
            parts = torch.empty(lib.spec_cp_primal_num_parts(*shape),
                                device=DEV)

            def run(lib=lib, out=out, parts=parts):
                code = lib.spec_cp_primal_launch(
                    ctypes.byref(case.p), case.tid, *case.flags,
                    case.x.data_ptr(), case.x0.data_ptr(),
                    case.y_A.data_ptr(), case.y_D.data_ptr(), None,
                    out.data_ptr(), parts.data_ptr(), stream)
                assert code == 0, code

            run()
            torch.cuda.synchronize()
            ref = ref if ref is not None else out.clone()
            if not torch.equal(out, ref):
                raise RuntimeError(f"B2 {label}: x' differs from the "
                                   f"shipped kernel's")
            runs[label] = run
        print(f"[primal, ms per launch, {case.title()}] "
              + "; ".join(f"{k} {v}" for k, v in timed_in_turns(runs).items())
              + "; x' bit-equal", flush=True)
        del case, runs
        torch.cuda.empty_cache()


PARTS = {"build": part_build, "offsets": part_offsets,
         "widths": part_widths, "norms": part_norms, "dual": part_dual,
         "anatomy": part_anatomy, "primal": part_primal}


def main():
    shutil.rmtree(OUT, ignore_errors=True)
    for name in sys.argv[1:] or PARTS:
        PARTS[name]()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip())


if __name__ == "__main__":
    main()
