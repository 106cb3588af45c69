"""What launch shape the whole-solve CP / GD kernels (B9) should take, and
what synchronisation floor each design has: an A/B on one GPU.

    python3 tools/torch_probe_resident.py [launch] [sync] [variants]

``sync`` (the floors, ~20 s), ``launch`` (the L2 kernel's launch shapes,
~60 s) and ``variants`` (the on-chip B9's block size and B10's band height
and occupancy, ~2 min); ``sync`` and ``launch`` without an argument.

The floors.  The L2 kernel (``csrc/resident.cu``) with its passes emptied
-- its voxel loops run no voxel, so what is left is the two grid barriers
an iteration behind their ``__threadfence()``, and the block sums -- at its
shipped launch shape, at cameraman and at the coupled (4, 2, 64, 64)
hybrid ``reg_time=0.5`` volume: ms per iteration between a 50- and a
300-iteration solve, best of 3; the floor that design cannot go below.
Then the exchange of the on-chip design's candidates
(``tools/torch_probe_resident_sync.cu``: flagged 64-bit words polled in
place, a release/acquire pass counter per block, one thread-block cluster
with DSMEM) at the on-chip launch's block count and edge size at both
shapes, ms per iteration the same way; and the byte floor of the
z-marching pass A (B10) at (32, 8, 256, 256) f32 hybrid ``reg_time=0.5``
(a march that moves pass A's bytes with no arithmetic) beside pass A as
the tree launches it (B1, ``fused.cp_dual``) and B10, per launch, best of 5.

The launch shapes.  Builds ``csrc/resident.cu`` (and the per-launch kernels
it is compared with) and prints what ptxas reports.  Then, with the L2
kernel launched (``kernels.resident.solve_l2``), at (1, 1, 256, 256), at the
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
LIBS = ("resident", "specialised")
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


def rewrite_variant(csrc, tag, name, edits):
    """A copy of ``csrc`` under ``_build/probe_<tag>/`` whose ``<name>.cu``
    has each (old, new) of ``edits`` replaced (old must occur); returns its
    directory."""
    out = os.path.join(build.BUILD_DIR, f"probe_{tag}")
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(csrc, out)
    if not edits:
        return out
    path = os.path.join(out, f"{name}.cu")
    with open(path) as f:
        text = f.read()
    for old, new in edits:
        if old not in text:
            raise RuntimeError(f"{name}.cu no longer has {old!r}")
        text = text.replace(old, new)
    with open(path, "w") as f:
        f.write(text)
    return out


def b9_kernel(variant, solver, cfg, x0, state, n, kw):
    """One launch of the named B9 kernel ("onchip": ``resident.solve_onchip``,
    "l2": ``resident.solve_l2``) for ``n`` iterations on copies of the start
    ``state`` (CP: x, y_A, y_D in the public layout; GD: x); returns the
    end state (CP's y_D in the internal layout; GD's two x buffers)."""
    kernel = (resident.solve_onchip if variant == "onchip"
              else resident.solve_l2)
    p = resident.solver_params(solver, cfg, tuple(x0.shape), **kw)
    if solver == "cp":
        x, y_A, y_D = state
        st = (x.clone(), y_A.clone(), fused.to_internal_layout(y_D))
    else:
        st = (state[0].clone(), torch.empty_like(state[0]))
    kernel(solver, cfg, x0, p, n, st)
    return st


def marginal_ms(run):
    """ms per iteration of ``run(n_iter)`` between 50 and 300 iterations."""
    return (best_ms(lambda: run(300)) - best_ms(lambda: run(50))) / 250


def empty_pass_floor(shape, cfg):
    """ms per iteration of the L2 kernel (``csrc/resident.cu``) with its
    passes emptied, CP and GD, at its shipped launch shape for ``shape``:
    ``(cp, gd, blocks, threads)``."""
    csrc = build.CSRC
    try:
        build.CSRC = rewrite_variant(csrc, "empty", "resident", [(
            "for (int vid = first; vid < vol; vid += step)",
            "for (int vid = vol; vid < vol; vid += step)")])
        fused._lib.cache_clear()
        gen = torch.Generator(device=DEV).manual_seed(3)
        x0, x, y_A, y_D = cp_inputs(shape, cfg, gen)
        blocks, threads = resident._launch_shape(x0, x0.numel())
        kw = dict(reg=25.0, sigma_D=0.5, sigma_A=1.0, tau=0.1)
        gkw = dict(reg=25.0, step_size=5e-3)
        cp = marginal_ms(lambda n: b9_kernel("l2", "cp", cfg, x0,
                                             (x, y_A, y_D), n, kw))
        gd = marginal_ms(lambda n: b9_kernel("l2", "gd", cfg, x0, (x,), n,
                                             gkw))
    finally:
        build.CSRC = csrc
        fused._lib.cache_clear()
    return cp, gd, blocks, threads


def sync_library():
    """The probe kernels of ``tools/torch_probe_resident_sync.cu``, built
    beside csrc/'s headers and bound."""
    import ctypes

    out = rewrite_variant(build.CSRC, "sync", None, [])
    shutil.copy(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "torch_probe_resident_sync.cu"),
                os.path.join(out, "probe_sync.cu"))
    text = build_variant(out, "probe_sync")
    regs = re.findall(r"Used (\d+) registers", text)
    log(f"[build] probe_sync: registers {regs}")
    lib = ctypes.CDLL(build._library_path(os.path.join(out,
                                                       "probe_sync.cu")))
    c_int, ptr = ctypes.c_int, ctypes.c_void_p
    lib.probe_ll.argtypes = [c_int] * 3 + [ptr] * 3
    lib.probe_counter.argtypes = [c_int] * 3 + [ptr] * 4
    lib.probe_cluster.argtypes = [c_int] * 4 + [ptr] * 2
    lib.probe_zmarch.argtypes = [c_int] * 6 + [ptr] * 5
    lib.probe_error_string.restype = ctypes.c_char_p
    return lib


def _check(lib, code, what):
    if code:
        raise RuntimeError(f"{what}: {lib.probe_error_string(code).decode()}")


def exchange_floors(lib, blocks, E):
    """ms per iteration (two exchanges) of the three candidates at
    ``blocks`` blocks and ``E`` edge words a side: ``{name: ms}``."""
    stream = torch.cuda.current_stream(DEV).cuda_stream

    def ll(n):
        exch = torch.zeros(blocks * 4 * E, dtype=torch.int64, device=DEV)
        parts = torch.empty(n * blocks, device=DEV)
        _check(lib, lib.probe_ll(blocks, n, E, exch.data_ptr(),
                                 parts.data_ptr(), stream), "probe_ll")

    def counter(n):
        exch = torch.zeros(blocks * 2 * E, device=DEV)
        cnt = torch.zeros(blocks, dtype=torch.int32, device=DEV)
        parts = torch.empty(n * blocks, device=DEV)
        _check(lib, lib.probe_counter(blocks, n, E, exch.data_ptr(),
                                      cnt.data_ptr(), parts.data_ptr(),
                                      stream), "probe_counter")

    def cluster(n, C=16):
        # at most 7 clusters of 16 are resident at once (PERF.md, B7)
        nb = min(blocks, 7 * C)
        parts = torch.empty(n * nb, device=DEV)
        _check(lib, lib.probe_cluster(nb, C, n, E, parts.data_ptr(),
                                      stream), "probe_cluster")

    return {"flagged words": marginal_ms(ll),
            "pass counter": marginal_ms(counter),
            "clusters of 16 (<= 7 of them)": marginal_ms(cluster)}


def sync_floors():
    """The floors of the module docstring."""
    cases = [((1, 1, 256, 256), TVConfig()),
             ((4, 2, 64, 64), TVConfig(scheme="hybrid", reg_time=0.5))]
    for shape, cfg in cases:
        cp, gd, blocks, threads = empty_pass_floor(shape, cfg)
        log(f"[B9 floor, L2 kernel with empty passes] {shape}: {blocks} "
            f"blocks x {threads} threads, CP {cp:.5f} ms/it, GD {gd:.5f} "
            f"ms/it (two grid barriers and two block sums an iteration)")
    lib = sync_library()
    # (blocks, edge words a side): a band of 2 rows of one 256-wide plane;
    # 1 row of 8 planes 64 wide
    for shape, blocks, E in (((1, 1, 256, 256), 128, 256),
                             ((4, 2, 64, 64), 64, 512)):
        floors = exchange_floors(lib, blocks, E)
        log(f"[B9 floor, on-chip exchange] {shape}: {blocks} blocks x 512 "
            f"threads, {E} edge words a side, ms per iteration (two "
            f"exchanges): " + ", ".join(f"{k} {v:.5f}"
                                        for k, v in floors.items()))

    # B10's byte floor beside B1 and B10
    shape, cfg = (32, 8, 256, 256), TVConfig(scheme="hybrid", reg_time=0.5)
    gen = torch.Generator(device=DEV).manual_seed(3)
    x0, x, y_A, y_D = cp_inputs(shape, cfg, gen)
    Nd = y_D.shape[1]
    y_int = fused.to_internal_layout(y_D)
    del y_D
    dk = dict(cfg=cfg, sigma_D=0.5, sigma_A=1.0, reg=1.0)
    from pytv4d_tpu_torch.kernels import zstream

    stream = torch.cuda.current_stream(DEV).cuda_stream
    floors = {R: launch_ms(lambda: _check(lib, lib.probe_zmarch(
        *shape, Nd, R, x.data_ptr(), x0.data_ptr(), y_A.data_ptr(),
        y_int.data_ptr(), stream), "probe_zmarch")) for R in (2, 4, 8, 16)}
    b1 = launch_ms(lambda: fused.cp_dual(x, x0, y_A, y_int, **dk))
    b10 = launch_ms(lambda: zstream.cp_dual_zstream(x, x0, y_A, y_int, **dk))
    log(f"[B10 floor] {shape} f32 hybrid reg_time=0.5 (Nd={Nd}), ms per "
        f"launch: z-march moving pass A's bytes, no arithmetic, R rows a "
        f"band: " + ", ".join(f"R={R} {v:.4f}" for R, v in floors.items())
        + f"; B1 {b1:.4f}; B10 {b10:.4f}")


def launch_ms(fn, n=50, repeats=5):
    """ms per call of ``fn``: the mean of n calls between two CUDA events,
    best of ``repeats``."""
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


def build_variant(directory, name):
    """Build ``<directory>/<name>.cu`` as kernels/build.py builds a source
    (the same flags, the key of its own text); returns ptxas's log."""
    source = os.path.join(directory, f"{name}.cu")
    out = build._library_path(source)
    if not os.path.isfile(out):
        proc = subprocess.run([build.find_nvcc(), *build.nvcc_flags(name),
                               "-o", out, source], capture_output=True,
                              text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
        with open(out + ".log", "w") as f:
            f.write(proc.stdout + proc.stderr)
    with open(out + ".log") as f:
        return f.read()


def ptxas_summary(text, kernel):
    regs, spills = [], []
    for entry in re.split(r"Compiling entry function '", text)[1:]:
        if kernel not in entry.split("'")[0]:
            continue
        used = re.search(r"Used (\d+) registers", entry)
        spill = re.search(r"(\d+) bytes spill stores", entry)
        if used:
            regs.append(int(used.group(1)))
            spills.append(int(spill.group(1)) if spill else 0)
    return (f"{min(regs)}-{max(regs)} registers, spill stores <= "
            f"{max(spills)} B")


def variants():
    """B10 as shipped against an occupancy floor of 4 blocks an SM and
    bands of 1 and 4 rows; the on-chip B9 in blocks of 256, 512 (shipped)
    and 1024 threads.  Each variant is a rewritten copy of csrc/ built in
    parallel; times in turns on the card."""
    import hashlib

    csrc = build.CSRC
    zs = [("shipped", []),
          ("4 blocks an SM", [("__launch_bounds__(BLOCK)",
                               "__launch_bounds__(BLOCK, 4)")]),
          ("bands of 1 row", [("constexpr int ZROWS = 2;",
                               "constexpr int ZROWS = 1;")]),
          ("bands of 4 rows", [("constexpr int ZROWS = 2;",
                                "constexpr int ZROWS = 4;")])]
    rs = [("512 threads (shipped)", []),
          ("256 threads", [("#define RESO_THREADS 512",
                            "#define RESO_THREADS 256")]),
          ("1024 threads", [("#define RESO_THREADS 512",
                             "#define RESO_THREADS 1024")])]
    dirs = {("cp_zstream", tag): rewrite_variant(csrc, f"zs{i}", "cp_zstream",
                                                 edits)
            for i, (tag, edits) in enumerate(zs)}
    dirs.update({("resident_onchip", tag): rewrite_variant(
        csrc, f"reso{i}", "resident_onchip", edits)
        for i, (tag, edits) in enumerate(rs)})
    with concurrent.futures.ThreadPoolExecutor(len(dirs)) as pool:
        logs = dict(zip(dirs, pool.map(lambda k: build_variant(dirs[k], k[0]),
                                       dirs)))
    for (name, tag), text in logs.items():
        kernel = "zstream_spec_kernel" if name == "cp_zstream" else "reso_"
        log(f"[variant build] {name} {tag}: {ptxas_summary(text, kernel)}")

    def use(key):
        build.CSRC = dirs[key]
        fused._lib.cache_clear()
        # the bound partial counter belongs to the library it came from: a
        # band height of its own counts its own blocks
        fused._num_parts.cache_clear()

    def digest(*ts):
        h = hashlib.sha256()
        for t in ts:
            h.update(t.contiguous().view(torch.uint8).cpu().numpy().tobytes())
        return h.hexdigest()[:12]

    from pytv4d_tpu_torch.kernels import zstream

    shape, cfg = (32, 8, 256, 256), TVConfig(scheme="hybrid", reg_time=0.5)
    dk = dict(cfg=cfg, sigma_D=0.5, sigma_A=1.0, reg=1.0)
    for x_dt, d_dt in ((torch.float32, torch.float32),
                       (torch.float32, torch.bfloat16),
                       (torch.bfloat16, torch.bfloat16)):
        gen = torch.Generator(device=DEV).manual_seed(3)
        x0, x, y_A, y_D = cp_inputs(shape, cfg, gen)
        x0, x, y_A = (t.to(x_dt) for t in (x0, x, y_A))
        y_D = fused.to_internal_layout(y_D).to(d_dt)
        start = (y_A.clone(), y_D.clone())  # the timed launches update y
        ref = [t.clone() for t in start]
        build.CSRC = csrc
        fused._lib.cache_clear()
        fused._num_parts.cache_clear()
        fused.cp_dual(x, x0, *ref, **dk)
        times = {"B1": launch_ms(lambda: fused.cp_dual(x, x0, y_A, y_D,
                                                       **dk))}
        order = [t for t, _ in zs] + [t for t, _ in zs][::-1]
        for tag in order:
            use(("cp_zstream", tag))
            got = [t.clone() for t in start]
            zstream.cp_dual_zstream(x, x0, *got, **dk)
            same = digest(*got) == digest(*ref)
            ms = launch_ms(lambda: zstream.cp_dual_zstream(x, x0, y_A, y_D,
                                                           **dk))
            times[tag] = min(times.get(tag, ms), ms)
            if not same:
                diff = [(int((g != r).sum()),
                         float((g.float() - r.float()).abs().max()))
                        for g, r in zip(got, ref)]
                log(f"[B10 variant] {tag}: NOT bit-equal to B1 (elements "
                    f"that differ, max abs difference: y_A {diff[0]}, y_D "
                    f"{diff[1]})")
            else:
                log(f"[B10 variant] {tag}: y_A', y_D' bit-equal to B1's "
                    f"({digest(*got)})")
        log(f"[B10 variants] {shape} {x_dt} x, {d_dt} dual, ms per launch "
            f"(best of two turns): " + ", ".join(
                f"{k} {v:.4f}" for k, v in times.items()))
        del x0, x, y_A, y_D, ref, start
    for shape, cfg in (((1, 1, 256, 256), TVConfig()),
                       ((4, 2, 64, 64), TVConfig(scheme="hybrid",
                                                 reg_time=0.5))):
        gen = torch.Generator(device=DEV).manual_seed(3)
        x0, x, y_A, y_D = cp_inputs(shape, cfg, gen)
        kw = dict(reg=25.0, sigma_D=0.5, sigma_A=1.0, tau=0.1)
        gkw = dict(reg=25.0, step_size=5e-3)
        out = {}
        for tag in [t for t, _ in rs] + [t for t, _ in rs][::-1]:
            use(("resident_onchip", tag))
            cp = marginal_ms(lambda n: b9_kernel("onchip", "cp", cfg, x0,
                                                 (x, y_A, y_D), n, kw))
            gd = marginal_ms(lambda n: b9_kernel("onchip", "gd", cfg, x0,
                                                 (x,), n, gkw))
            a, b = out.get(tag, (cp, gd))
            out[tag] = (min(a, cp), min(b, gd))
        log(f"[B9 variants] {shape} on chip, ms per iteration CP / GD: "
            + ", ".join(f"{k} {v[0]:.5f} / {v[1]:.5f}"
                        for k, v in out.items()))
    build.CSRC = csrc
    fused._lib.cache_clear()
    fused._num_parts.cache_clear()


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
                    return b9_kernel("l2", "cp", cfg, x0, (x, y_A, y_D), n,
                                     kw)

                def gd(n):
                    return b9_kernel("l2", "gd", cfg, x0, (x,), n,
                                     dict(reg=25.0, step_size=5e-3))

                out = cp(50)
                if first is None:
                    first = out
                same = all(torch.equal(a, b) for a, b in zip(out, first))
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
    args = set(sys.argv[1:]) or {"launch", "sync"}
    do_build()
    if "sync" in args:
        sync_floors()
    if "variants" in args:
        variants()
    if "launch" in args:
        time_resident()


if __name__ == "__main__":
    main()
