"""End-to-end check of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CP kernels (B1 pass A, B5 pass A for inverse problems, B2 pass
B, B10 pass A marching along z, B8 the sharded step's two boundary
kernels), the TV kernels (B3 norms, B4 subgradient),
the whole-solve CP and GD kernels (B9: on chip, and in L2 for larger
volumes) and the TGV-2 kernels (B6 passes PQ
and XW, B7 whole solve: on chip, and in L2 for larger slices)
from ``pytv4d_tpu_torch/csrc``, one nvcc per source, all at once; B1 to B5
on an unsharded volume and on a shard (B1 and B2 in both sharded modes, B3,
B4 and B5 in their halo mode) and B8 are the kernels specialised per
channel table (``csrc/specialised.cu`` for B1, B2 and B4,
``csrc/specialised_tv.cu`` for B3 and B5, ``csrc/specialised_cp.cu`` for
B1 and B2 on a shard, ``csrc/cp_boundary.cu`` for B8: four sources whose
compiles nvcc spreads over the cores).
Then, for
the Chambolle-Pock path (phases 3-7): holds B1/B2 against
their plain PyTorch versions (both also bit for bit against their halo-mode
instances on a 1 x 1 grid, over every channel table, at odd widths and off
alignment), drives
``TVDenoiser.cp`` on the cameraman
image through them, replays the (16, 4, 512, 512) reference trajectory,
measures the 4D CP rate of kernels and plain versions and B1's and B2's
time per launch in each storage pair beside its bound, and runs the
(96, 16, 512, 512) volume.  For the subgradient-descent path (phases 8-11):
holds B3/B4 against their plain versions (both also bit for bit against
their halo-mode instances on a 1 x 1 grid, over every channel table),
drives
``TVDenoiser.gd`` on the
cameraman image and the reference's ``tv_GPU.tv_hybrid`` through them,
measures the 4D GD rate, the split of an iteration and the kernels' GB/s,
and runs the (96, 16, 512, 512) volume.  For the TGV-2 path (phases 12-15):
holds B6/B7 against their plain versions (B7's on-chip kernel also bit for
bit against its L2 kernel, and a launch the card refuses must raise) and
B6's objective kernel against ``tgv_objective`` in float64,
drives ``TVDenoiser.tgv`` on the
cameraman image from a numpy array (it must land on the card, in one
on-chip B7 launch), a 4d ``tgv_denoise`` through B6 and the users' 4d
``TVDenoiser.tgv`` with its per-iteration loss (B6 and the objective
kernel every iteration), measures the
whole-solve kernels against each other and the streaming rates, where one
overtakes the other, the B7 bounds and how many B7 clusters the card holds
at once, and runs the (96, 16, 512, 512) volume in the 4d mode.  For the
inverse solver and
parallel-beam CT (phases 16-19): holds B5 (pass A for inverse problems)
against its plain version on the other kernels' case grid, and bit for bit
against B1 in halo mode over every channel table, and B2 writing
out of place against its plain version, both (and B3, in phase 8) also at
the two shapes the CT path launches them on; solves a deblurring problem with
``cp_inverse`` on the kernels and on the plain step, and reconstructs a
seeded phantom with ``cp_reconstruct`` from numpy inputs (it must land on
the card, with one B5 and one B2 launch per iteration and one B3 per sampled
loss); runs the (16, 4, 512, 512) x 96-angle reconstruction on the kernels,
on the plain step and with a bf16 dual, holds the two final states against
each other, and splits the iteration into the
projector, its adjoint and the kernels; and runs three iterations at
(96, 16, 512, 512) x 96 angles for the memory it takes.  For the whole-solve
CP / GD kernels and the z-marching pass A (phases 20-23): holds B9 (CP and
GD) against its plain loops over four shapes, the four schemes and the three
norms, six more shapes that reach every channel table, and solves of one and
two iterations, with the kernel ``resident_variant`` names (on chip wherever
the bands fit, in L2 at two larger volumes) and each on-chip state bit for
bit against the L2 kernel's; solves the cameraman image from a numpy array with
``make_resident_cp_solver`` and ``make_resident_gd_solver``, each in ONE
on-chip launch with no per-launch kernel running, against the reference
losses and the host-loop solvers, with the L2 kernel's times and the
synchronisation floors of ``tools/torch_probe_resident.py`` beside them;
holds B10 against its plain version and bit for bit against B1 (over its
nine tables and four storage pairs too),
runs a 20-iteration (32, 8, 256, 256) CP solve on B10 + B2 against the same
solve on B1 + B2, and times the two pass A's alone and in the step; and runs
``TVDenoiser.admm`` / ``.fista``, ``chambolle_pock_precond``,
``denoise_tv_chambolle`` with ``eps`` and with coupled channels,
``run_until_converged(criterion="gap")`` and a resumed ``run_checkpointed``
on the card from numpy inputs.  For the (z, t)-sharded solvers (phases
24-25): holds B1/B2 in their halo and interior modes, B3/B4 in their halo
mode and the two boundary kernels B8 against their plain versions, shard by
shard, at a small shape and at the sharded path's own shard shape, and in
every case 20 iterations of the overlapped step bit for bit against the
ghost-plane step; B3/B4's halo mode (the per-table kernels' HALO
instances) also over every channel table, both storages and two widths on
a z-cut and a t-cut mesh, each case's gathered norms and G bit for bit
against the unsharded per-table kernels', and per launch at a z-shard and
a (2 x 2) grid's shard of (32, 8, 256, 256) beside its bound; B1/B2 on a
shard (``csrc/specialised_cp.cu``) over every table and storage pair they
are built for, each step (halo mode on a 1 x 1 grid, a z-cut and a t-cut
mesh; interior + B8 on 3 z-shards) bit for bit against the unsharded
kernels on the gathered volume, and each of their four instances per
launch at a z-shard and a (2 x 2) grid's shard, f32 and bf16, beside its
bound; solves
the (32, 8, 256, 256) volume from a numpy array as 4 z-shards on the one
card through ``make_mesh`` / ``shard_volume`` /
``make_sharded_cp_solver_fused`` on the ghost-plane path and on the
overlapped path (whose final state must equal the ghost path's bit for bit,
and both the unsharded solve's), a (2 x 2) mesh with time sharded, the
sharded GD solver, a bf16 case and a 300-iteration run; and times an
iteration of each path beside the unsharded step, splits the ghost and
the overlapped step's device time into B1, B2, B8, copies and the rest,
and times a launch of each B8 kernel (wall, on the device, the host's
share, against its bound).  For
fan- and cone-beam CT (phase 26): holds each geometry's projector pair,
FDK and SART in f32 on the card against float64 on the CPU at a small
shape; then at (16, 4, 512, 512) x 96 angles over a full orbit times the
projection, its adjoint and ``estimate_op_norm``, runs 10 iterations of
``cp_reconstruct(geom=...)`` (one B5, B2 and B3 launch per iteration)
against the plain step, splits an iteration, and times FDK (cone) and two
SART epochs with their peak memory.  For the reference's own entry points
(phase 27): runs ``run_GPU_tests()`` and holds ``tv_GPU`` against
``tv_CPU`` on the README's input.  For the spectral (gather-free) CT path
(phase 28): holds the parallel, fan and cone (order 0 and 1) spectral
pairs, ``fbp`` and ``fdk_spectral`` in f32 on the card against float64 on
the CPU at a small shape, with the f32 adjointness, the two DFT modes
against each other and the matmul precisions; then at (16, 4, 512, 512) x
96 angles times each geometry's spectral pair in both DFT modes beside its
gather pair (which sets ``method='auto'`` on the card), runs
``cp_reconstruct(method='spectral')`` (one B5, B2 and B3 launch per
iteration) with its rate, idle share and peak memory, a resumed solve
against the uninterrupted one, the cone's preconditioner setup,
``fdk_spectral`` and two SART epochs; and three iterations at
(96, 16, 512, 512) for the peak memory.  For the sharded slice (phase
29): solves the 2d TGV problem as 8 shards (one B7 launch each, x and w
bit-equal to the unsharded solve), the 4d one on 4 z-shards on the ghost
and the overlapped path in f32 and bf16 (B6 on every shard; bf16 overlap
bit-equal to ghost) and the 3d one on a (4 x 2) mesh, against the unsharded
stream solve; joins one NCCL rank with ``multihost.initialize`` and runs the
sharded CP on ``global_mesh`` bit for bit against the one-process solve;
and reconstructs a parallel sinogram on a (4 x 2) mesh and a cone one on a
(1 x 4) mesh against the unsharded solve, with times and peak memory.  For
the cone's z-DFT offset-line tier (phase 30): holds its f32 pair on the
card against float64 on the CPU with the dot test at a small shape, times
its A and A_T at (16, 4, 512, 512) x 96 angles beside order 1's with their
peak memory, checks it against exact cone integrals of 3D Gaussians (it
must beat the gather cone), solves with ``cp_inverse`` on the order-2 pair
(one B5 and B2 launch per iteration, one B3 per loss), differentiates a
small solve in ``reg`` on the plain step against a central difference, and
``cp_reconstruct`` / ``tgv_reconstruct`` through the gather pairs, and
runs the six example twins (``examples/torch_*.py --device cuda``).  For
the entry points on a grid (phase 31): hands grids of shards of the
(32, 8, 256, 256) volume to ``chambolle_pock`` (B1, B2, B8),
``subgradient_descent`` and ``tv_and_subgrad`` (B3, B4), ``tgv_denoise``
(B7 in 2d; B6 in 4d on z-shards, with and without the per-iteration
loss; no kernel in 4d on a grid that cuts time), ``admm`` and ``fista`` (no kernel), each against the same call on
the whole volume, and times each beside the direct sharded solver.  For
the CT and remaining solver entry points on a grid (phase 32): holds B5's
halo mode (the halo instance of ``tv_dual_spec_kernel``,
``csrc/specialised_tv.cu``) over every channel table and storage pair on
three grids, each shard's y_D' bit for bit the unsharded B5's on the
gathered volume and within the CP bar of its plain version, and at one of 4
z-shards of the CT cell against its plain version, timed beside its bound
(events and on the device); hands the CT cell's
sinogram as 4 z-shards and a (2 x 2) grid to ``cp_reconstruct`` (one B5,
B2 and B3 launch a shard and iteration, in their halo mode: f32, a bf16
dual, resumed from a whole-volume state, an array ``fidelity_weight``),
times it beside the plain halo path and the whole volume, and runs
``precond`` on the gather pair and the spectral cone cut along t,
``tgv_reconstruct``, ``fdk``, ``fbp``, ``sart``, ``chambolle_pock_precond``,
``run_until_converged``, ``run_checkpointed`` (written on a grid, resumed
on the volume) and the five ``TVDenoiser`` methods on grids, each against
the same call on the whole volume.  For the benchmark harness (phase 33):
runs each function of ``pytv4d_tpu_torch.bench`` at the JAX package's
defaults (``bench_solver`` also with a bf16 dual; the two sweeps over 1, 2
and 4 shards on the one card), requires the JAX harness's keys with every
value finite and positive, and the launches of B1 and B2, B6's two passes
and the CT step's B5, B2 and B3, prints each dict with its launches, peak
memory and seconds, and holds ``bench_ct_production``'s final loss against
a direct ``cp_reconstruct`` of the same seeded inputs.
Every phase raises on failure; nothing falls back to the CPU.  The last line of stdout is one
JSON object with ``"ok": true`` and the device.
"""

from __future__ import annotations

import collections
import concurrent.futures
import contextlib
import dataclasses
import io
import itertools
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

import pytv4d_tpu_torch
from pytv4d_tpu_torch import bench, testing, tv_CPU, tv_GPU
from pytv4d_tpu_torch.core.config import TVConfig
from pytv4d_tpu_torch.core.schemes import (
    AXIS_T,
    AXIS_Z,
    SCHEMES,
    num_channels,
    operator_norm_bound_sq,
    scheme_channels,
)
from pytv4d_tpu_torch.kernels import (
    build,
    fused,
    resident,
    tables,
    tgv_resident,
    tgv_stream,
    zstream,
)
from pytv4d_tpu_torch.kernels.dispatch import t_plane_multiplier
from pytv4d_tpu_torch.models import (
    TVDenoiser,
    add_noise,
    ct,
    ct_spectral,
    denoise_tv_chambolle,
)
from pytv4d_tpu_torch.models.ct import (
    ConeBeamGeometry,
    FanBeamGeometry,
    cone_sinogram_sharding,
    cp_reconstruct,
    estimate_op_norm,
    fbp,
    fdk,
    make_cone_projector,
    make_fan_projector,
    make_projector,
    radon,
    radon_cone,
    radon_fan,
    sart,
    sinogram_sharding,
    tgv_reconstruct,
)
from pytv4d_tpu_torch.models.ct_spectral import (
    fdk_spectral,
    make_cone_spectral_projector,
    make_fan_spectral_projector,
    make_spectral_projector,
    radon_cone_spectral,
)
from pytv4d_tpu_torch.parallel import (
    fused_halo,
    gather_d_volume,
    gather_volume,
    is_grid,
    make_mesh,
    make_sharded_cp_solver_fused,
    make_sharded_gd_solver_fused,
    make_sharded_tgv_stream_solver,
    multihost,
    shard,
    shard_volume,
    tgv_denoise_sharded,
)
from pytv4d_tpu_torch.parallel.mesh import grid_map
from pytv4d_tpu_torch.solvers.admm import admm
from pytv4d_tpu_torch.solvers.cp import (
    CPPrecondState,
    chambolle_pock,
    chambolle_pock_precond,
    default_tau,
    init_state,
    pd_gap,
)
from pytv4d_tpu_torch.solvers.fidelity import fidelity_dual_prox, fidelity_loss
from pytv4d_tpu_torch.solvers.fista import fista
from pytv4d_tpu_torch.solvers.gd import subgradient_descent
from pytv4d_tpu_torch.solvers.inverse import cp_inverse, power_iteration
from pytv4d_tpu_torch.solvers.state import (
    run_checkpointed,
    run_until_converged,
)
from pytv4d_tpu_torch.solvers.tgv import (
    TGV_FIELDS,
    tgv_denoise,
    tgv_objective,
)
from pytv4d_tpu_torch.utils import cameraman, has_real_cameraman, profiling
from pytv4d_tpu_torch.utils.profiling import (
    H100_HBM_PEAK_GBPS,
    cp_traffic_model,
    device_time,
    roofline_fraction,
    tgv_traffic_model,
    time_iterations,
    tv_traffic_model,
)

ROOT = os.path.dirname(os.path.abspath(__file__))
DEV = torch.device("cuda", 0)

CAMERAMAN_LOSS = 38575639.48  # f64 reference, BASELINE.md
CAMERAMAN_GD_LOSS = 39074939.776927  # f64 reference, BASELINE.md
README_TV = 532166.8251801673  # tv_hybrid(rand(20, 4, 100, 100)), seed 0
# TVDenoiser(reg=25).tgv(cameraman + noise, 300): the JAX package in f64 on
# the CPU (tests/test_torch_tgv.py)
CAMERAMAN_TGV_LOSS = 37211904.16116732
LIBS = ("tgv_stream", "tgv_resident", "tgv_onchip", "resident",
        "resident_onchip", "cp_zstream", "cp_boundary", "specialised",
        "specialised_tv", "specialised_cp")
# the kernels specialised per channel table, by kernel id: a pattern of their
# mangled names (phase 2 reports each one's registers and spills); B3, B4
# and B5 in their halo mode, and B1 and B2 on a shard, by their HALO
# template flag, the last argument (B4's next to last: its GD epilogue's
# flag follows it)
SPEC_KERNELS = {"B1": "cp_dual_spec_kernel", "B2": "cp_primal_spec_kernel",
                "B1halo": r"cp_dual_shard_kernel\w*Lb1E",
                "B1int": r"cp_dual_shard_kernel\w*Lb0E",
                "B2halo": r"cp_primal_shard_kernel\w*Lb1E",
                "B2int": r"cp_primal_shard_kernel\w*Lb0E",
                "B4": r"tv_subgrad_spec_kernel\w*Lb0ELb0E",
                "B4halo": r"tv_subgrad_spec_kernel\w*Lb1ELb0E",
                "B4gd": r"tv_subgrad_spec_kernel\w*Lb0ELb1E",
                "B3": r"tv_norms_spec_kernel\w*Lb0E",
                "B3halo": r"tv_norms_spec_kernel\w*Lb1E",
                "B5": r"tv_dual_spec_kernel\w*Lb0E",
                "B5halo": r"tv_dual_spec_kernel\w*Lb1E",
                "B8dual": "bnd_dual_kernel", "B8primal": "bnd_primal_kernel",
                "B9cp": "reso_cp_kernel", "B9gd": "reso_gd_kernel",
                "B10": "zstream_spec_kernel"}
# each kernel's launch counter in utils.profiling.counters(), by kernel id
COUNTERS = {"B1": "launch.B1", "B2": "launch.B2", "B3": "launch.B3",
            "B4": "launch.B4", "B5": "launch.B5",
            # the B4 launches that take the GD step in their epilogue
            "B4gd": "launch.B4_gd",
            "B6pq": "launch.B6.pq", "B6xw": "launch.B6.xw",
            # B6's objective kernel: one launch a loss of a streamed solve
            "B6obj": "launch.B6.obj",
            # B7 on chip, and in L2 (slices too large for the chip)
            "B7": "launch.B7.onchip", "B7l2": "launch.B7.l2",
            "B9cp": "launch.B9.cp", "B9gd": "launch.B9.gd",
            # B9's kernels: on chip, and in L2 (volumes too large for it)
            "B9onchip": "launch.B9.onchip", "B9l2": "launch.B9.l2",
            "B10": "launch.B10",
            "B8dual": "launch.B8.dual", "B8primal": "launch.B8.primal",
            # B1 and B2 in their sharded modes: the launches of one launch
            # function
            "B1halo": "launch.B1/spcp_dual_halo_launch",
            "B1int": "launch.B1/spcp_dual_interior_launch",
            "B2halo": "launch.B2/spcp_primal_halo_launch",
            "B2int": "launch.B2/spcp_primal_interior_launch"}
# data-sheet peaks of the H100 SXM at 700 W: HBM bytes/s (utils.profiling)
# and float32 operations/s outside the tensor cores
H100_F32_PEAK_FLOPS = 67e12
SMALL, MAIN_4D = (4, 3, 16, 128), (32, 8, 256, 256)
CAMERAMAN = (1, 1, 256, 256)  # what the main path launches the kernels on
NORTH_STAR = (96, 16, 512, 512)
CT_SHAPE, CT_ANGLES = (16, 4, 512, 512), 96  # the JAX package's CT bench shape
CT_SMALL = (2, 2, 64, 64)  # the CT main path from numpy inputs
# what cp_reconstruct launches its kernels with on the main path
CT_CFG = dict(scheme="hybrid", reg_time=0.5)
# the scheme configs of the JAX package's kernel tests
CONFIGS = {"base": {}, "time": dict(reg_time=0.5),
           "zt": dict(reg_time=0.7, reg_z_over_reg=0.3),
           "noz": dict(reg_z_over_reg=0.0)}
# phases 3 and 8 add time without z, so that with the shapes below every
# channel table of csrc/tables.cuh is launched; RAGGED's (Nz, M) give
# central's FWD fallbacks in every combination with a CTR or FWD other axis,
# and their odd rows end in a short run of the specialised pass A (which
# takes two columns a thread); in phase 3 MISALIGNED's arrays start one
# element past an aligned address, so that pass A reads element by element
# at an even width too
TABLE_CONFIGS = dict(CONFIGS, tonly=dict(reg_z_over_reg=0.0, reg_time=0.5))
RAGGED = ((2, 2, 24, 71), (2, 3, 20, 39), (3, 2, 17, 31))
MISALIGNED = (2, 2, 24, 64)
STORAGE = {"f32": (torch.float32, torch.float32),
           "f32+bf16dual": (torch.float32, torch.bfloat16),
           "bf16+bf16dual": (torch.bfloat16, torch.bfloat16)}
# f32: the JAX fused-vs-jnp bar.  Any bf16 storage: both versions compute
# the same f32 value to f32 round-off (the f32 bar, absolute where a sum
# cancels), but a value within that round-off of a bf16 rounding midpoint
# may round one bf16 ulp apart (<= 2^-7 relative), and a flipped y_D' entry
# moves x' by tau * w * ulp(y_D') <= 2^-7 * reg.  So each element must lie
# within the f32 bar plus one bf16 ulp, and the flips must stay rare: at
# most 1% of the elements may differ beyond the f32 bar.
F32_TOL = dict(atol=2e-6, rtol=1e-5)
F32_TOL_GD = dict(atol=3e-6, rtol=1e-5)  # the JAX fused-vs-jnp bar for B3/B4
BF16_RTOL = 2.0 ** -7
BF16_MAX_FLIPPED = 0.01


def log(msg):
    print(msg, flush=True)


def sync():
    torch.cuda.synchronize(DEV)


def require(cond, what):
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def zero_counters():
    profiling.clear_counters()


def read_counters():
    got = profiling.counters()
    return {k: got[key] for k, key in COUNTERS.items()}


def require_launches(got, what, **expected):
    """The counters named in ``expected`` read as given, every other 0."""
    want = dict.fromkeys(read_counters(), 0)
    want.update(expected)
    require(got == want, f"{what}: launches {want}, got {got}")


def bound(n_bytes, n_ops):
    """The least time for the work, ms, and what sets it: each byte once
    over the HBM rate, each operation over the float32 rate."""
    by_bytes = n_bytes / (H100_HBM_PEAK_GBPS * 1e9) * 1e3
    by_ops = n_ops / H100_F32_PEAK_FLOPS * 1e3
    return max(by_bytes, by_ops), "bytes" if by_bytes >= by_ops else "operations"


# ---------------------------------------------------------------- phase 1
def phase_device():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs an NVIDIA GPU", file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip().splitlines()[0]
    nvcc = subprocess.run([build.find_nvcc(), "--version"],
                          capture_output=True, text=True, check=True)
    log(f"[1 device] {torch.cuda.get_device_name(0)}, "
        f"count {torch.cuda.device_count()}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, nvcc "
        f"{nvcc.stdout.strip().splitlines()[-1]}, python "
        f"{sys.version.split()[0]}; nvidia-smi name, power.limit:")
    log(card)
    return card


# ---------------------------------------------------------------- phase 2
def _ptxas_of(compiler_log, kid, kernel):
    """Registers, stack frames and spills ptxas reported for the instances
    whose mangled name matches the pattern ``kernel``."""
    regs, frames = [], []
    for entry in re.split(r"Compiling entry function '", compiler_log)[1:]:
        if not re.search(kernel, entry.split("'")[0]):
            continue
        used = re.search(r"Used (\d+) registers", entry)
        frame = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", entry)
        if used and frame:
            regs.append(int(used.group(1)))
            frames.append(tuple(map(int, frame.groups())))
    kernel = re.match(r"\w+?_kernel", kernel).group()
    if not regs:
        return f"{kid} {kernel}: no ptxas report"
    return (f"{kid} {kernel} x{len(regs)}: {min(regs)}-{max(regs)} "
            f"registers, stack frame <= {max(f[0] for f in frames)} B, "
            f"spill stores / loads <= {max(f[1] for f in frames)} / "
            f"{max(f[2] for f in frames)} B")


def phase_build():
    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(len(LIBS)) as pool:
        built = dict(zip(LIBS, pool.map(build.build, LIBS)))
    t1 = time.perf_counter()
    for name in LIBS:
        fused._lib(name)  # load and bind
    for name, (path, seconds, compiler_log) in built.items():
        if not compiler_log:  # built by an earlier run: its log was kept
            with open(path + ".log") as f:
                compiler_log = f.read()
        regs = [int(n) for n in re.findall(r"Used (\d+) registers",
                                           compiler_log)]
        frames = [tuple(map(int, m)) for m in re.findall(
            r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes "
            r"spill loads", compiler_log)]
        require(bool(regs) and len(frames) == len(regs),
                f"ptxas reported on every kernel of {name}")
        log(f"[2 build] {os.path.relpath(path, ROOT)}: nvcc {seconds:.1f} s; "
            f"ptxas: {len(regs)} kernels, {min(regs)}-{max(regs)} registers, "
            f"stack frame <= {max(f[0] for f in frames)} B, spill stores / "
            f"loads <= {max(f[1] for f in frames)} / "
            f"{max(f[2] for f in frames)} B")
        if name in (*fused.SPECIALISED, "cp_boundary", "resident_onchip",
                    "cp_zstream"):
            log(f"[2 build] {name}: " + "; ".join(
                _ptxas_of(compiler_log, kid, kernel)
                for kid, kernel in SPEC_KERNELS.items()
                if re.search(kernel, compiler_log)))
    log(f"[2 build] {len(LIBS)} sources in parallel: {t1 - t0:.1f} s, load "
        f"{time.perf_counter() - t1:.2f} s")
    sync()


# ---------------------------------------------------------------- phase 3
def _state(shape, cfg, storage, gen, fidelity):
    x_dt, d_dt = storage
    Nz, M = shape[0], shape[1]
    Nd = num_channels(cfg.scheme, Nz, M, cfg.reg_z_over_reg, cfg.reg_time)

    def rand(*s):
        return torch.rand(s, generator=gen, device=DEV)

    x0 = rand(*shape)
    x = (x0 + 0.1 * rand(*shape)).to(x_dt)
    y_A = rand(*shape)
    if fidelity == "l1":
        y_A = 2.0 * y_A - 1.0
    return (x, x0.to(x_dt), y_A.to(x_dt),
            rand(Nz, M, Nd, *shape[2:]).to(d_dt))


def _cases():
    for scheme in SCHEMES:
        for name, kw in TABLE_CONFIGS.items():
            yield f"{scheme}-{name}", TVConfig(scheme=scheme, **kw), {}, "f32"
    hyb = dict(scheme="hybrid", reg_time=0.5)
    for norm in ("aniso", "huber"):
        for scheme in ("hybrid", "central"):
            yield (f"{scheme}-time-{norm}",
                   TVConfig(scheme=scheme, reg_time=0.5, norm=norm,
                            huber_delta=0.3), {}, "f32")
    for fid in ("l1", "kl"):
        yield f"hybrid-time-{fid}", TVConfig(**hyb), dict(fidelity=fid,
                                                          fid_weight=0.7), "f32"
    yield "hybrid-time-nonneg", TVConfig(**hyb), dict(nonneg=True), "f32"
    yield "hybrid-time-tmul", TVConfig(**hyb), dict(tmul=True), "f32"
    yield ("upwind-time-tmul-huber", TVConfig(scheme="upwind", reg_time=0.5,
                                             norm="huber", huber_delta=0.3),
           dict(tmul=True), "f32")
    for storage in ("f32+bf16dual", "bf16+bf16dual"):
        for scheme in SCHEMES:
            yield f"{scheme}-zt-{storage}", TVConfig(
                scheme=scheme, **CONFIGS["zt"]), {}, storage
        yield "hybrid-time-tmul-" + storage, TVConfig(**hyb), dict(
            tmul=True), storage


def _compare(got, ref, bf16, scale, tol=F32_TOL):
    """Max |got - ref| after checking the tolerance stated above."""
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    f32_bar = tol["atol"] + tol["rtol"] * ref.abs()
    if bf16:
        bar = f32_bar + BF16_RTOL * (ref.abs() + scale)
        require(bool((err <= bar).all()),
                f"bf16 outputs within the f32 bar plus one bf16 ulp (max err "
                f"{float(err.max()):.3g})")
        flipped = float((err > f32_bar).float().mean())
        require(flipped <= BF16_MAX_FLIPPED,
                f"bf16 rounding flips {flipped:.4f} <= {BF16_MAX_FLIPPED}")
    else:
        require(bool((err <= f32_bar).all()),
                f"f32 outputs within atol {tol['atol']} rtol {tol['rtol']} "
                f"(max err {float(err.max()):.3g})")
    return float(err.max())


def _one_shard(x, cfg, depth):
    """x as the one shard of a 1 x 1 grid, extended by ``depth`` (1 or 2)
    ghost planes per side in z and t, as the sharded solvers extend it
    (parallel/fused_halo.py)."""
    chans, _ = scheme_channels(cfg.scheme, x.shape[0], x.shape[1],
                               cfg.reg_z_over_reg, cfg.reg_time)
    ext = fused_halo._extend_axis if depth == 1 else fused_halo._extend_axis2
    grid = [[x]]
    for axis in (AXIS_Z, AXIS_T):
        grid = ext(grid, axis, fused_halo._axis_ghost_kind(chans, axis))
    return grid[0][0]


def _shifted(t):
    """A copy of t that starts one element past an aligned address."""
    out = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)[1:]
    return out.view(t.shape).copy_(t)


def _bits_equal(a, b):
    return a.dtype == b.dtype and torch.equal(
        a.view(torch.int16 if a.dtype == torch.bfloat16 else torch.int32),
        b.view(torch.int16 if b.dtype == torch.bfloat16 else torch.int32))


def phase_kernels():
    reg, sigma_D, sigma_A = 0.5, 0.5, 1.0
    errs = {"B1": {"f32": 0.0, "bf16": 0.0}, "B2": {"f32": 0.0, "bf16": 0.0}}
    n = 0
    tids = set()
    for shape in (SMALL, CAMERAMAN, MAIN_4D, *RAGGED, MISALIGNED):
        gen = torch.Generator(device=DEV).manual_seed(1234)
        copy = _shifted if shape == MISALIGNED else torch.clone
        for name, cfg, opts, storage in _cases():
            opts = dict(opts)
            use_tmul = opts.pop("tmul", False)
            nonneg = opts.pop("nonneg", False)
            fid_kw = dict(fidelity=opts.get("fidelity", "l2"),
                          fid_weight=opts.get("fid_weight", 1.0))
            tau = default_tau(cfg, shape[0], shape[1], sigma_A)
            x, x0, y_A, y_D = map(copy, _state(shape, cfg, STORAGE[storage],
                                               gen, fid_kw["fidelity"]))
            tmul = None
            if use_tmul:
                mask = torch.rand(shape[2:], generator=gen, device=DEV) < 0.5
                tmul = t_plane_multiplier(
                    shape, dataclasses.replace(cfg, factor_reg_static=0.3),
                    mask_static=mask[None, None],
                    weight_time=1.0 + torch.rand(shape[2:], generator=gen,
                                                 device=DEV)[None, None],
                    dtype=x.dtype, device=DEV)
                # a volume with one time step has no time channels
                require((tmul is None) == (shape[1] == 1),
                        f"{name} {shape}: tmul built iff M > 1")
                if tmul is not None:
                    tmul = copy(tmul.float().contiguous())
            k = [copy(t) for t in (x, y_A, y_D)]
            p = [t.clone() for t in (x, y_A, y_D)]
            g = [t.clone() for t in (y_A, y_D)]
            dual_kw = dict(cfg=cfg, sigma_D=sigma_D, sigma_A=sigma_A, reg=reg,
                           **fid_kw)
            prim_kw = dict(cfg=cfg, tau=tau, nonneg=nonneg, **fid_kw)
            # its halo-mode instance (csrc/specialised_cp.cu) on a 1 x 1
            # grid first
            fused.cp_dual(_one_shard(x, cfg, 1), x0, g[0], g[1], tmul,
                          halo_mode=True, table_dims=shape[:2], **dual_kw)
            _, _, tv_k = fused.cp_dual(k[0], x0, k[1], k[2], tmul, **dual_kw)
            sync()
            require(_bits_equal(k[1], g[0]) and _bits_equal(k[2], g[1]),
                    f"{name} {shape}: specialised B1's y_A', y_D' equal its "
                    f"halo-mode instance's on a 1 x 1 grid bit for bit")
            # B2 against its halo-mode instance on a 1 x 1 grid, both out of
            # place, on a dual that B1 made from zero duals: the halo mode
            # reads the slots a channel's gates skip, which every solver
            # keeps zero
            y_a, y_0 = copy(y_A), copy(torch.zeros_like(y_D))
            fused.cp_dual(x, x0, y_a, y_0, tmul, **dual_kw)
            chans, _ = scheme_channels(cfg.scheme, *shape[:2],
                                       cfg.reg_z_over_reg, cfg.reg_time)
            y_ext = fused_halo._extend_dual([[y_0]], chans)[0][0]
            u, h = copy(x), copy(x)
            fused.cp_primal(x, x0, y_a, y_0, tmul, halo_mode=True,
                            table_dims=shape[:2], y_ext=y_ext, out=h,
                            **prim_kw)
            fused.cp_primal(x, x0, y_a, y_0, tmul, out=u, **prim_kw)
            sync()
            require(_bits_equal(u, h), f"{name} {shape}: specialised B2's x' "
                    f"equals its halo-mode instance's on a 1 x 1 grid bit "
                    f"for bit")
            tids.add(tables.table_id(cfg, *shape[:2]))
            _, _, tv_p = fused.cp_dual_plain(p[0], x0, p[1], p[2], tmul,
                                             **dual_kw)
            _, fid_k = fused.cp_primal(k[0], x0, k[1], k[2], tmul, **prim_kw)
            _, fid_p = fused.cp_primal_plain(p[0], x0, p[1], p[2], tmul,
                                             **prim_kw)
            sync()
            bf16 = storage != "f32"
            kind = "bf16" if bf16 else "f32"
            e1 = max(_compare(k[1], p[1], bf16, 0.0),
                     _compare(k[2], p[2], bf16, 0.0))
            e2 = _compare(k[0], p[0], bf16, reg)
            errs["B1"][kind] = max(errs["B1"][kind], e1)
            errs["B2"][kind] = max(errs["B2"][kind], e2)
            loss_k = float(fid_k.sum() + reg * tv_k.sum())
            loss_p = float(fid_p.sum() + reg * tv_p.sum())
            rel = abs(loss_k - loss_p) / abs(loss_p)
            require(rel <= (1e-4 if bf16 else 1e-5),
                    f"{name} {shape}: loss rel err {rel:.3g}")
            n += 1
    require(tids == set(range(len(tables.TABLES))),
            f"every channel table launched, got {sorted(tids)}")
    log(f"[3 kernels vs plain] {n} cases at {SMALL}, {CAMERAMAN}, "
        f"{MAIN_4D}, {RAGGED} and {MISALIGNED} (arrays one element off "
        f"alignment), all {len(tids)} channel tables: pass; "
        f"specialised B1 and B2 bit-equal to their halo-mode instances on "
        f"a 1 x 1 grid in every case; "
        f"max abs err B1 f32 {errs['B1']['f32']:.3g} bf16 "
        f"{errs['B1']['bf16']:.3g}, B2 f32 {errs['B2']['f32']:.3g} bf16 "
        f"{errs['B2']['bf16']:.3g}")
    sync()
    return errs


# ---------------------------------------------------------------- phase 4
def phase_main_path():
    require(has_real_cameraman(), "the real cameraman asset is present")
    truth = cameraman().reshape(CAMERAMAN)
    noisy = torch.as_tensor(add_noise(truth, 100, seed=0),
                            dtype=torch.float32, device=DEV)
    sync()
    zero_counters()
    res = TVDenoiser(reg=25).cp(noisy[0, 0], n_iter=300)
    sync()
    launches = read_counters()
    require_launches(launches, "TVDenoiser.cp", B1=300, B2=300)
    require(tuple(res.x.shape) == (256, 256) and res.x.is_cuda,
            "denoised image is (256, 256) on the GPU")
    require(bool(torch.isfinite(res.x).all()), "denoised image is finite")
    final = float(res.loss[-1])
    rel = abs(final - CAMERAMAN_LOSS) / CAMERAMAN_LOSS
    log(f"[4 main path] TVDenoiser(reg=25).cp(cameraman, n_iter=300) f32: "
        f"final loss {final:.2f}, rel err {rel:.3g} vs {CAMERAMAN_LOSS}; "
        f"launches {launches}")
    require(rel < 1e-4, "cameraman loss within 1e-4 of the reference")
    return launches


# ---------------------------------------------------------------- phase 5
def phase_golden():
    g = np.load(os.path.join(ROOT, "tests", "golden",
                             "golden_solver4d_production.npz"))
    shape = tuple(int(n) for n in g["shape"])
    rng = np.random.default_rng(int(g["seed"]))
    noisy = torch.as_tensor(rng.random(shape) * 100.0,
                            dtype=torch.float32, device=DEV)
    cfg = TVConfig(scheme="hybrid", reg_time=float(g["reg_time"]))
    out = []
    for dual in (None, "bfloat16"):
        res = chambolle_pock(noisy, n_iter=len(g["losses"]),
                             reg=float(g["reg"]), cfg=cfg,
                             tau=float(g["tau"]), dual_dtype=dual,
                             return_dual=False)
        loss = res.loss.double().cpu().numpy()
        rel = float(np.max(np.abs(loss - g["losses"]) / g["losses"]))
        out.append(f"{dual or 'f32'} dual {rel:.3g}")
        require(rel < 1e-4, f"golden trajectory ({dual or 'f32'} dual) "
                            f"within 1e-4, got {rel:.3g}")
    log(f"[5 reference scale] {shape} 50 fused iterations, max "
        f"rel loss deviation from the f64 reference: {', '.join(out)}")
    sync()


# ---------------------------------------------------------------- phase 6
class _Run:
    """A CP state on the device and a step over it (kernels or plain)."""

    def __init__(self, noisy, cfg, dual_dtype, plain):
        shape = tuple(noisy.shape)
        Nd = num_channels(cfg.scheme, shape[0], shape[1], cfg.reg_z_over_reg,
                          cfg.reg_time)
        self.x0 = noisy
        self.x = noisy.clone()
        self.y_A = torch.zeros_like(noisy)
        self.y_D = torch.zeros((shape[0], shape[1], Nd) + shape[2:],
                               dtype=dual_dtype, device=DEV)
        self.kw = dict(cfg=cfg, reg=1.0, sigma_D=0.5, sigma_A=1.0,
                       tau=default_tau(cfg, shape[0], shape[1]))
        self.dual = fused.cp_dual_plain if plain else fused.cp_dual
        self.primal = fused.cp_primal_plain if plain else fused.cp_primal
        self.losses = []

    def step(self):
        kw = self.kw
        _, _, tv = self.dual(self.x, self.x0, self.y_A, self.y_D,
                             cfg=kw["cfg"], sigma_D=kw["sigma_D"],
                             sigma_A=kw["sigma_A"], reg=kw["reg"])
        _, fid = self.primal(self.x, self.x0, self.y_A, self.y_D,
                             cfg=kw["cfg"], tau=kw["tau"])
        return torch.sum(fid) + kw["reg"] * torch.sum(tv)

    def run(self, n):
        for _ in range(n):
            self.losses.append(self.step())


def _host_us(fn, n=200):
    """Host microseconds per call of ``fn``: n calls issued back to back
    behind a kernel that keeps the device busy for longer than they take, so
    that none waits for the device, then one synchronisation."""
    fn()
    sync()
    torch.cuda._sleep(200_000_000)
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    sync()
    return (t1 - t0) / n * 1e6


def _time_launch(fn, n=50):
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    fn()
    sync()
    start.record()
    for _ in range(n):
        fn()
    end.record()
    sync()
    return start.elapsed_time(end) / n


def phase_throughput(card):
    cfg = TVConfig(scheme="hybrid", reg_time=0.5)
    Nd = num_channels(cfg.scheme, MAIN_4D[0], MAIN_4D[1], cfg.reg_z_over_reg,
                      cfg.reg_time)
    base = np.random.default_rng(0).random(MAIN_4D)
    kernel_ms = {}
    for tag, (x_dt, d_dt) in STORAGE.items():
        noisy = torch.as_tensor(base, dtype=torch.float32,
                                device=DEV).to(x_dt)
        # the kernel path through the solver's entry point, the plain path
        # as the same step loop over the plain versions
        res = chambolle_pock(noisy, n_iter=300, reg=1.0, cfg=cfg,
                             dual_dtype=d_dt, return_dual=False)
        kernel_loss = res.loss.double().cpu().numpy()
        del res
        r = _Run(noisy, cfg, d_dt, plain=True)
        r.run(300)
        plain_loss = torch.stack(r.losses).double().cpu().numpy()
        del r
        rel = float(np.max(np.abs(kernel_loss - plain_loss) / plain_loss))
        require(rel < 1e-4, f"{tag}: 300-iteration kernel vs plain loss "
                            f"within 1e-4, got {rel:.3g}")
        traffic = cp_traffic_model(MAIN_4D, Nd, dtype=x_dt, dual_dtype=d_dt)
        rates = {False: [], True: []}
        for plain in (True, False, False, True):  # plain, kernel, kernel, plain
            r = _Run(noisy, cfg, d_dt, plain)
            rates[plain].append(time_iterations(r.run, 100, DEV))
            del r
        line = []
        for plain in (False, True):
            it_s = max(rates[plain])
            line.append(f"{'plain' if plain else 'kernels'} {it_s:.1f} it/s "
                        f"({100 * roofline_fraction(traffic, it_s):.1f}% of "
                        f"HBM roofline, minimal model)")
        log(f"[6 4D {MAIN_4D} {tag}] kernel vs plain 300-it loss rel "
            f"{rel:.3g} (bar 1e-4); " + "; ".join(line))
        # B1 and B2 per launch in this storage pair: CUDA events around 50
        # launches, the kernel alone on the device (_kernel_ms), the plain
        # version, and the bound of the bytes it moves (each array once:
        # B1 reads x, x0, y_A and y_D and writes y_A and y_D, B2 reads x,
        # x0, y_A and y_D and writes x') and of its operations (main())
        r = _Run(noisy, cfg, d_dt, plain=False)
        args = (r.x, r.x0, r.y_A, r.y_D)
        kw = r.kw
        dk = dict(cfg=cfg, sigma_D=kw["sigma_D"], sigma_A=kw["sigma_A"],
                  reg=kw["reg"])
        pk = dict(cfg=cfg, tau=kw["tau"])
        vox, bx, bd = int(np.prod(MAIN_4D)), x_dt.itemsize, d_dt.itemsize
        runs = {"B1": (lambda: fused.cp_dual(*args, **dk),
                       lambda: fused.cp_dual_plain(*args, **dk),
                       (4 * bx + 2 * Nd * bd) * vox, (10 * Nd + 10) * vox),
                "B2": (lambda: fused.cp_primal(*args, **pk),
                       lambda: fused.cp_primal_plain(*args, **pk),
                       (4 * bx + Nd * bd) * vox, (4 * Nd + 8) * vox)}
        line = []
        for kid, (run, plain, n_bytes, n_ops) in runs.items():
            ms = _time_launch(run)
            dev, kept = _kernel_ms(run, SPEC_KERNELS[kid])
            require(kept == 50, f"{kid} {tag}: the trace kept all 50 "
                                f"launches, got {kept}")
            b = bound(n_bytes, n_ops)
            got = dict(ms=ms, device_ms=dev, plain_ms=_time_launch(plain),
                       bound_ms=b[0], bound_by=b[1])
            kernel_ms.setdefault("at_storage", {}).setdefault(kid, {})[
                tag] = got
            if tag == "f32":
                kernel_ms[kid] = (ms, got["plain_ms"])
            line.append(f"{kid} {ms:.4f} ms, {dev:.4f} on the device "
                        f"({kept} of 50 launches kept), plain "
                        f"{got['plain_ms']:.3f}; bound {b[0]:.4f} ms "
                        f"({b[1]}, {n_bytes / 1e6:.0f} MB): {b[0] / dev:.1%} "
                        f"of it on the device")
        log(f"[6 per launch, {tag} {MAIN_4D}] " + "; ".join(line)
            + f"; card {card}")
        del r, args
        sync()
    return kernel_ms


# ---------------------------------------------------------------- phase 7
def phase_north_star():
    cfg = TVConfig(scheme="hybrid", reg_time=0.5)
    gen = torch.Generator(device=DEV).manual_seed(0)
    noisy = torch.rand(NORTH_STAR, generator=gen, device=DEV).to(
        torch.bfloat16)
    sync()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(DEV)
    kw = dict(reg=1.0, cfg=cfg, dual_dtype="bfloat16", return_dual=False)
    chambolle_pock(noisy, n_iter=2, **kw)  # warm-up
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    res = chambolle_pock(noisy, n_iter=20, **kw)
    end.record()
    sync()
    it_s = 20 / (start.elapsed_time(end) / 1e3)
    require(bool(torch.isfinite(res.loss).all()), "north-star losses finite")
    require(res.state.y_D is None, "return_dual=False drops the dual")
    peak = torch.cuda.max_memory_allocated(DEV)
    log(f"[7 real size] {NORTH_STAR} bf16 primary + dual, 20 iterations on "
        f"the kernels: {it_s:.2f} it/s (whole solver call), peak memory "
        f"{peak / 1e9:.2f} GB, final loss {float(res.loss[-1]):.6g}")
    sync()


# ---------------------------------------------------------------- phase 8
def _gd_cases():
    """(name, cfg, tmul, storage): the case matrix of
    tests/test_torch_gd_kernels.py, and time without z."""
    for scheme in SCHEMES:
        for name, kw in TABLE_CONFIGS.items():
            yield f"{scheme}-{name}", TVConfig(scheme=scheme, **kw), False, \
                torch.float32
    for norm in ("aniso", "huber"):
        for scheme in ("hybrid", "central"):
            yield (f"{scheme}-time-{norm}",
                   TVConfig(scheme=scheme, reg_time=0.5, norm=norm,
                            huber_delta=0.3), False, torch.float32)
    for norm in ("iso", "aniso", "huber"):
        yield (f"hybrid-time-tmul-{norm}",
               TVConfig(scheme="hybrid", reg_time=0.5, norm=norm,
                        huber_delta=0.3, factor_reg_static=0.3), True,
               torch.float32)
    for scheme in SCHEMES:
        yield f"{scheme}-zt-bf16", TVConfig(scheme=scheme, **CONFIGS["zt"]), \
            False, torch.bfloat16
    yield ("hybrid-time-tmul-bf16", TVConfig(scheme="hybrid", reg_time=0.5,
                                             factor_reg_static=0.3), True,
           torch.bfloat16)


def _gd_tmul(shape, cfg, gen):
    mask = torch.rand(shape[2:], generator=gen, device=DEV) < 0.5
    wt = 1.0 + torch.rand(shape[2:], generator=gen, device=DEV)
    tmul = t_plane_multiplier(shape, cfg, mask_static=mask[None, None],
                              weight_time=wt[None, None], device=DEV)
    # a volume with one time step has no time channels
    require((tmul is None) == (shape[1] == 1), f"{shape}: tmul iff M > 1")
    return None if tmul is None else tmul.float().contiguous()


def phase_gd_kernels():
    errs = {"B3": {"f32": 0.0, "bf16": 0.0}, "B4": {"f32": 0.0, "bf16": 0.0}}
    n = 0
    tids = set()
    for shape in (SMALL, CAMERAMAN, MAIN_4D, CT_SMALL, CT_SHAPE, *RAGGED,
                  MISALIGNED):
        gen = torch.Generator(device=DEV).manual_seed(4321)
        copy = _shifted if shape == MISALIGNED else torch.clone
        for name, cfg, use_tmul, dtype in _gd_cases():
            if shape == CT_SHAPE and name != "hybrid-time":
                continue  # at full width, what the CT main path launches
            x = copy(torch.rand(shape, generator=gen, device=DEV).to(dtype))
            tmul = _gd_tmul(shape, cfg, gen) if use_tmul else None
            tmul = None if tmul is None else copy(tmul)
            norms_k, parts_k = fused.tv_norms(x, tmul, cfg=cfg)
            norms_p, parts_p = fused.tv_norms_plain(x, tmul, cfg=cfg)
            G_k = fused.tv_subgrad(x, norms_k, tmul, cfg=cfg)
            G_p = fused.tv_subgrad_plain(x, norms_p, tmul, cfg=cfg)
            # the halo-mode instances on a 1 x 1 grid
            norms_g, _ = fused.tv_norms(_one_shard(x, cfg, 1), tmul, cfg=cfg,
                                        halo_mode=True, table_dims=shape[:2])
            aniso = cfg.norm == "aniso"
            G_g = fused.tv_subgrad(
                _one_shard(x, cfg, 2),
                None if aniso else fused_halo._extend_norms([[norms_k]])[0][0],
                tmul, cfg=cfg, halo_mode=True, table_dims=shape[:2])
            sync()
            require(_bits_equal(norms_k, norms_g), f"{name} {shape}: "
                    f"B3's norms equal its halo mode's on a 1 x 1 grid bit "
                    f"for bit")
            require(_bits_equal(G_k, G_g), f"{name} {shape}: B4's G equals "
                    f"its halo mode's on a 1 x 1 grid bit for bit")
            tids.add(tables.table_id(cfg, *shape[:2]))
            bf16 = dtype == torch.bfloat16
            kind = "bf16" if bf16 else "f32"
            inf_k, inf_p = torch.isinf(norms_k), torch.isinf(norms_p)
            require(torch.equal(inf_k, inf_p),
                    f"{name} {shape}: +inf norms at the same voxels")
            e3 = _compare(torch.where(inf_k, 0.0, norms_k),
                          torch.where(inf_p, 0.0, norms_p), False, 0.0,
                          F32_TOL_GD)
            e4 = _compare(G_k, G_p, bf16, 0.0, F32_TOL_GD)
            errs["B3"][kind] = max(errs["B3"][kind], e3)
            errs["B4"][kind] = max(errs["B4"][kind], e4)
            tv_k, tv_p = float(parts_k.sum()), float(parts_p.sum())
            rel = abs(tv_k - tv_p) / abs(tv_p)
            require(rel <= 1e-6, f"{name} {shape}: TV rel err {rel:.3g}")
            n += 1
    require(tids == set(range(len(tables.TABLES))),
            f"every channel table launched, got {sorted(tids)}")
    log(f"[8 GD kernels vs plain] {n} cases at {SMALL}, {CAMERAMAN}, "
        f"{MAIN_4D}, {CT_SMALL}, (the CT path's config) {CT_SHAPE}, "
        f"{RAGGED} and {MISALIGNED} (x one element off alignment), all "
        f"{len(tids)} channel tables: pass; B3 and B4 bit-equal to their "
        f"halo-mode instances on a 1 x 1 grid in every case; "
        f"max abs err B3 f32 {errs['B3']['f32']:.3g} "
        f"(bf16 x {errs['B3']['bf16']:.3g}), B4 f32 {errs['B4']['f32']:.3g} "
        f"bf16 {errs['B4']['bf16']:.3g}")
    sync()
    return errs


# ---------------------------------------------------------------- phase 9
def phase_gd_main_path():
    truth = cameraman().reshape(CAMERAMAN)
    noisy = torch.as_tensor(add_noise(truth, 100, seed=0),
                            dtype=torch.float32, device=DEV)
    sync()
    zero_counters()
    res = TVDenoiser(reg=25).gd(noisy[0, 0], n_iter=300)
    sync()
    launches = read_counters()
    require_launches(launches, "TVDenoiser.gd", B3=300, B4=300, B4gd=300)
    require(tuple(res.x.shape) == (256, 256) and res.x.is_cuda,
            "denoised image is (256, 256) on the GPU")
    require(bool(torch.isfinite(res.x).all()), "denoised image is finite")
    final = float(res.loss[-1])
    rel = abs(final - CAMERAMAN_GD_LOSS) / CAMERAMAN_GD_LOSS
    log(f"[9 GD main path] TVDenoiser(reg=25).gd(cameraman, n_iter=300) f32: "
        f"final loss {final:.2f}, rel err {rel:.3g} vs {CAMERAMAN_GD_LOSS}; "
        f"launches {launches}")
    # f32 GD is nonsmooth: pixels that become exactly equal in f32 (a zero
    # norm, the +inf convention) steer it off the f64 path by ~1e-5 in any
    # f32 implementation (the JAX package's own f32 jnp path: 1.07e-5 on
    # the CPU), so the card path is held to the 300-iteration kernel bar
    # of BASELINE.md; the f64 path meets 1e-5 (tests/test_torch_gd.py)
    require(rel < 1e-4, "cameraman GD loss within 1e-4 of the reference")
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    TVDenoiser(reg=25).gd(noisy[0, 0], n_iter=300)
    end.record()
    sync()
    wall_ms = start.elapsed_time(end) / 300
    dev_ms, _ = device_time(lambda: TVDenoiser(reg=25).gd(noisy[0, 0],
                                                          n_iter=300), 300, DEV)
    log(f"[9 GD main path] cameraman: {1e3 / wall_ms:.1f} it/s (a second "
        f"300-iteration call, CUDA events), wall {wall_ms:.4f} ms/it, device "
        f"{dev_ms:.4f} ms/it (torch.profiler), idle "
        f"{100 * (1 - dev_ms / wall_ms):.1f}%")

    np.random.seed(0)
    img = np.random.rand(20, 4, 100, 100)
    zero_counters()
    tv_val, G = tv_GPU.tv_hybrid(img)
    sync()
    tv_launches = read_counters()
    require_launches(tv_launches, "tv_GPU.tv_hybrid", B3=1, B4=1)
    require(isinstance(tv_val, float) and isinstance(G, np.ndarray)
            and G.shape == img.shape and bool(np.isfinite(G).all()),
            "tv_GPU.tv_hybrid returns a float and a finite numpy G")
    rel_tv = abs(tv_val - README_TV) / README_TV
    log(f"[9 GD main path] tv_GPU.tv_hybrid(rand(20, 4, 100, 100)) on the "
        f"GPU: tv {tv_val:.6f}, rel err {rel_tv:.3g} vs {README_TV}; "
        f"launches {tv_launches}")
    require(rel_tv < 1e-5, "README tv_hybrid value within 1e-5")

    # the package root's tv_hybrid is ops.api's: a CUDA tensor takes B3 + B4
    zero_counters()
    tv_root, G_root = pytv4d_tpu_torch.tv_hybrid(
        torch.as_tensor(img, dtype=torch.float32, device=DEV))
    sync()
    root_launches = read_counters()
    require_launches(root_launches, "pytv4d_tpu_torch.tv_hybrid", B3=1, B4=1)
    rel_root = abs(float(tv_root) - README_TV) / README_TV
    require(G_root.is_cuda and tuple(G_root.shape) == img.shape
            and rel_root < 1e-5,
            f"root tv_hybrid on a CUDA tensor: G on the card, tv within 1e-5 "
            f"({rel_root:.3g})")
    log(f"[9 GD main path] pytv4d_tpu_torch.tv_hybrid(cuda tensor): tv rel "
        f"err {rel_root:.3g}; launches {root_launches}")
    return launches


# ---------------------------------------------------------------- phase 10
class _GDRun:
    """A GD iterate on the device and a step over it: the body of
    solvers.gd.subgradient_descent's fused loop (B3, then B4 with the step
    in its epilogue), or its plain version (the plain B3 and B4, then the
    eager update and loss)."""

    def __init__(self, noisy, cfg, plain, reg=1.0, step_size=5e-3):
        self.x0, self.x, self.cfg = noisy, noisy.clone(), cfg
        self.reg, self.step_size, self.plain = reg, step_size, plain
        self.losses = []

    def step(self):
        kw = dict(cfg=self.cfg)
        if not self.plain:
            norms, parts = fused.tv_norms(self.x, **kw)
            self.x, fid = fused.tv_gd_step(self.x, self.x0, norms, **kw,
                                           reg=self.reg,
                                           step_size=self.step_size)
            return torch.sum(fid) + self.reg * torch.sum(parts)
        norms, parts = fused.tv_norms_plain(self.x, **kw)
        G = fused.tv_subgrad_plain(self.x, norms, **kw)
        self.x = self.x - self.step_size * ((self.x - self.x0) + self.reg * G)
        loss = (0.5 * torch.sum(torch.square(self.x - self.x0))
                + self.reg * torch.sum(parts))
        return loss

    def run(self, n):
        for _ in range(n):
            self.losses.append(self.step())


def phase_gd_4d(card):
    cfg = TVConfig(scheme="hybrid", reg_time=0.5)
    base = np.random.default_rng(0).random(MAIN_4D)
    trajectories, out = {}, {}
    for tag, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        noisy = torch.as_tensor(base, dtype=torch.float32,
                                device=DEV).to(dtype)
        res = subgradient_descent(noisy, n_iter=300, reg=1.0, step_size=5e-3,
                                  cfg=cfg)
        kernel_loss = res.loss.double().cpu().numpy()
        trajectories[tag] = kernel_loss
        del res
        r = _GDRun(noisy, cfg, plain=True)
        r.run(300)
        plain_loss = torch.stack(r.losses).double().cpu().numpy()
        del r
        rel = float(np.max(np.abs(kernel_loss - plain_loss) / plain_loss))
        if tag == "f32":
            require(rel < 1e-4, f"f32: 300-iteration GD kernel vs plain loss "
                                f"within 1e-4, got {rel:.3g}")
            line = f"kernel vs plain 300-it loss rel {rel:.3g} (bar 1e-4)"
        else:
            # the JAX bf16 bar (3e-2) over its test's horizon, the first
            # 20 iterations, and at the end; in between, where the loss falls
            # tenfold, bf16's coarser update lags the f32 one by a fraction
            # of an iteration (the JAX package's own bf16 path peaks at 3.9%
            # near iteration 30 at (4, 3, 32, 40)), so the peak is printed
            to_f32 = (np.abs(kernel_loss - trajectories["f32"])
                      / trajectories["f32"])
            head, last = float(to_f32[:20].max()), float(to_f32[-1])
            require(head < 3e-2 and last < 3e-2,
                    f"bf16 GD kernel loss within 3e-2 of f32 over the first 20 "
                    f"iterations and at the last, got {head:.3g}, {last:.3g}")
            line = (f"kernel vs f32 kernel loss rel {head:.3g} over the first "
                    f"20 iterations, {last:.3g} at the last (bar 3e-2), peak "
                    f"{float(to_f32.max()):.3g} at iteration "
                    f"{int(to_f32.argmax())}; kernel vs bf16 plain max "
                    f"{rel:.3g}")
        rates = {False: [], True: []}
        for plain in (True, False, False, True):  # plain, kernel, kernel, plain
            r = _GDRun(noisy, cfg, plain)
            rates[plain].append(time_iterations(r.run, 20 if plain else 100,
                                                DEV))
            del r
        it_s = {plain: max(v) for plain, v in rates.items()}
        r = _GDRun(noisy, cfg, plain=False)
        dev_ms, by_kernel = device_time(lambda: r.run(100), 100, DEV)
        del r
        top = ", ".join(f"{name[:40]} {ms:.4f}" for name, ms in sorted(
            by_kernel.items(), key=lambda kv: -kv[1])[:6])

        # the split of one kernel iteration: B3 and B4 with the step in its
        # epilogue; beside them the standalone B4 and the plain-torch update
        # and loss it replaces (x, x0, G and the parts held fixed)
        r = _GDRun(noisy, cfg, plain=False)
        x, x0 = r.x, r.x0
        norms, parts = fused.tv_norms(x, cfg=cfg)
        G = fused.tv_subgrad(x, norms, cfg=cfg)

        def update():
            xn = x - 5e-3 * ((x - x0) + 1.0 * G)
            return 0.5 * torch.sum(torch.square(xn - x0)) + torch.sum(parts)

        ms = {"B3": (_time_launch(lambda: fused.tv_norms(x, cfg=cfg)),
                     _time_launch(lambda: fused.tv_norms_plain(x, cfg=cfg),
                                  n=10)),
              "B4": (_time_launch(lambda: fused.tv_subgrad(x, norms, cfg=cfg)),
                     _time_launch(lambda: fused.tv_subgrad_plain(
                         x, norms, cfg=cfg), n=10)),
              "B4gd": (_time_launch(lambda: fused.tv_gd_step(
                  x, x0, norms, cfg=cfg, reg=1.0, step_size=5e-3)), None),
              "update": (_time_launch(update), None)}
        del r, x, x0, norms, parts, G
        bytes_3, bytes_4 = tv_traffic_model(MAIN_4D, dtype, cfg.norm)
        gbs = {"B3": bytes_3 / ms["B3"][0] / 1e6,
               "B4": bytes_4 / ms["B4"][0] / 1e6}
        iter_ms = 1e3 / it_s[False]
        log(f"[10 GD 4D {MAIN_4D} {tag}] {line}; kernels {it_s[False]:.1f} "
            f"it/s, plain {it_s[True]:.1f} it/s (best of 3, CUDA events)")
        log(f"[10 GD 4D {MAIN_4D} {tag}] device {dev_ms:.4f} ms/it "
            f"(torch.profiler, 100 kernel iterations), idle "
            f"{100 * (1 - dev_ms / (1e3 / it_s[False])):.1f}%; top: {top}")
        log(f"[10 GD 4D {MAIN_4D} {tag}] per launch: B3 {ms['B3'][0]:.4f} ms "
            f"(plain {ms['B3'][1]:.3f} ms, {gbs['B3']:.0f} GB/s = "
            f"{100 * gbs['B3'] / H100_HBM_PEAK_GBPS:.1f}% of "
            f"{H100_HBM_PEAK_GBPS:.0f}), B4 {ms['B4'][0]:.4f} ms (plain "
            f"{ms['B4'][1]:.3f} ms, {gbs['B4']:.0f} GB/s = "
            f"{100 * gbs['B4'] / H100_HBM_PEAK_GBPS:.1f}%), B4 with the GD "
            f"step {ms['B4gd'][0]:.4f} ms (the eager update + loss it "
            f"replaces {ms['update'][0]:.4f} ms); iteration {iter_ms:.4f} ms "
            f"= {100 * ms['B3'][0] / iter_ms:.1f}% B3 + "
            f"{100 * ms['B4gd'][0] / iter_ms:.1f}% B4 with the step; card "
            f"{card}")
        out[tag] = ms
        sync()
    return out


# ---------------------------------------------------------------- phase 11
def phase_gd_north_star():
    cfg = TVConfig(scheme="hybrid", reg_time=0.5)
    gen = torch.Generator(device=DEV).manual_seed(0)
    noisy = torch.rand(NORTH_STAR, generator=gen, device=DEV).to(
        torch.bfloat16)
    sync()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(DEV)
    kw = dict(reg=1.0, step_size=5e-3, cfg=cfg)
    subgradient_descent(noisy, n_iter=2, **kw)  # warm-up
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    zero_counters()
    start.record()
    res = subgradient_descent(noisy, n_iter=20, **kw)
    end.record()
    sync()
    it_s = 20 / (start.elapsed_time(end) / 1e3)
    require(read_counters()["B4"] == 20, "the volume ran through B3/B4")
    require(bool(torch.isfinite(res.loss).all()), "north-star GD losses finite")
    require(res.x.dtype == torch.bfloat16, "bf16 storage kept")
    peak = torch.cuda.max_memory_allocated(DEV)
    log(f"[11 real size GD] {NORTH_STAR} bf16, 20 iterations on the kernels: "
        f"{it_s:.2f} it/s (whole solver call), peak memory "
        f"{peak / 1e9:.2f} GB, final loss {float(res.loss[-1]):.6g}")
    sync()


# ---------------------------------------------------------------- phase 12
TGV_MODES = ("2d", "3d", "4d")
TGV_NORMS = ("iso", "aniso", "huber")
TGV_KW = dict(alpha1=1.0, alpha0=2.0, huber_delta=0.3)
# B7 over 20 iterations: each iteration is held to the f32 bar by the shared
# per-voxel code (B6 above); 20 of them may add up to 10 times that bar
F32_TOL_20 = dict(atol=2e-5, rtol=1e-4)
# the objective kernel against tgv_objective in float64 on the same stored
# values: both sum positive terms, the kernel in float32 by block partials
OBJ_RTOL = 1e-5


def _tgv_state(shape, mode, dtype, gen):
    """A non-zero random TGV state on the card (every channel and gate
    live): x, xb, w, wb, p, q, x0."""
    Nz, M, Nr, Nc = shape
    n = TGV_FIELDS[mode]

    def randn(*s):
        return torch.randn(s, generator=gen, device=DEV).to(dtype)

    x0 = torch.rand(shape, generator=gen, device=DEV)
    return ((x0 + 0.1 * randn(*shape).float()).to(dtype),
            (x0 + 0.1 * randn(*shape).float()).to(dtype),
            randn(Nz, n, M, Nr, Nc), randn(Nz, n, M, Nr, Nc),
            randn(Nz, n, M, Nr, Nc), randn(Nz, n * (n + 1) // 2, M, Nr, Nc),
            x0.to(dtype))


# B7's cases: the main path's shapes, a slice of odd size (one block), a
# 4-block and a 16-block cluster whose rows do not divide into the bands
# (odd columns, a short last band), a slice at the on-chip budget's edge
# (228 096 bytes a block with the loss) and the L2 kernel's 512^2 and 1024^2
# slices; (2, 2, 8, 40) also as a forced 16-block cluster, half of whose
# blocks own no row
B7_SHAPES = (SMALL, CAMERAMAN, MAIN_4D, (1, 1, 37, 33), (3, 1, 97, 151),
             (2, 1, 250, 270), (1, 1, 288, 288), (1, 1, 512, 512),
             (1, 1, 1024, 1024))
B7_FORCED = ((2, 2, 8, 40), 16)


def _bits_of(got, ref):
    """The six state arrays of two whole solves are equal bit for bit."""
    return all(_bits_equal(a, b) for a, b in zip(got[:6], ref[:6]))


def _b7_cases(errs):
    """B7 against its plain version over 1 and 20 iterations in the three
    norms, with and without the loss; where the slice fits on chip, the
    on-chip kernel's state against the L2 kernel's bit for bit (the losses
    to 1e-5: the block partials group the sum otherwise).  Returns the
    number of cases."""
    n = 0
    gen = torch.Generator(device=DEV).manual_seed(1357)
    for shape in B7_SHAPES + (B7_FORCED[0],):
        forced = shape == B7_FORCED[0]
        x0 = 10.0 * torch.rand(shape, generator=gen, device=DEV)
        for norm in TGV_NORMS:
            kw = dict(norm=norm, **TGV_KW)
            prm = tgv_stream.tgv_params(shape, "2d", TGV_KW["alpha1"],
                                        TGV_KW["alpha0"], 1.0, norm,
                                        TGV_KW["huber_delta"])
            last = {}
            for loss in (True, False):
                onchip = (forced or tgv_resident.tgv_resident_variant(
                    shape, loss) == "onchip")
                key = "B7" if onchip else "B7l2"
                for n_iter, tol in ((1, F32_TOL), (20, F32_TOL_20)):
                    before = read_counters()
                    if forced:
                        got = tgv_resident.solve_onchip(
                            x0, n_iter, prm, loss, cluster=B7_FORCED[1])
                    else:
                        got = tgv_resident.tgv_resident_solve(
                            x0, n_iter, compute_loss=loss, **kw)
                    after = read_counters()
                    require(after[key] == before[key] + 1,
                            f"B7 {shape} ran the {key} kernel")
                    ref = tgv_resident.tgv_resident_plain(
                        x0, n_iter, compute_loss=loss, **kw)
                    sync()
                    e = max(_compare(a, b, False, 0.0, tol)
                            for a, b in zip(got[:6], ref[:6]))
                    errs[key]["f32"] = max(errs[key]["f32"], e)
                    want = (n_iter,) if loss else (0,)
                    require(got[6].shape == want, "one loss per iteration")
                    if loss:
                        rel = float(((got[6] - ref[6]).abs()
                                     / ref[6].abs()).max())
                        require(rel <= 1e-5, f"B7 {norm} {shape} {n_iter} "
                                             f"it: loss rel err {rel:.3g}")
                    if onchip:
                        l2 = tgv_resident.solve_l2(x0, n_iter, prm, loss)
                        sync()
                        require(_bits_of(got, l2),
                                f"B7 {norm} {shape} {n_iter} it loss={loss}: "
                                f"the on-chip state is the L2 kernel's bit "
                                f"for bit")
                        if loss:
                            rel = float(((got[6] - l2[6]).abs()
                                         / l2[6].abs()).max())
                            require(rel <= 1e-5, "on-chip losses within "
                                                 "1e-5 of the L2 kernel's")
                    last[loss] = got
                    n += 1
            require(_bits_of(last[True], last[False]),
                    "compute_loss=False: the same iterates")
    # a launch the card refuses raises, and runs nothing else
    x0 = torch.rand(CAMERAMAN, generator=gen, device=DEV)
    prm = tgv_stream.tgv_params(CAMERAMAN, "2d", 1.0, 2.0, 1.0, "iso", 1.0)
    before = read_counters()
    try:
        tgv_resident.solve_onchip(x0, 2, prm, True, smem_bytes=240 * 1024)
    except RuntimeError as exc:
        refused = str(exc)
    else:
        raise RuntimeError("check failed: an on-chip launch with 240 KB of "
                           "shared memory a block was not refused")
    require(read_counters() == before, "a refused launch counts nothing")
    log(f"[12 B7 refused launch] 240 KB of shared memory a block: "
        f"RuntimeError({refused!r})")
    return n


def _objective_err(x, w, x0, mode, norm):
    """The objective kernel's value and ``tgv_objective``'s in float64 on
    the same card tensors: ``(abs err, rel err)``."""
    kw = dict(alpha1=TGV_KW["alpha1"], alpha0=TGV_KW["alpha0"], norm=norm,
              huber_delta=TGV_KW["huber_delta"])
    got = tgv_stream.tgv_stream_objective(x, w, x0, mode, **kw)
    ref = tgv_objective(x.double(), w.double(), x0.double(), mode, **kw)
    sync()
    require(got.dtype == torch.float32 and got.shape == () and got.is_cuda,
            "the objective kernel gives a float32 scalar on the card")
    err = abs(float(got) - float(ref))
    return err, err / abs(float(ref))


def phase_tgv_kernels():
    errs = {k: {"f32": 0.0, "bf16": 0.0}
            for k in ("B6pq", "B6xw", "B6obj", "B7", "B7l2")}
    obj_rel = {"f32": 0.0, "bf16": 0.0}
    n_cases = 0
    for shape in (SMALL, CAMERAMAN, MAIN_4D):
        gen = torch.Generator(device=DEV).manual_seed(2468)
        for mode in TGV_MODES:
            for norm in TGV_NORMS:
                for kind, dtype in (("f32", torch.float32),
                                    ("bf16", torch.bfloat16)):
                    bf16 = kind == "bf16"
                    x, xb, w, wb, p, q, x0 = _tgv_state(shape, mode, dtype,
                                                        gen)
                    before = read_counters()["B6obj"]
                    e, rel = _objective_err(x, w, x0, mode, norm)
                    require(read_counters()["B6obj"] == before + 1,
                            "one objective launch an evaluation")
                    require(rel <= OBJ_RTOL, f"objective {shape} {mode} "
                            f"{norm} {kind}: rel err {rel:.3g} vs float64")
                    errs["B6obj"][kind] = max(errs["B6obj"][kind], e)
                    obj_rel[kind] = max(obj_rel[kind], rel)
                    kw = dict(mode=mode, norm=norm, **TGV_KW)
                    pk, qk, pp, qp = p.clone(), q.clone(), p.clone(), q.clone()
                    tgv_stream.tgv_pq(xb, wb, pk, qk, **kw)
                    tgv_stream.tgv_pq_plain(xb, wb, pp, qp, **kw)
                    sync()
                    e = max(_compare(pk, pp, bf16, 0.0),
                            _compare(qk, qp, bf16, 0.0))
                    errs["B6pq"][kind] = max(errs["B6pq"][kind], e)
                    # both primal passes read the plain pass's duals
                    xk, wk, xp, wp = x.clone(), w.clone(), x.clone(), w.clone()
                    out_k = tgv_stream.tgv_xw(xk, x0, pp, wk, qp, mode=mode)
                    out_p = tgv_stream.tgv_xw_plain(xp, x0, pp, wp, qp,
                                                    mode=mode)
                    sync()
                    require(out_k[0] is xk and out_k[2] is wk,
                            "tgv_xw updates x and w in place")
                    e = max(_compare(a, b, bf16, 0.0)
                            for a, b in zip(out_k, out_p))
                    errs["B6xw"][kind] = max(errs["B6xw"][kind], e)
                    n_cases += 1
    n_b7 = _b7_cases(errs)
    log(f"[12 TGV kernels vs plain] B6: {n_cases} cases at {SMALL}, "
        f"{CAMERAMAN} and {MAIN_4D}; B7: {n_b7} at "
        f"{', '.join(map(str, B7_SHAPES))} and {B7_FORCED}: "
        f"pass; max abs err B6 PQ f32 "
        f"{errs['B6pq']['f32']:.3g} bf16 {errs['B6pq']['bf16']:.3g}, B6 XW "
        f"f32 {errs['B6xw']['f32']:.3g} bf16 {errs['B6xw']['bf16']:.3g}; "
        f"B6 objective vs tgv_objective in float64, max rel err f32 "
        f"{obj_rel['f32']:.3g} bf16 {obj_rel['bf16']:.3g} (bar {OBJ_RTOL}); "
        f"B7 "
        f"f32 over 1 and 20 iterations: on chip {errs['B7']['f32']:.3g}, L2 "
        f"{errs['B7l2']['f32']:.3g} (bar atol {F32_TOL_20['atol']} rtol "
        f"{F32_TOL_20['rtol']} at 20); the on-chip state bit-equal to the L2 "
        f"kernel's in every case")
    sync()
    errs["B6obj_rel"] = obj_rel
    return errs


# ---------------------------------------------------------------- phase 13
def phase_tgv_main_path():
    noisy = add_noise(cameraman(), 100, seed=0).astype(np.float32)
    require(isinstance(noisy, np.ndarray) and noisy.shape == (256, 256),
            "the input is a numpy image")
    zero_counters()
    solves = profiling.counters()["launch.B7"]
    res = TVDenoiser(reg=25).tgv(noisy, 300)  # numpy in, no device=
    sync()
    launches = read_counters()
    # one launch of the on-chip kernel, none of the L2 kernel or any other
    require_launches(launches, "TVDenoiser.tgv", B7=1)
    require(profiling.counters()["launch.B7"] == solves + 1,
            "one whole-solve launch")
    require(res.x.is_cuda and tuple(res.x.shape) == (256, 256)
            and res.x.dtype == torch.float32,
            "a numpy image is solved on the card, (256, 256) float32 out")
    require(bool(torch.isfinite(res.x).all()), "denoised image is finite")
    require(tuple(res.loss.shape) == (300,) and res.loss.is_cuda,
            "300 losses, on the card")
    final = float(res.loss[-1])
    rel = abs(final - CAMERAMAN_TGV_LOSS) / CAMERAMAN_TGV_LOSS
    require(rel < 1e-4, f"cameraman TGV loss within 1e-4 of the f64 value, "
                        f"got {rel:.3g}")
    require(final < 0.5 * float(res.loss[0]), "the loss more than halves")
    # the f64 trajectory rises once, at iteration 9, and falls from there on
    # (by ~800 per iteration at the end, 200 float32 ulps of the loss)
    require(bool((res.loss[11:] <= res.loss[10:-1]).all()),
            "the loss falls monotonically after the first 10 iterations")
    x0 = torch.as_tensor(noisy, device=DEV)[None, None]
    plain = tgv_resident.tgv_resident_plain(x0, 300, 25.0, 50.0)
    traj = float(((res.loss - plain[6]).abs() / plain[6]).max())
    require(traj < 1e-4, f"300-iteration kernel vs plain loss within 1e-4, "
                         f"got {traj:.3g}")
    log(f"[13 TGV main path] TVDenoiser(reg=25).tgv(numpy cameraman, 300) on "
        f"{res.x.device}: final loss {final:.2f}, rel err {rel:.3g} vs "
        f"{CAMERAMAN_TGV_LOSS}; kernel vs plain trajectory {traj:.3g}; "
        f"launches {launches}")

    base = np.random.default_rng(0).random(MAIN_4D)
    x = torch.as_tensor(base, dtype=torch.float32, device=DEV)
    kw = dict(n_iter=20, alpha1=1.0, alpha0=2.0, axes="4d")
    zero_counters()
    out = tgv_denoise(x, compute_loss=False, **kw)
    sync()
    stream_launches = read_counters()
    require_launches(stream_launches, "tgv_denoise 4d", B6pq=20, B6xw=20)
    require(out.loss.shape == (0,) and out.w.shape == (32, 4, 8, 256, 256)
            and bool(torch.isfinite(out.x).all()),
            "4d stream solve: no losses, a 4-field w, finite x")
    # the plain loop with its per-iteration loss (tgv_objective)
    ref = tgv_denoise(x, fused=False, **kw)
    err = _compare(out.x, ref.x, False, 0.0, F32_TOL_20)
    # the call users make, with its default per-iteration loss: B6's two
    # passes and the objective kernel every iteration, no eager step
    zero_counters()
    full = TVDenoiser(reg=1.0).tgv(x, n_iter=20, axes="4d")
    sync()
    full_launches = read_counters()
    require_launches(full_launches, "TVDenoiser.tgv 4d with the loss",
                     B6pq=20, B6xw=20, B6obj=20)
    require(full.loss.shape == (20,) and full.loss.dtype == torch.float32
            and full.loss.is_cuda and torch.equal(full.x, out.x)
            and torch.equal(full.w, out.w),
            "4d with the loss: 20 float32 losses on the card, the iterates "
            "of the solve without it")
    traj = float(((full.loss - ref.loss).abs() / ref.loss.abs()).max())
    require(traj < 1e-4, f"20-iteration streamed vs plain-loop loss within "
                         f"1e-4, got {traj:.3g}")
    last = float(tgv_objective(full.x.double(), full.w.double(), x.double(),
                               "4d", 1.0, 2.0))
    last_rel = abs(float(full.loss[-1]) - last) / last
    require(last_rel <= OBJ_RTOL, f"the last loss within {OBJ_RTOL} of "
                                  f"tgv_objective in float64 at the final "
                                  f"state, got {last_rel:.3g}")
    del ref
    zero_counters()
    sampled = tgv_denoise(x, loss_every=5, **kw)
    sync()
    require_launches(read_counters(), "tgv_denoise 4d loss_every=5",
                     B6pq=20, B6xw=20, B6obj=4)
    require(sampled.loss.shape == (4,) and torch.equal(sampled.x, out.x)
            and torch.equal(sampled.loss, full.loss[4::5]),
            "loss_every=5 over 20 iterations: 4 losses, the same iterates "
            "and every fifth loss of the per-iteration run")
    log(f"[13 TGV main path] tgv_denoise({MAIN_4D}, axes='4d', "
        f"compute_loss=False, n_iter=20): launches {stream_launches}; max "
        f"abs err of x vs the plain loop {err:.3g}; TVDenoiser(reg=1).tgv("
        f"axes='4d', n_iter=20) with its per-iteration loss: launches "
        f"{ {k: v for k, v in full_launches.items() if v} }, the same x and "
        f"w, losses vs the plain loop's max rel {traj:.3g}, the last vs "
        f"float64 {last_rel:.3g}; loss_every=5 -> "
        f"{[round(float(v), 1) for v in sampled.loss]} (4 objective "
        f"launches)")
    sync()
    return {"B7": launches["B7"], "B7l2": launches["B7l2"],
            "B6pq": stream_launches["B6pq"],
            "B6xw": stream_launches["B6xw"],
            "B6obj": full_launches["B6obj"]}


# ---------------------------------------------------------------- phase 14
def _best_ms(fn, repeats=3):
    """Fastest of ``repeats`` timed calls of ``fn`` after one warm-up, ms."""
    fn()
    sync()
    best = float("inf")
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        sync()
        best = min(best, start.elapsed_time(end))
    return best


def _marginal_ms(solve, n_lo, n_hi, repeats=3):
    """ms per iteration between two solve lengths: what one more iteration
    costs, without the launch and the set-up."""
    lo = _best_ms(lambda: solve(n_lo), repeats)
    hi = _best_ms(lambda: solve(n_hi), repeats)
    return (hi - lo) / (n_hi - n_lo)


class _TGVRun:
    """A cold TGV state on the card and the streaming step over it (kernels
    or plain)."""

    def __init__(self, x0, mode, plain):
        Nz, M, Nr, Nc = x0.shape
        n = TGV_FIELDS[mode]

        def zeros(c):
            return torch.zeros((Nz, c, M, Nr, Nc), dtype=x0.dtype, device=DEV)

        self.x0, self.mode = x0, mode
        self.st = [x0.clone(), x0.clone(), zeros(n), zeros(n), zeros(n),
                   zeros(n * (n + 1) // 2)]
        self.pq = tgv_stream.tgv_pq_plain if plain else tgv_stream.tgv_pq
        self.xw = tgv_stream.tgv_xw_plain if plain else tgv_stream.tgv_xw

    def run(self, n_iter):
        x, xb, w, wb, p, q = self.st
        for _ in range(n_iter):
            self.pq(xb, wb, p, q, mode=self.mode, alpha1=1.0, alpha0=2.0)
            self.xw(x, self.x0, p, w, q, xb, wb, mode=self.mode)


def _b7_kernel(variant, x, n_iter, alpha1, alpha0, compute_loss=True):
    """One launch of the named B7 kernel ("onchip" or "l2"), whichever the
    dispatch would pick for x."""
    prm = tgv_stream.tgv_params(tuple(x.shape), "2d", alpha1, alpha0, 1.0,
                                "iso", 1.0)
    kernel = (tgv_resident.solve_onchip if variant == "onchip"
              else tgv_resident.solve_l2)
    return kernel(x, n_iter, prm, compute_loss)


def tgv_objective_bytes(shape, mode, dtype):
    """The objective kernel's least traffic: x, x0 and the n planes of w
    read once (its per-block partials are a few KB)."""
    return ((TGV_FIELDS[mode] + 2) * int(np.prod(shape))
            * torch.empty((), dtype=dtype).element_size())


def tgv_ops_per_voxel(n):
    """Float operations per voxel of pass PQ, pass XW and the objective for
    an n-field mode, counted from csrc/tgv.cuh (iso norm; a sqrt, a max and
    a divide count one each)."""
    n_q, off = n * (n + 1) // 2, n * (n - 1) // 2
    pq = (n + n * n + 2 * off          # D xb, the n*n backward differences, E
          + 3 * n + (3 * n + 5)        # p + sigma (d - wb), its projection
          + 2 * n_q + (3 * n_q + 5))   # q + sigma e, its projection
    xw = 2 * n + 7 + n + 6 * off + 5 * n  # D^T p, x', xb', E^T q, w', wb'
    loss = (2 * n + n * n + 2 * off + 3   # D x - w, E w, (x - x0)^2 / 2
            + (2 * n + 1) + (2 * n_q + 1) + 4)
    return pq, xw, loss


def phase_tgv_rates(card):
    base = np.random.default_rng(0).random(MAIN_4D)
    x32 = torch.as_tensor(base, dtype=torch.float32, device=DEV)
    vox = int(np.prod(MAIN_4D))
    out = {}

    # the whole-solve kernels, on chip and in L2 (the parent's kernel, the
    # same launch as before this kernel), with and without the loss, and
    # the plain version
    def solve(n, plain=False, x=x32, compute_loss=True, variant=None):
        if plain:
            return tgv_resident.tgv_resident_plain(x, n, 1.0, 2.0,
                                                   compute_loss=compute_loss)
        if variant:
            return _b7_kernel(variant, x, n, 1.0, 2.0, compute_loss)
        return tgv_resident.tgv_resident_solve(x, n, 1.0, 2.0,
                                               compute_loss=compute_loss)

    b7 = {}
    for loss in (True, False):
        for v in ("onchip", "l2", "l2", "onchip"):  # in turns, best of two
            ms = _marginal_ms(lambda n: solve(n, compute_loss=loss, variant=v),
                              30, 150)
            b7[(v, loss)] = min(b7.get((v, loss), float("inf")), ms)
    res_plain_ms = _marginal_ms(lambda n: solve(n, plain=True), 3, 9,
                                repeats=1)
    # the user's call: tgv_denoise(axes='2d') with the loss lands on chip
    kw2d = dict(alpha1=1.0, alpha0=2.0, axes="2d")
    zero_counters()
    tgv_denoise(x32, n_iter=2, **kw2d)
    sync()
    require_launches(read_counters(), "tgv_denoise(axes='2d')", B7=1)
    denoise_ms = _marginal_ms(lambda n: tgv_denoise(x32, n_iter=n, **kw2d),
                              30, 150)
    ops2 = sum(tgv_ops_per_voxel(2))
    it_bound = bound(0, ops2 * vox)[0]
    solve_bytes = bound(13 * 4 * vox, 0)[0]
    log(f"[14 TGV rates {MAIN_4D}] 2d whole solve (B7) f32, ms/it marginal "
        f"between 30 and 150 iterations: with the loss on chip "
        f"{b7[('onchip', True)]:.4f}, L2 (the parent's kernel) "
        f"{b7[('l2', True)]:.4f} ({b7[('l2', True)] / b7[('onchip', True)]:.2f}"
        f"x); without the loss on chip {b7[('onchip', False)]:.4f}, L2 "
        f"{b7[('l2', False)]:.4f}; tgv_denoise(axes='2d') on chip "
        f"{denoise_ms:.4f}; plain {res_plain_ms:.3f}; bound "
        f"{ops2} flop/voxel -> {it_bound:.4f} ms/it (operations), 13 planes "
        f"{13 * 4 * vox / 1e6:.0f} MB -> {solve_bytes:.4f} ms per solve "
        f"(bytes); card {card}")
    out["B7 main4d"] = {"onchip": b7[("onchip", True)],
                        "l2": b7[("l2", True)], "bound": it_bound}

    # how many 16-block clusters the card holds at once
    occ = {(s, loss): (tgv_resident.max_active_clusters(s, loss),
                       tgv_resident.onchip_launch_shape(s, loss))
           for s, loss in ((CAMERAMAN, True), (CAMERAMAN, False),
                           ((1, 1, 288, 288), True),
                           ((1, 1, 336, 336), False))}
    log("[14 B7 on chip] cudaOccupancyMaxActiveClusters: " + "; ".join(
        f"{s[2]}x{s[3]} {'with' if loss else 'without'} the loss (C, R, "
        f"threads, pixels a thread, bytes a block) {shape}: {n}"
        for (s, loss), (n, shape) in occ.items()))

    # the streaming pair, per mode and storage
    for mode, tag, dtype in (("2d", "f32", torch.float32),
                             ("4d", "f32", torch.float32),
                             ("4d", "bf16", torch.bfloat16)):
        x0 = x32.to(dtype)
        rates = {}
        for plain in (True, False, False, True):
            r = _TGVRun(x0, mode, plain)
            rates.setdefault(plain, []).append(
                time_iterations(r.run, 5 if plain else 50, DEV,
                                warmup_iters=2 if plain else 5))
            del r
        it_s = {plain: max(v) for plain, v in rates.items()}
        r = _TGVRun(x0, mode, plain=False)
        dev_ms, _ = device_time(lambda: r.run(50), 50, DEV)
        x, xb, w, wb, p, q = r.st
        kw = dict(mode=mode, alpha1=1.0, alpha0=2.0)
        ms = {"pq": (_time_launch(lambda: tgv_stream.tgv_pq(xb, wb, p, q,
                                                            **kw)),
                     _time_launch(lambda: tgv_stream.tgv_pq_plain(
                         xb, wb, p, q, **kw), n=5)),
              "xw": (_time_launch(lambda: tgv_stream.tgv_xw(
                  x, x0, p, w, q, xb, wb, mode=mode)),
                  _time_launch(lambda: tgv_stream.tgv_xw_plain(
                      x, x0, p, w, q, xb, wb, mode=mode), n=5)),
              "obj": (_time_launch(lambda: tgv_stream.tgv_stream_objective(
                  x, w, x0, mode, 1.0, 2.0)),
                  _time_launch(lambda: tgv_objective(x, w, x0, mode, 1.0,
                                                     2.0), n=5))}
        del r, x, xb, w, wb, p, q
        b_pq, b_xw = tgv_traffic_model(MAIN_4D, mode, dtype)
        b_obj = tgv_objective_bytes(MAIN_4D, mode, dtype)
        gbs = {"pq": b_pq / ms["pq"][0] / 1e6, "xw": b_xw / ms["xw"][0] / 1e6,
               "obj": b_obj / ms["obj"][0] / 1e6}
        frac = roofline_fraction(b_pq + b_xw, it_s[False])
        log(f"[14 TGV rates {MAIN_4D}] {mode} stream (B6) {tag}: kernels "
            f"{it_s[False]:.1f} it/s = {(b_pq + b_xw) * it_s[False] / 1e9:.0f}"
            f" GB/s ({100 * frac:.1f}% of {H100_HBM_PEAK_GBPS:.0f}, minimal "
            f"model), device {dev_ms:.4f} ms/it (torch.profiler), idle "
            f"{100 * (1 - dev_ms * it_s[False] / 1e3):.1f}%, plain "
            f"{it_s[True]:.2f} it/s; per launch PQ "
            f"{ms['pq'][0]:.4f} ms ({gbs['pq']:.0f} GB/s, plain "
            f"{ms['pq'][1]:.3f} ms), XW {ms['xw'][0]:.4f} ms "
            f"({gbs['xw']:.0f} GB/s, plain {ms['xw'][1]:.3f} ms), "
            f"objective {ms['obj'][0]:.4f} ms ({gbs['obj']:.0f} GB/s, "
            f"{TGV_FIELDS[mode] + 2} planes; plain tgv_objective "
            f"{ms['obj'][1]:.3f} ms)")
        out[(mode, tag)] = ms
        sync()

    # where the whole-solve kernel stops paying: one more iteration of it
    # against one iteration of the streaming pair, both without the loss;
    # where the slice fits on chip, the L2 kernel beside it
    for shape in (CAMERAMAN, (1, 1, 1024, 1024), (8, 1, 1024, 1024),
                  MAIN_4D):
        gen = torch.Generator(device=DEV).manual_seed(7)
        x0 = torch.rand(shape, generator=gen, device=DEV)
        variant = tgv_resident.tgv_resident_variant(shape, True)
        whole = _marginal_ms(
            lambda n: solve(n, x=x0, compute_loss=False), 20, 120)
        with_loss = _marginal_ms(lambda n: solve(n, x=x0), 20, 120)
        l2 = ""
        if variant == "onchip":
            l2_ms = [_marginal_ms(lambda n: solve(n, x=x0, compute_loss=loss,
                                                  variant="l2"), 20, 120)
                     for loss in (False, True)]
            l2 = f"; L2 kernel {l2_ms[0]:.4f} / {l2_ms[1]:.4f}"
        plain_loss = _marginal_ms(lambda n: solve(n, plain=True, x=x0), 2, 6,
                                  repeats=1)
        r = _TGVRun(x0, "2d", plain=False)
        stream = 1e3 / time_iterations(r.run, 100, DEV)
        del r
        log(f"[14 whole solve vs stream, 2d f32] {shape} ({shape[0] * shape[1]}"
            f" slices): B7 ({variant}) {whole:.4f} ms/it without the loss, "
            f"{with_loss:.4f} with{l2}; B6 pair {stream:.4f} ms/it (no loss); "
            f"plain loop with the loss {plain_loss:.3f} ms/it")
        sync()

    # B7 as the main path calls it: cameraman, 300 iterations, with the loss,
    # on chip and in L2
    noisy = torch.as_tensor(add_noise(cameraman(), 100, seed=0),
                            dtype=torch.float32, device=DEV)[None, None]
    cam = {v: _best_ms(lambda: _b7_kernel(v, noisy, 300, 25.0, 50.0))
           for v in ("onchip", "l2")}
    b7_plain_ms = _best_ms(lambda: tgv_resident.tgv_resident_plain(
        noisy, 300, 25.0, 50.0), repeats=1)
    log(f"[14 B7 at cameraman] one 300-iteration solve with the loss: on chip "
        f"{cam['onchip']:.3f} ms ({300e3 / cam['onchip']:.0f} it/s), L2 "
        f"{cam['l2']:.3f} ms ({cam['l2'] / cam['onchip']:.2f}x), plain "
        f"{b7_plain_ms:.1f} ms ({300e3 / b7_plain_ms:.0f} it/s)")
    out["B7"] = (cam["onchip"], b7_plain_ms)
    out["B7l2"] = (cam["l2"], b7_plain_ms)

    # bounds from this run's inputs: B6 at MAIN_4D 4d f32 (one launch of
    # each pass), B7 at cameraman (x0 read, 12 planes of state written,
    # 300 iterations of all three phases), for both of its kernels
    ops_pq, ops_xw, ops_obj = tgv_ops_per_voxel(4)
    b_pq, b_xw = tgv_traffic_model(MAIN_4D, "4d", torch.float32)
    b7_bound = bound(13 * 4 * 256 * 256, 300 * ops2 * 256 * 256)
    out["bounds"] = {"B6pq": bound(b_pq, ops_pq * vox),
                     "B6xw": bound(b_xw, ops_xw * vox),
                     "B6obj": bound(tgv_objective_bytes(
                         MAIN_4D, "4d", torch.float32), ops_obj * vox),
                     "B7": b7_bound, "B7l2": b7_bound}
    # B6's bounds at every mode and storage timed above
    b6 = []
    for mode, dtype in (("2d", torch.float32), ("4d", torch.float32),
                        ("4d", torch.bfloat16)):
        o_pq, o_xw, o_obj = tgv_ops_per_voxel(TGV_FIELDS[mode])
        t_pq, t_xw = tgv_traffic_model(MAIN_4D, mode, dtype)
        t_obj = tgv_objective_bytes(MAIN_4D, mode, dtype)
        b6.append(f"{mode} {str(dtype)[6:]} PQ {bound(t_pq, o_pq * vox)[0]:.4f}"
                  f" ms, XW {bound(t_xw, o_xw * vox)[0]:.4f} ms, objective "
                  f"{bound(t_obj, o_obj * vox)[0]:.4f} ms")
    log(f"[14 B6 bounds] {MAIN_4D}, each array once over "
        f"{H100_HBM_PEAK_GBPS:.0f} GB/s (bytes set all): " + "; ".join(b6))
    log(f"[14 B7 bounds] cameraman 300-iteration solve: 13 planes "
        f"{13 * 4 * 256 * 256 / 1e6:.2f} MB, {300 * ops2 * 256 * 256 / 1e9:.3f}"
        f" Gflop -> {b7_bound[0]:.4f} ms ({b7_bound[1]}): on chip "
        f"{cam['onchip'] / b7_bound[0]:.0f}x, L2 {cam['l2'] / b7_bound[0]:.0f}x"
        f"; {MAIN_4D} {it_bound:.4f} ms/it: on chip "
        f"{b7[('onchip', True)] / it_bound:.1f}x, L2 "
        f"{b7[('l2', True)] / it_bound:.1f}x")
    return out


# ---------------------------------------------------------------- phase 15
def phase_tgv_north_star():
    gen = torch.Generator(device=DEV).manual_seed(0)
    noisy = torch.rand(NORTH_STAR, generator=gen, device=DEV).to(
        torch.bfloat16)
    sync()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(DEV)
    kw = dict(alpha1=1.0, alpha0=2.0, axes="4d", compute_loss=False)
    tgv_denoise(noisy, n_iter=2, **kw)  # warm-up
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    zero_counters()
    start.record()
    res = tgv_denoise(noisy, n_iter=10, **kw)
    end.record()
    sync()
    it_s = 10 / (start.elapsed_time(end) / 1e3)
    require(read_counters()["B6xw"] == 10, "the volume ran through B6")
    require(res.x.dtype == torch.bfloat16 and res.state.q.shape[1] == 10,
            "bf16 storage kept, 10 q channels")
    require(bool(torch.isfinite(res.x.float()).all()),
            "north-star TGV iterate finite")
    peak = torch.cuda.max_memory_allocated(DEV)
    traffic = sum(tgv_traffic_model(NORTH_STAR, "4d", torch.bfloat16))
    log(f"[15 real size TGV] {NORTH_STAR} bf16, axes='4d', "
        f"compute_loss=False, 10 iterations on the kernels: {it_s:.2f} it/s "
        f"(whole solver call, {traffic * it_s / 1e9:.0f} GB/s by the minimal "
        f"model), peak memory {peak / 1e9:.2f} GB")
    del res, noisy
    torch.cuda.empty_cache()
    sync()


# ---------------------------------------------------------------- phase 16
def _inverse_cases(shape):
    """(name, cfg, storage): phase 3's case grid without the cases B5 does
    not see (fidelity, nonneg, tmul); at the full CT width, what the CT
    main path launches: its config with an f32 and a bf16 dual."""
    if shape == CT_SHAPE:
        for storage in ("f32", "f32+bf16dual"):
            yield f"hybrid-time-{storage}", TVConfig(**CT_CFG), storage
        return
    for name, cfg, opts, storage in _cases():
        if not opts:
            yield name, cfg, storage


INVERSE_SHAPES = (SMALL, CAMERAMAN, MAIN_4D, CT_SMALL, CT_SHAPE)


def phase_inverse_kernels():
    """B5 against its plain version and bit for bit against B1 in halo
    mode (csrc/specialised_cp.cu, on a 1 x 1 grid, no time multiplier),
    over every channel table, at odd widths and off alignment; and B2
    writing out of place against its plain version and against itself in
    place, at the shapes of the earlier phases and at the two the CT main
    path launches them on."""
    reg, sigma_D = 0.5, 0.5
    errs = {"f32": 0.0, "bf16": 0.0}
    n = 0
    tids = set()
    for shape in (*INVERSE_SHAPES, *RAGGED, MISALIGNED):
        gen = torch.Generator(device=DEV).manual_seed(1357)
        copy = _shifted if shape == MISALIGNED else torch.clone
        for name, cfg, storage in _inverse_cases(shape):
            x, x0, y_A, y_D = map(copy, _state(shape, cfg, STORAGE[storage],
                                               gen, "l2"))
            x_before = x.clone()
            y_k, y_p, y_g = copy(y_D), y_D.clone(), y_D.clone()
            kw = dict(cfg=cfg, sigma_D=sigma_D, reg=reg)
            out_k, tv_k = fused.tv_dual(x, y_k, **kw)
            _, tv_p = fused.tv_dual_plain(x, y_p, **kw)
            fused.cp_dual(_one_shard(x, cfg, 1), x0, y_A, y_g, None,
                          sigma_A=1.0, halo_mode=True, table_dims=shape[:2],
                          **kw)
            sync()
            require(out_k is y_k and torch.equal(x, x_before),
                    "tv_dual updates y_D in place and leaves x_bar alone")
            require(_bits_equal(y_k, y_g), f"B5 {name} {shape}: specialised "
                    f"B5's y_D' equals B1's in halo mode bit for bit")
            tids.add(tables.table_id(cfg, *shape[:2]))
            bf16 = storage != "f32"
            kind = "bf16" if bf16 else "f32"
            errs[kind] = max(errs[kind], _compare(y_k, y_p, bf16, 0.0))
            rel = abs(float(tv_k.sum()) - float(tv_p.sum())) / float(tv_p.sum())
            require(rel <= 1e-5, f"B5 {name} {shape}: TV rel err {rel:.3g}")
            n += 1
    require(tids == set(range(len(tables.TABLES))),
            f"B5: every channel table launched, got {sorted(tids)}")
    log(f"[16 inverse kernels vs plain] B5: {n} cases at {SMALL}, "
        f"{CAMERAMAN}, {MAIN_4D}, {CT_SMALL}, (the CT path's config, f32 "
        f"and bf16 dual) {CT_SHAPE}, {RAGGED} and {MISALIGNED} (arrays one "
        f"element off alignment), all {len(tids)} channel tables: pass; "
        f"specialised B5 bit-equal to B1 in halo mode in every case; "
        f"max abs err f32 {errs['f32']:.3g} bf16 {errs['bf16']:.3g}")

    err_out, n_out = 0.0, 0
    cfg = TVConfig(**CT_CFG)
    for shape in INVERSE_SHAPES:
        gen = torch.Generator(device=DEV).manual_seed(2468)
        tau = default_tau(cfg, shape[0], shape[1])
        for storage in STORAGE:
            for nonneg in (False, True):
                x, _, y_A, y_D = _state(shape, cfg, STORAGE[storage], gen,
                                        "l1")  # y_A of both signs
                x_before = x.clone()
                kw = dict(cfg=cfg, tau=tau, nonneg=nonneg)
                # the inverse solver's call: x itself in the x0 slot
                out_k, _ = fused.cp_primal(x, x, y_A, y_D, out=torch.empty_like(x),
                                           **kw)
                out_p, _ = fused.cp_primal_plain(x, x, y_A, y_D,
                                                 out=torch.empty_like(x), **kw)
                sync()
                require(torch.equal(x, x_before), "out-of-place B2 leaves x")
                in_place, _ = fused.cp_primal(x.clone(), x, y_A, y_D, **kw)
                require(torch.equal(in_place, out_k),
                        "B2 out of place equals B2 in place, bit for bit")
                require(not nonneg or float(out_k.float().min()) >= 0.0,
                        "nonneg clamps x'")
                err_out = max(err_out, _compare(out_k, out_p,
                                                storage != "f32", reg))
                n_out += 1
                del x, x_before, y_A, y_D, out_k, out_p, in_place
    log(f"[16 inverse kernels vs plain] B2 out of place: {n_out} cases "
        f"(storage x nonneg) at the five shapes: pass, equal to in place "
        f"bit for bit; max abs err vs plain {err_out:.3g}")
    torch.cuda.empty_cache()
    sync()
    return errs


# ---------------------------------------------------------------- phase 17
def _blur(x):
    """A 3-tap periodic row blur: the JAX package's fused-inverse test
    operator."""
    return (x + torch.roll(x, 1, -1) + torch.roll(x, -1, -1)) / 3.0


def _phantom(shape, seed):
    """A seeded piecewise-constant phantom: a few discs per slice inside the
    inscribed circle, values in (0, 1], as float32 numpy."""
    rng = np.random.default_rng(seed)
    Nz, M, N, _ = shape
    r, c = np.mgrid[:N, :N]
    vol = np.zeros(shape, np.float32)
    for z in range(Nz):
        for _ in range(4):
            cr, cc = rng.uniform(0.3 * N, 0.7 * N, 2)
            rad = rng.uniform(0.05 * N, 0.15 * N)
            disc = (r - cr) ** 2 + (c - cc) ** 2 <= rad ** 2
            # the disc drifts over the frames: a dynamic object
            for m in range(M):
                vol[z, m] += rng.uniform(0.2, 0.5) * np.roll(disc, m, axis=1)
    return vol


INVERSE_TOL = dict(rtol=2e-5, atol=3e-6)  # the JAX fused-vs-jnp inverse bar
# a whole CT solve on the kernels against the plain step: tens of iterations
# of f32 round-off, and an adjoint whose atomic adds sum in an order that
# changes from run to run: ten times the per-step bar
CT_SOLVE_TOL = dict(rtol=2e-4, atol=3e-5)


def phase_inverse_main_path():
    rng = np.random.default_rng(0)
    truth = torch.as_tensor(rng.random(SMALL), dtype=torch.float32,
                            device=DEV)
    b = _blur(truth) + 0.05 * torch.as_tensor(
        rng.standard_normal(SMALL), dtype=torch.float32, device=DEV)
    worst, n = 0.0, 0
    for cfg in [TVConfig(scheme=s, reg_time=0.5) for s in SCHEMES] + [
            TVConfig(scheme="hybrid", reg_time=0.5, norm=norm)
            for norm in ("aniso", "huber")]:
        kw = dict(n_iter=8, reg=0.05, op_norm=1.0, cfg=cfg)
        zero_counters()
        got = cp_inverse(_blur, b, SMALL, fused=True, **kw)
        sync()
        require_launches(read_counters(), "cp_inverse fused", B5=8, B2=8,
                         B3=8)
        ref = cp_inverse(_blur, b, SMALL, fused=False, **kw)
        sync()
        for name in ("x", "x_bar", "y_A", "y_D"):
            worst = max(worst, _compare(getattr(got.state, name),
                                        getattr(ref.state, name), False, 0.0,
                                        INVERSE_TOL))
        rel = float(((got.loss - ref.loss).abs() / ref.loss.abs()).max())
        require(rel <= INVERSE_TOL["rtol"],
                f"cp_inverse {cfg.scheme} {cfg.norm}: loss rel err {rel:.3g}")
        n += 1
    log(f"[17 inverse main path] cp_inverse(3-tap blur, {SMALL}, 8 "
        f"iterations) on the kernels vs the plain step, both on the card: "
        f"{n} configs within rtol {INVERSE_TOL['rtol']} atol "
        f"{INVERSE_TOL['atol']} on x, x_bar, y_A, y_D and the loss; max abs "
        f"err {worst:.3g}")

    shape, n_angles, n_iter, loss_every = CT_SMALL, 24, 60, 3
    truth = _phantom(shape, seed=0)
    angles = np.linspace(0.0, np.pi, n_angles, endpoint=False)
    sino = radon(truth, angles).cpu().numpy()
    sino += 0.5 * np.random.default_rng(1).standard_normal(
        sino.shape).astype(np.float32)
    kw = dict(n_iter=n_iter, reg=0.2, nonneg=True, loss_every=loss_every,
              cfg=TVConfig(**CT_CFG), method="gather")
    zero_counters()
    res = cp_reconstruct(sino, angles, shape, **kw)  # numpy in, no device=
    sync()
    launches = read_counters()
    require_launches(launches, "cp_reconstruct", B5=n_iter, B2=n_iter,
                     B3=n_iter // loss_every)
    require(res.x.is_cuda and tuple(res.x.shape) == shape
            and res.x.dtype == torch.float32 and res.loss.is_cuda
            and tuple(res.loss.shape) == (n_iter // loss_every,),
            "numpy inputs are reconstructed on the card")
    require(bool(torch.isfinite(res.x).all()) and float(res.x.min()) >= 0.0,
            "the reconstruction is finite and nonnegative")
    half = res.loss[len(res.loss) // 2:]
    require(bool((half[1:] <= half[:-1]).all()),
            "the loss falls monotonically over the last half of the run")
    ref = cp_reconstruct(sino, angles, shape, fused=False, **kw)
    sync()
    rel = abs(float(res.loss[-1]) - float(ref.loss[-1])) / float(ref.loss[-1])
    err = _compare(res.x, ref.x, False, 0.0, CT_SOLVE_TOL)
    require(rel <= 1e-4, f"cp_reconstruct fused vs plain final loss {rel:.3g}")
    t = torch.as_tensor(truth, device=DEV)
    nrmse = float(torch.linalg.norm(res.x - t) / torch.linalg.norm(t))
    require(nrmse < 0.35, f"the phantom is recovered (nrmse {nrmse:.3f})")
    log(f"[17 inverse main path] cp_reconstruct(numpy sinogram, {shape} x "
        f"{n_angles} angles, n_iter={n_iter}, loss_every={loss_every}, "
        f"nonneg) on {res.x.device}: launches {launches}; loss "
        f"{float(res.loss[0]):.2f} -> {float(res.loss[-1]):.2f}, falling "
        f"over the last half; fused vs plain x max abs err {err:.3g}, final "
        f"loss rel {rel:.3g}; nrmse vs the phantom {nrmse:.3f}")
    sync()
    return launches


# ---------------------------------------------------------------- phase 18
def _ct_problem(shape, n_angles, seed):
    """The angles and the noisy sinogram of a seeded volume on the card."""
    gen = torch.Generator(device=DEV).manual_seed(seed)
    vol = torch.rand(shape, generator=gen, device=DEV)
    angles = np.linspace(0.0, np.pi, n_angles, endpoint=False)
    sino = radon(vol, angles)
    sino += 0.5 * torch.randn(sino.shape, generator=gen, device=DEV)
    return angles, sino


def phase_ct_full_width(card):
    cfg = TVConfig(scheme="hybrid", reg_time=0.5)
    Nd = num_channels(cfg.scheme, CT_SHAPE[0], CT_SHAPE[1],
                      cfg.reg_z_over_reg, cfg.reg_time)
    vox = int(np.prod(CT_SHAPE))
    angles, sino = _ct_problem(CT_SHAPE, CT_ANGLES, seed=0)
    A, A_T = make_projector(CT_SHAPE, angles, method="gather")
    op_norm = float(estimate_op_norm(A, A_T, CT_SHAPE, device=DEV))
    n_iter, reg = 30, 0.5
    kw = dict(n_iter=n_iter, reg=reg, cfg=cfg, nonneg=True, op_norm=op_norm,
              method="gather")

    def solve(**more):
        return cp_reconstruct(sino, angles, CT_SHAPE, **kw, **more)

    zero_counters()
    res = solve()
    sync()
    require_launches(read_counters(), "full-width cp_reconstruct",
                     B5=n_iter, B2=n_iter, B3=n_iter)
    require(bool(torch.isfinite(res.loss).all())
            and float(res.loss[-1]) < float(res.loss[0]),
            "full-width losses finite and falling")
    fused_loss = float(res.loss[-1])
    st = res.state
    del res
    ms = {"fused": _best_ms(solve) / n_iter,
          "bf16 dual": _best_ms(lambda: solve(dual_dtype="bfloat16"))
          / n_iter}
    plain = solve(fused=False)
    rel = abs(fused_loss - float(plain.loss[-1])) / float(plain.loss[-1])
    require(rel <= 1e-4, f"full-width fused vs plain final loss {rel:.3g}")
    err_state = {name: _compare(getattr(st, name), getattr(plain.state, name),
                                False, 0.0, CT_SOLVE_TOL)
                 for name in ("x", "x_bar", "y_A", "y_D")}
    del plain
    ms["plain"] = _best_ms(lambda: solve(fused=False), repeats=2) / n_iter
    dev_ms, _ = device_time(solve, n_iter, DEV)
    log(f"[18 CT full width] cp_reconstruct({CT_SHAPE} f32 x {CT_ANGLES} "
        f"angles, n_det {CT_SHAPE[-1]}, hybrid reg_time=0.5, nonneg, {n_iter} "
        f"iterations, op_norm {op_norm:.2f} from estimate_op_norm): kernels "
        f"{1e3 / ms['fused']:.2f} it/s ({ms['fused']:.2f} ms/it), bf16 dual "
        f"{1e3 / ms['bf16 dual']:.2f} it/s, plain step "
        f"{1e3 / ms['plain']:.2f} it/s (best of 3, 2 for plain, CUDA "
        f"events, whole call); fused vs plain final loss rel {rel:.3g}, "
        f"final state within rtol {CT_SOLVE_TOL['rtol']} atol "
        f"{CT_SOLVE_TOL['atol']}: max abs err "
        + ", ".join(f"{k} {v:.3g}" for k, v in err_state.items()) + "; "
        f"device {dev_ms:.2f} ms/it (torch.profiler), idle "
        f"{100 * (1 - dev_ms / ms['fused']):.1f}%; card {card}")

    # the split of one fused iteration, each part alone on the final state
    sigma = 1.0 / np.sqrt(op_norm ** 2 + operator_norm_bound_sq(
        cfg.scheme, CT_SHAPE[0], CT_SHAPE[1], cfg.reg_z_over_reg,
        cfg.reg_time))
    x, x_bar, y_A = st.x, st.x_bar, st.y_A
    y_D = fused.to_internal_layout(st.y_D)
    at, out = A_T(y_A), torch.empty_like(x)
    fw = torch.ones((), device=DEV)

    def loss():
        _, parts = fused.tv_norms(x, cfg=cfg)
        return torch.add(fidelity_loss(st.s_x, sino, "l2", fw),
                         torch.sum(parts), alpha=reg)

    def rest():  # fidelity dual prox, x_bar and the projection's rewrite
        fidelity_dual_prox(y_A, st.s_x_bar, sino, sigma, "l2", fw)
        torch.mul(out, 2.0, out=x_bar).sub_(x)
        return 2.0 * st.s_x - st.s_x_bar

    split = {
        "A": _time_launch(lambda: A(x), n=5),
        "A_T": _time_launch(lambda: A_T(y_A), n=5),
        "B5": _time_launch(lambda: fused.tv_dual(x_bar, y_D, cfg=cfg,
                                                 sigma_D=sigma, reg=reg)),
        "B2": _time_launch(lambda: fused.cp_primal(
            x, x, at, y_D, cfg=cfg, tau=sigma, nonneg=True, out=out)),
        "B3 + loss": _time_launch(loss),
        "prox, x_bar, 2s - s": _time_launch(rest)}
    b5_bytes = (1 + 2 * Nd) * 4 * vox
    other = ms["fused"] - sum(split.values())
    log(f"[18 CT full width] one iteration {ms['fused']:.3f} ms = "
        + " + ".join(f"{k} {v:.3f}" for k, v in split.items())
        + f" + unaccounted {other:.3f} ms; B5 {split['B5']:.4f} ms = "
        f"{b5_bytes / split['B5'] / 1e6:.0f} GB/s "
        f"({100 * b5_bytes / split['B5'] / 1e6 / H100_HBM_PEAK_GBPS:.1f}% of "
        f"{H100_HBM_PEAK_GBPS:.0f}), bound "
        f"{bound(b5_bytes, 10 * Nd * vox)[0]:.4f} ms")
    del st, x, x_bar, y_A, y_D, at, out, sino
    torch.cuda.empty_cache()

    # B5's row of the kernel table, where B1's and B2's times were taken
    Nd4 = num_channels(cfg.scheme, MAIN_4D[0], MAIN_4D[1],
                       cfg.reg_z_over_reg, cfg.reg_time)
    gen = torch.Generator(device=DEV).manual_seed(0)
    x4 = torch.rand(MAIN_4D, generator=gen, device=DEV)
    y4 = torch.zeros((MAIN_4D[0], MAIN_4D[1], Nd4) + MAIN_4D[2:], device=DEV)
    k4 = dict(cfg=cfg, sigma_D=0.5, reg=1.0)
    b5_ms = (_time_launch(lambda: fused.tv_dual(x4, y4, **k4)),
             _time_launch(lambda: fused.tv_dual_plain(x4, y4, **k4), n=10))
    vox4 = int(np.prod(MAIN_4D))
    b5_bound = bound((1 + 2 * Nd4) * 4 * vox4, 10 * Nd4 * vox4)
    log(f"[18 B5 per launch, f32 {MAIN_4D}] {b5_ms[0]:.4f} ms (plain "
        f"{b5_ms[1]:.3f} ms), "
        f"{(1 + 2 * Nd4) * 4 * vox4 / b5_ms[0] / 1e6:.0f} GB/s, bound "
        f"{b5_bound[0]:.4f} ms by {b5_bound[1]}")
    sync()
    return op_norm, b5_ms, b5_bound


# ---------------------------------------------------------------- phase 19
def phase_ct_capacity(op_norm):
    """Whether the (96, 16, 512, 512) x 96-angle TV reconstruction fits the
    one card: three iterations with a bf16 dual.  Every slice has phase
    18's geometry, so the projector's norm is phase 18's."""
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(DEV)
    angles, sino = _ct_problem(NORTH_STAR, CT_ANGLES, seed=1)
    kw = dict(reg=0.5, cfg=TVConfig(scheme="hybrid", reg_time=0.5),
              nonneg=True, op_norm=op_norm, dual_dtype="bfloat16",
              method="gather")
    cp_reconstruct(sino, angles, NORTH_STAR, n_iter=1, **kw)  # warm-up
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    zero_counters()
    start.record()
    res = cp_reconstruct(sino, angles, NORTH_STAR, n_iter=3, **kw)
    end.record()
    sync()
    require_launches(read_counters(), "capacity cp_reconstruct", B5=3, B2=3,
                     B3=3)
    require(bool(torch.isfinite(res.loss).all())
            and float(res.loss[-1]) < float(res.loss[0]),
            "capacity losses finite and falling")
    peak = torch.cuda.max_memory_allocated(DEV)
    log(f"[19 CT capacity] cp_reconstruct({NORTH_STAR} f32 x {CT_ANGLES} "
        f"angles, bf16 dual, 3 iterations): "
        f"{start.elapsed_time(end) / 3e3:.2f} s per iteration (whole call), "
        f"peak memory {peak / 1e9:.2f} GB of "
        f"{torch.cuda.get_device_properties(DEV).total_memory / 1e9:.1f}, "
        f"final loss {float(res.loss[-1]):.6g}")
    del res, sino
    torch.cuda.empty_cache()
    sync()

# ---------------------------------------------------------------- phase 20
# B9 over 20 iterations against the plain loop: ten times the per-call bar
# (F32_TOL), as B7 is held; each loss to 1e-5
RESIDENT_TOL = dict(atol=2e-5, rtol=1e-4)
RESIDENT_SHAPES = ((1, 1, 64, 64), CAMERAMAN, (4, 2, 64, 64), (3, 1, 32, 128))


def _resident_state(shape, cfg, gen):
    Nz, M, Nr, Nc = shape
    Nd = num_channels(cfg.scheme, Nz, M, cfg.reg_z_over_reg, cfg.reg_time)
    x0 = torch.rand(shape, generator=gen, device=DEV)
    x = x0 + 0.1 * torch.rand(shape, generator=gen, device=DEV)
    y_A = 0.1 * torch.randn(shape, generator=gen, device=DEV)
    y_D = 0.1 * torch.randn((Nz, Nd, M, Nr, Nc), generator=gen, device=DEV)
    return x0, x, y_A, y_D


def _b9_kwargs(solver, cfg, shape):
    if solver == "cp":
        return dict(reg=0.4, sigma_D=0.5, sigma_A=1.0,
                    tau=default_tau(cfg, shape[0], shape[1]))
    return dict(reg=0.4, step_size=1e-2)


def _b9_kernel(variant, solver, cfg, state, n, kw):
    """One launch of the named B9 kernel ("onchip" or "l2") on copies of
    ``state`` (x0, x[, y_A, y_D] in the public layout), as the factories
    launch the one resident_variant names: ``(x, y_A, y_D, losses)`` for
    CP, ``(x, losses)`` for GD."""
    x0, x = state[:2]
    kernel = (resident.solve_onchip if variant == "onchip"
              else resident.solve_l2)
    p = resident.solver_params(solver, cfg, tuple(x0.shape), **kw)
    if solver == "cp":
        st = (x.clone(), state[2].clone(), fused.to_internal_layout(state[3]))
        losses = kernel("cp", cfg, x0, p, n, st)
        return (st[0], st[1],
                fused.from_internal_layout(st[2]).contiguous(), losses)
    bufs = (x.clone(), torch.empty_like(x))
    losses = kernel("gd", cfg, x0, p, n, bufs)
    return bufs[n % 2], losses


def _b9_solve(solver, cfg, shape, state, n, variant=None):
    """An n-iteration CP or GD solve of ``state``: through the factory
    (``variant`` None: the kernel resident_variant names) or one launch of
    the named kernel; and which kernel ran."""
    x0, x, y_A, y_D = state
    kw = _b9_kwargs(solver, cfg, shape)
    before = read_counters()
    if variant is not None:
        out = _b9_kernel(variant, solver, cfg, state, n, kw)
    elif solver == "cp":
        out = resident.make_resident_cp_solver(
            cfg, shape, n, "float32", **kw)(x0, x, y_A, y_D)
    else:
        out = resident.make_resident_gd_solver(
            cfg, shape, n, "float32", **kw)(x0, x)
    after = read_counters()
    ran = {(1, 0): "onchip", (0, 1): "l2"}.get(
        (after["B9onchip"] - before["B9onchip"],
         after["B9l2"] - before["B9l2"]))
    return out, ran


def _b9_plain(solver, cfg, shape, state, n):
    x0, x, y_A, y_D = state
    kw = _b9_kwargs(solver, cfg, shape)
    if solver == "cp":
        return resident.resident_cp_plain(x0, x, y_A, y_D, n, cfg=cfg, **kw)
    return resident.resident_gd_plain(x0, x, n, cfg=cfg, **kw)


def _b9_case(solver, cfg, shape, state, errs, sms, n=20):
    """The solve with the kernel resident_variant names -- which must be
    the one that ran -- against its plain loop; where that is the on-chip
    kernel, also with the L2 kernel, which must give the same state bit for
    bit and the losses to 1e-6.  Returns the variant."""
    want = resident.resident_variant(shape, cfg, solver, sms)
    out, ran = _b9_solve(solver, cfg, shape, state, n)
    require(ran == want, f"B9{solver} {shape} {cfg}: resident_variant names "
                         f"{want}, the launch ran {ran}")
    runs = {want: out}
    if want == "onchip":
        runs["l2"], ran = _b9_solve(solver, cfg, shape, state, n, "l2")
        require(ran == "l2", "solve_l2 launches the L2 kernel")
        require(all(_bits_equal(a, b) for a, b in zip(
            runs["onchip"][:-1], runs["l2"][:-1])),
            f"B9{solver} {shape} {cfg} n_iter={n}: the on-chip state equals "
            f"the L2 kernel's bit for bit")
        rel = float(((runs["onchip"][-1] - runs["l2"][-1]).abs()
                     / runs["l2"][-1].abs()).max())
        require(rel <= 1e-6, f"B9{solver} {shape}: on-chip losses within "
                             f"1e-6 of the L2 kernel's, got {rel:.3g}")
    ref = _b9_plain(solver, cfg, shape, state, n)
    for variant, got in runs.items():
        key = f"B9{solver}" + ("l2" if variant == "l2" else "")
        for g, r in zip(got[:-1], ref[:-1]):
            errs[key] = max(errs[key], _compare(g, r, False, 0.0,
                                                RESIDENT_TOL))
        rel = float(((got[-1] - ref[-1]).abs() / ref[-1].abs()).max())
        require(rel <= 1e-5, f"{key} {shape} {cfg}: losses rel err "
                             f"{rel:.3g}")
    return want


# volumes whose bands do not fit the chip's shared memory: CP takes the L2
# kernel at both, GD at the second (resident_variant)
RESIDENT_L2_SHAPES = ((8, 4, 128, 128), (16, 4, 64, 128))
# with RESIDENT_SHAPES under the four schemes, these reach every channel
# table the on-chip kernels instantiate (the 21 of csrc/tables.cuh): t
# alone (Nz = 1, M = 2 and 3), z and t with M = 3, and Nz = 2
RESIDENT_TABLE_SHAPES = ((1, 3, 64, 64), (1, 2, 64, 64), (3, 3, 32, 64),
                         (2, 1, 32, 64), (2, 2, 32, 64), (2, 3, 32, 64))


def phase_resident_kernels():
    errs = dict.fromkeys(("B9cp", "B9gd", "B9cpl2", "B9gdl2"), 0.0)
    sms = torch.cuda.get_device_properties(DEV).multi_processor_count
    n, chosen, met = 0, {}, {"cp": set(), "gd": set()}
    zero_counters()

    def case(shape, cfg, n_iter=20, seed=5):
        gen = torch.Generator(device=DEV).manual_seed(seed)
        state = _resident_state(shape, cfg, gen)
        for solver in ("cp", "gd"):
            v = _b9_case(solver, cfg, shape, state, errs, sms, n_iter)
            chosen[v] = chosen.get(v, 0) + 1
            if v == "onchip":
                met[solver].add(tables.table_id(cfg, shape[0], shape[1]))

    for shape in RESIDENT_SHAPES:
        for scheme in SCHEMES:
            for norm in ("iso", "aniso", "huber"):
                case(shape, TVConfig(scheme=scheme, reg_time=0.5, norm=norm,
                                     huber_delta=0.3))
                n += 1
    for shape in RESIDENT_TABLE_SHAPES:
        for scheme in SCHEMES:
            case(shape, TVConfig(scheme=scheme, reg_time=0.5))
            n += 1
    # one and two iterations: the first halo is the only exchange a
    # one-iteration solve makes, and under upwind and downwind a block never
    # waits for one of its neighbours
    for shape in (CAMERAMAN, (4, 2, 64, 64)):
        for scheme in SCHEMES:
            for n_iter in (1, 2):
                case(shape, TVConfig(scheme=scheme, reg_time=0.5), n_iter, 7)
                n += 1
    require(met["cp"] == met["gd"] == set(range(len(tables.TABLES))),
            f"phase 20 holds the on-chip kernel of every table against the "
            f"L2 kernel: CP met {sorted(met['cp'])}, GD {sorted(met['gd'])}")
    cfg = TVConfig(scheme="hybrid", reg_time=0.5)
    at_l2 = {}
    for shape in RESIDENT_L2_SHAPES:
        gen = torch.Generator(device=DEV).manual_seed(5)
        state = _resident_state(shape, cfg, gen)
        at_l2[shape] = tuple(_b9_case(s, cfg, shape, state, errs, sms)
                             for s in ("cp", "gd"))
    require(at_l2 == {(8, 4, 128, 128): ("l2", "onchip"),
                      (16, 4, 64, 128): ("l2", "l2")},
            f"the L2 kernels serve the volumes the chip cannot hold: {at_l2}")
    launches = read_counters()
    for make in (resident.make_resident_cp_solver,
                 resident.make_resident_gd_solver):
        require(not resident.resident_fits(NORTH_STAR, cfg),
                "resident_fits refuses the north-star volume")
        try:
            make(cfg, NORTH_STAR, 3)
        except ValueError:
            pass
        else:
            require(False, "a volume outside resident_fits raises")
    log(f"[20 B9 vs plain] {n} cases x (CP, GD), 20 iterations at "
        f"{RESIDENT_SHAPES} (every scheme and norm) and "
        f"{RESIDENT_TABLE_SHAPES} (every scheme), 1 and 2 at {CAMERAMAN} and "
        f"(4, 2, 64, 64) ({sms} SMs): the kernel resident_variant names "
        f"ran in every case ({chosen}); each on-chip state equal to the L2 "
        f"kernel's bit for bit, losses within 1e-6, over all "
        f"{len(met['cp'])} channel tables; at {RESIDENT_L2_SHAPES} "
        f"CP / GD took {list(at_l2.values())}; launches on chip "
        f"{launches['B9onchip']}, in L2 {launches['B9l2']}; max abs err vs "
        f"plain: on chip CP state {errs['B9cp']:.3g}, GD x "
        f"{errs['B9gd']:.3g}, L2 {errs['B9cpl2']:.3g} / {errs['B9gdl2']:.3g}; "
        f"a volume outside resident_fits raises")
    sync()
    return errs


# ---------------------------------------------------------------- phase 21
def phase_resident_main_path(card):
    noisy = add_noise(cameraman(), 100, seed=0).astype(np.float32)[None, None]
    require(isinstance(noisy, np.ndarray) and noisy.shape == CAMERAMAN,
            "the input is a numpy volume")
    cfg = TVConfig()
    Nd = num_channels(cfg.scheme, 1, 1, cfg.reg_z_over_reg, cfg.reg_time)
    tau = default_tau(cfg, 1, 1)
    cp_solve = resident.make_resident_cp_solver(
        cfg, CAMERAMAN, 300, "float32", reg=25.0, sigma_D=0.5, sigma_A=1.0,
        tau=tau)
    gd_solve = resident.make_resident_gd_solver(
        cfg, CAMERAMAN, 300, "float32", reg=25.0, step_size=5e-3)
    zeros = np.zeros(CAMERAMAN, np.float32)
    y_D0 = np.zeros((1, Nd, 1, 256, 256), np.float32)
    cp_solve(noisy, noisy, zeros, y_D0)  # builds nothing new; warms the call
    sync()

    zero_counters()
    x, y_A, y_D, losses = cp_solve(noisy, noisy, zeros, y_D0)  # numpy in
    sync()
    cp_launches = read_counters()
    require_launches(cp_launches, "make_resident_cp_solver", B9cp=1,
                     B9onchip=1)
    zero_counters()
    gx, glosses = gd_solve(noisy, noisy)
    sync()
    gd_launches = read_counters()
    require_launches(gd_launches, "make_resident_gd_solver", B9gd=1,
                     B9onchip=1)
    for t, shape in ((x, CAMERAMAN), (y_D, (1, Nd, 1, 256, 256)),
                     (gx, CAMERAMAN), (losses, (300,)), (glosses, (300,))):
        require(t.is_cuda and tuple(t.shape) == shape
                and t.dtype == torch.float32
                and bool(torch.isfinite(t).all()),
                f"a numpy volume is solved on the card: {shape} float32")
    rel_cp = abs(float(losses[-1]) - CAMERAMAN_LOSS) / CAMERAMAN_LOSS
    rel_gd = abs(float(glosses[-1]) - CAMERAMAN_GD_LOSS) / CAMERAMAN_GD_LOSS
    require(rel_cp < 1e-4, f"B9 cameraman CP loss within 1e-4, got {rel_cp:.3g}")
    require(rel_gd < 1e-4, f"B9 cameraman GD loss within 1e-4, got {rel_gd:.3g}")

    # against the host loops over B1 + B2 and B3 + B4 (the same per-voxel
    # code, so only the order of the loss sums differs): losses to 1e-5
    # over the whole trajectory, the final CP iterate to the 20-iteration
    # bar; GD, which is nonsmooth, on the losses alone
    x0 = torch.as_tensor(noisy, device=DEV)
    host_cp = chambolle_pock(x0, n_iter=300, reg=25.0, cfg=cfg)
    host_gd = subgradient_descent(x0, n_iter=300, reg=25.0, step_size=5e-3,
                                  cfg=cfg)
    traj_cp = float(((losses - host_cp.loss).abs() / host_cp.loss).max())
    traj_gd = float(((glosses - host_gd.loss).abs() / host_gd.loss).max())
    require(traj_cp < 1e-5 and traj_gd < 1e-4,
            f"B9 trajectories follow the host loops: CP {traj_cp:.3g}, GD "
            f"{traj_gd:.3g}")
    err_x = _compare(x, host_cp.x, False, 0.0, RESIDENT_TOL)
    err_gx = float((gx - host_gd.x).abs().max())
    log(f"[21 B9 main path] make_resident_cp_solver / _gd_solver(cameraman "
        f"numpy, 300 iterations) on {x.device}: CP loss {float(losses[-1]):.2f}"
        f" (rel err {rel_cp:.3g} vs {CAMERAMAN_LOSS}), GD loss "
        f"{float(glosses[-1]):.2f} (rel err {rel_gd:.3g} vs "
        f"{CAMERAMAN_GD_LOSS}); launches CP {cp_launches}, GD {gd_launches}; "
        f"vs the host loops: loss trajectories {traj_cp:.3g} / {traj_gd:.3g}, "
        f"max abs err of x {err_x:.3g} / {err_gx:.3g}")

    # times: one 300-iteration solve each way (CUDA events, best of 3), the
    # kernel resident_variant names (on chip) and the L2 kernel in turns
    st = [x0, x0, torch.zeros_like(x0), torch.as_tensor(y_D0, device=DEV)]
    cp_kw = dict(reg=25.0, sigma_D=0.5, sigma_A=1.0, tau=tau)
    gd_kw = dict(reg=25.0, step_size=5e-3)

    def cp_l2(*state):
        return _b9_kernel("l2", "cp", cfg, state, 300, cp_kw)

    def gd_l2(*state):
        return _b9_kernel("l2", "gd", cfg, state, 300, gd_kw)

    turns = {"cp": [], "gd": [], "cp_l2": [], "gd_l2": []}
    for _ in range(2):
        turns["cp"].append(_best_ms(lambda: cp_solve(*st)))
        turns["cp_l2"].append(_best_ms(lambda: cp_l2(*st)))
        turns["gd"].append(_best_ms(lambda: gd_solve(x0, x0)))
        turns["gd_l2"].append(_best_ms(lambda: gd_l2(x0, x0)))
    b9cp, b9gd, b9cp_l2, b9gd_l2 = (min(turns[k]) for k in (
        "cp", "gd", "cp_l2", "gd_l2"))
    loop_cp = _best_ms(lambda: chambolle_pock(x0, n_iter=300, reg=25.0,
                                              cfg=cfg))
    loop_gd = _best_ms(lambda: subgradient_descent(
        x0, n_iter=300, reg=25.0, step_size=5e-3, cfg=cfg))
    plain_cp = _best_ms(lambda: resident.resident_cp_plain(
        *st, 300, cfg=cfg, reg=25.0, sigma_D=0.5, sigma_A=1.0, tau=tau),
        repeats=1)
    plain_gd = _best_ms(lambda: resident.resident_gd_plain(
        x0, x0, 300, cfg=cfg, reg=25.0, step_size=5e-3), repeats=1)
    log(f"[21 B9 at cameraman] 300 iterations, ms per iteration: CP B9 "
        f"on chip {b9cp / 300:.5f} (one launch, {b9cp:.3f} ms), in L2 "
        f"{b9cp_l2 / 300:.5f} ({b9cp_l2:.3f} ms), host loop over B1 + B2 "
        f"{loop_cp / 300:.5f}, plain loop {plain_cp / 300:.4f}; GD B9 on "
        f"chip {b9gd / 300:.5f} ({b9gd:.3f} ms), in L2 {b9gd_l2 / 300:.5f} "
        f"({b9gd_l2:.3f} ms), host loop over B3 + B4 {loop_gd / 300:.5f}, "
        f"plain loop {plain_gd / 300:.4f}; card {card}")
    # the floors the probe measures (tools/torch_probe_resident.py): the L2
    # kernel with its passes emptied, and the on-chip exchange alone at the
    # on-chip launch's blocks and edge rows
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import torch_probe_resident as probe

    fl_cp, fl_gd, fl_blocks, fl_threads = probe.empty_pass_floor(CAMERAMAN,
                                                                cfg)
    blocks, R, _ = resident.onchip_band(CAMERAMAN, cfg)
    exch = probe.exchange_floors(probe.sync_library(), blocks, 256)
    log(f"[21 B9 floors at cameraman] the L2 kernel's barriers and block "
        f"sums alone ({fl_blocks} x {fl_threads}): CP {fl_cp:.5f}, GD "
        f"{fl_gd:.5f} ms/it; the on-chip exchange alone ({blocks} bands of "
        f"{R} rows): " + ", ".join(f"{k} {v:.5f}" for k, v in exch.items())
        + " ms/it")
    # the coupled case: z and t channels, 8 channels
    cfg4 = TVConfig(scheme="hybrid", reg_time=0.5)
    shape4 = (4, 2, 64, 64)
    gen = torch.Generator(device=DEV).manual_seed(3)
    v0 = 100.0 * torch.rand(shape4, generator=gen, device=DEV)
    Nd4 = num_channels(cfg4.scheme, 4, 2, cfg4.reg_z_over_reg, cfg4.reg_time)
    solve4 = resident.make_resident_cp_solver(
        cfg4, shape4, 300, "float32", reg=25.0, sigma_D=0.5, sigma_A=1.0,
        tau=default_tau(cfg4, 4, 2))
    st4 = [v0, v0, torch.zeros_like(v0),
           torch.zeros((4, Nd4, 2, 64, 64), device=DEV)]
    gsolve4 = resident.make_resident_gd_solver(
        cfg4, shape4, 300, "float32", reg=25.0, step_size=5e-3)
    cp_kw4 = dict(cp_kw, tau=default_tau(cfg4, 4, 2))

    def l2_4(*state):
        return _b9_kernel("l2", "cp", cfg4, state, 300, cp_kw4)

    def gl2_4(*state):
        return _b9_kernel("l2", "gd", cfg4, state, 300, gd_kw)

    require(resident.resident_variant(shape4, cfg4) == "onchip"
            and resident.resident_variant(shape4, cfg4, "gd") == "onchip",
            "the coupled case takes the on-chip kernels")
    b9_4 = min(_best_ms(lambda: solve4(*st4)) for _ in range(2))
    b9l2_4 = min(_best_ms(lambda: l2_4(*st4)) for _ in range(2))
    g9_4 = min(_best_ms(lambda: gsolve4(v0, v0)) for _ in range(2))
    g9l2_4 = min(_best_ms(lambda: gl2_4(v0, v0)) for _ in range(2))
    loop_4 = _best_ms(lambda: chambolle_pock(v0, n_iter=300, reg=25.0,
                                             cfg=cfg4))
    log(f"[21 B9 coupled {shape4} hybrid reg_time=0.5, Nd={Nd4}] ms/it: CP "
        f"B9 on chip {b9_4 / 300:.5f}, in L2 {b9l2_4 / 300:.5f}, host loop "
        f"over B1 + B2 {loop_4 / 300:.5f}; GD B9 on chip {g9_4 / 300:.5f}, "
        f"in L2 {g9l2_4 / 300:.5f}")

    vox = 256 * 256
    bounds = {
        # x0 and the start state read, the end state written; per voxel and
        # iteration B1's + B2's operations (CP), B3's + B4's + 6 for the
        # update and the loss term (GD)
        "B9cp": bound((1 + 2 * (2 + Nd)) * 4 * vox,
                      300 * ((10 * Nd + 10) + (4 * Nd + 8)) * vox),
        "B9gd": bound(3 * 4 * vox,
                      300 * ((4 * Nd + 4) + (10 * Nd + 2) + 6) * vox)}
    bounds["B9cpl2"], bounds["B9gdl2"] = bounds["B9cp"], bounds["B9gd"]
    sync()
    return ({"B9cp": cp_launches["B9onchip"], "B9gd": gd_launches["B9onchip"],
             "B9cpl2": cp_launches["B9l2"], "B9gdl2": gd_launches["B9l2"]},
            {"B9cp": (b9cp, plain_cp), "B9gd": (b9gd, plain_gd),
             "B9cpl2": (b9cp_l2, plain_cp), "B9gdl2": (b9gd_l2, plain_gd)},
            bounds)


# ---------------------------------------------------------------- phase 22
ZSTREAM_ATOL = 3e-7  # the JAX bar between its two pass-A kernels


def _zstream_cases():
    """(shape, cfg, fidelity keywords, storage): the cases of the JAX
    package's zstream tests, odd extents, bf16 storage and the two real
    sizes."""
    hyb = dict(scheme="hybrid", reg_time=0.5)
    for scheme in SCHEMES:
        yield (4, 2, 16, 128), TVConfig(scheme=scheme, reg_time=0.5), {}, "f32"
    yield (4, 2, 512, 128), TVConfig(**hyb), {}, "f32"
    yield (4, 2, 16, 128), TVConfig(**hyb), {}, "f32+bf16dual"
    yield (4, 2, 16, 128), TVConfig(**hyb), dict(fidelity="l1",
                                                 fid_weight=0.7), "f32"
    yield (3, 2, 16, 128), TVConfig(**hyb), dict(fidelity="kl",
                                                 fid_weight=1.3), "f32"
    yield (4, 2, 16, 128), TVConfig(norm="aniso", **hyb), {}, "f32"
    yield (4, 2, 16, 128), TVConfig(norm="huber", huber_delta=0.2,
                                    **hyb), {}, "f32"
    yield (5, 3, 33, 70), TVConfig(**hyb), {}, "bf16+bf16dual"
    yield (5, 3, 33, 70), TVConfig(scheme="central", reg_time=0.7,
                                   reg_z_over_reg=0.3), {}, "f32"
    yield MAIN_4D, TVConfig(**hyb), {}, "f32"
    yield CT_SHAPE, TVConfig(**hyb), {}, "f32"


def phase_zstream(card):
    errs = {"f32": 0.0, "bf16": 0.0}
    n = 0
    for shape, cfg, fid_kw, storage in _zstream_cases():
        gen = torch.Generator(device=DEV).manual_seed(11)
        x, x0, y_A, y_D = _state(shape, cfg, STORAGE[storage], gen,
                                 fid_kw.get("fidelity", "l2"))
        kw = dict(cfg=cfg, sigma_D=0.5, sigma_A=1.0, reg=0.3, **fid_kw)
        z = [y_A.clone(), y_D.clone()]
        b1 = [y_A.clone(), y_D.clone()]
        pl = [y_A.clone(), y_D.clone()]
        _, _, tv_z = zstream.cp_dual_zstream(x, x0, z[0], z[1], **kw)
        _, _, tv_1 = fused.cp_dual(x, x0, b1[0], b1[1], **kw)
        _, _, tv_p = zstream.cp_dual_zstream_plain(x, x0, pl[0], pl[1], **kw)
        bf16 = storage != "f32"
        kind = "bf16" if bf16 else "f32"
        for g, r in zip(z, pl):  # against the plain version
            errs[kind] = max(errs[kind], _compare(g, r, bf16, 0.0))
        for g, r in zip(z, b1):  # against B1: the same body, bit for bit
            require(_bits_equal(g, r), f"B10 vs B1 {shape} {storage}: "
                                       f"y_A', y_D' bit for bit")
        s_z, s_1, s_p = (float(t.sum()) for t in (tv_z, tv_1, tv_p))
        require(abs(s_z - s_1) <= 2e-6 * abs(s_1)
                and abs(s_z - s_p) <= (1e-4 if bf16 else 1e-5) * abs(s_p),
                f"B10 TV sum {shape}: {s_z} vs B1 {s_1}, plain {s_p}")
        tau = default_tau(cfg, shape[0], shape[1])
        pk = dict(cfg=cfg, tau=tau, **fid_kw)
        xz, _ = fused.cp_primal(x, x0, z[0], z[1], out=torch.empty_like(x),
                                **pk)
        x1, _ = fused.cp_primal(x, x0, b1[0], b1[1], out=torch.empty_like(x),
                                **pk)
        require(_bits_equal(xz, x1), f"B10 + B2 vs B1 + B2 {shape}: x' "
                                     f"bit for bit")
        n += 1
        del x, x0, y_A, y_D, z, b1, pl, xz, x1
    # every table the kernel instantiates in every storage pair, at a
    # width whose runs and tile copies go element by element (odd), at one
    # that takes 16-byte copies, and at a plane too wide for the ring
    pairs = {"f32": (torch.float32, torch.float32),
             "f32+bf16dual": (torch.float32, torch.bfloat16),
             "bf16+f32dual": (torch.bfloat16, torch.float32),
             "bf16+bf16dual": (torch.bfloat16, torch.bfloat16)}
    met, n_tab = set(), 0
    for scheme in SCHEMES:
        for M, kw in ((1, {}), (2, dict(reg_time=0.5)),
                      (3, dict(reg_time=0.5))):
            cfg = TVConfig(scheme=scheme, **kw)
            tid = tables.zstream_table_id(cfg, 4, M)
            if tid in met:
                continue
            met.add(tid)
            shapes = [(4, M, 16, 128), (5, M, 17, 71)]
            if tid == tables.table_id(TVConfig(scheme="hybrid"), 3, 1):
                shapes.append((3, 1, 8, 1000))  # no ring: rows > 768 wide
            for shape in shapes:
                for tag, storage in pairs.items():
                    gen = torch.Generator(device=DEV).manual_seed(13)
                    x, x0, y_A, y_D = _state(shape, cfg, storage, gen, "l2")
                    kw2 = dict(cfg=cfg, sigma_D=0.5, sigma_A=1.0, reg=0.3)
                    z = [y_A.clone(), y_D.clone()]
                    b1 = [y_A.clone(), y_D.clone()]
                    _, _, tv_z = zstream.cp_dual_zstream(x, x0, *z, **kw2)
                    _, _, tv_1 = fused.cp_dual(x, x0, *b1, **kw2)
                    require(all(_bits_equal(g, r) for g, r in zip(z, b1)),
                            f"B10 vs B1 table {tid} {shape} {tag}: y_A', "
                            f"y_D' bit for bit")
                    s_z, s_1 = float(tv_z.sum()), float(tv_1.sum())
                    require(abs(s_z - s_1) <= 2e-6 * abs(s_1),
                            f"B10 TV sum table {tid} {shape} {tag}: {s_z} "
                            f"vs B1 {s_1}")
                    n_tab += 1
    require(met == set(tables.ZSTREAM_TABLES),
            f"phase 22 meets every table of csrc/cp_zstream.cu: {met}")
    for shape, cfg in (((2, 2, 16, 128), TVConfig(scheme="hybrid")),
                       ((4, 2, 16, 128), TVConfig(scheme="hybrid",
                                                  reg_z_over_reg=0.0))):
        gen = torch.Generator(device=DEV).manual_seed(11)
        args = _state(shape, cfg, STORAGE["f32"], gen, "l2")
        try:
            zstream.cp_dual_zstream(*args, cfg=cfg, sigma_D=0.5, sigma_A=1.0,
                                    reg=0.3)
        except ValueError:
            pass
        else:
            require(False, f"zstream guard at {shape}")
    log(f"[22 B10 vs plain and B1] {n} cases up to {MAIN_4D} and {CT_SHAPE}: "
        f"pass; max abs err vs plain f32 {errs['f32']:.3g} bf16 "
        f"{errs['bf16']:.3g}; y_A', y_D' and x' after B2 equal to B1's bit "
        f"for bit, TV sums within 2e-6; the same over the {len(met)} tables "
        f"x {len(pairs)} storage pairs at three widths ({n_tab} cases); "
        f"both guards raise")

    # this kernel's path: a CP solve whose pass A is B10, from a numpy
    # volume, against the solver (pass A = B1)
    cfg = TVConfig(scheme="hybrid", reg_time=0.5)
    Nz, M, Nr, Nc = MAIN_4D
    Nd = num_channels(cfg.scheme, Nz, M, cfg.reg_z_over_reg, cfg.reg_time)
    tau = default_tau(cfg, Nz, M)
    base = np.random.default_rng(0).random(MAIN_4D).astype(np.float32)
    dk = dict(cfg=cfg, sigma_D=0.5, sigma_A=1.0, reg=1.0)
    sync()
    zero_counters()
    x0 = torch.as_tensor(base, device=DEV)
    xs, y_A = x0.clone(), torch.zeros_like(x0)
    y_D = torch.zeros((Nz, M, Nd, Nr, Nc), device=DEV)
    z_losses = []
    for _ in range(20):
        _, _, tv = zstream.cp_dual_zstream(xs, x0, y_A, y_D, **dk)
        _, fid = fused.cp_primal(xs, x0, y_A, y_D, cfg=cfg, tau=tau)
        z_losses.append(fid.sum() + tv.sum())
    sync()
    launches = read_counters()
    require_launches(launches, "CP solve on B10 + B2", B10=20, B2=20)
    ref = chambolle_pock(x0, n_iter=20, reg=1.0, cfg=cfg, return_dual=False)
    err = float((xs - ref.x).abs().max())
    rel = float(((torch.stack(z_losses) - ref.loss).abs() / ref.loss).max())
    require(err <= ZSTREAM_ATOL and rel <= 2e-6 and bool(
        torch.isfinite(xs).all()),
        f"20 iterations on B10 + B2 equal those on B1 + B2: x {err:.3g}, "
        f"losses {rel:.3g}")
    log(f"[22 B10 path] 20 CP iterations at {MAIN_4D} f32 with pass A = B10: "
        f"launches {launches}; x within {err:.3g} of chambolle_pock's (pass A "
        f"= B1), losses within {rel:.3g}")
    del ref, xs, y_A, y_D

    # the A/B: pass A alone and the composed step, interleaved, marginal
    # time per iteration between 50 and 150 iterations
    out = {}
    for tag, (x_dt, d_dt) in STORAGE.items():
        v0 = x0.to(x_dt)

        def state():
            return (v0.clone(), torch.zeros_like(v0),
                    torch.zeros((Nz, M, Nd, Nr, Nc), dtype=d_dt, device=DEV))

        def loop(dual, with_b2):
            xx, ya, yd = state()

            def run(n_it):
                for _ in range(n_it):
                    dual(xx, v0, ya, yd, **dk)
                    if with_b2:
                        fused.cp_primal(xx, v0, ya, yd, cfg=cfg, tau=tau)
            return run

        res = {}
        for with_b2 in (False, True):
            t = {"B1": [], "B10": []}
            for name, dual in (("B1", fused.cp_dual),
                               ("B10", zstream.cp_dual_zstream),
                               ("B10", zstream.cp_dual_zstream),
                               ("B1", fused.cp_dual)):
                t[name].append(_marginal_ms(loop(dual, with_b2), 50, 150,
                                            repeats=2))
            res[with_b2] = {k: min(v) for k, v in t.items()}
        log(f"[22 B10 A/B {MAIN_4D} {tag}] pass A alone: B1 "
            f"{res[False]['B1']:.4f} ms, B10 {res[False]['B10']:.4f} ms "
            f"(B1 / B10 = {res[False]['B1'] / res[False]['B10']:.3f}); step "
            f"with B2: B1 {res[True]['B1']:.4f} ms/it, B10 "
            f"{res[True]['B10']:.4f} ms/it "
            f"({res[True]['B1'] / res[True]['B10']:.3f}); (t(150) - t(50)) / "
            f"100, interleaved B1, B10, B10, B1; card {card}")
        out[tag] = res
        sync()
    xx, ya, yd = x0.clone(), torch.zeros_like(x0), torch.zeros(
        (Nz, M, Nd, Nr, Nc), device=DEV)
    ms = (_time_launch(lambda: zstream.cp_dual_zstream(xx, x0, ya, yd, **dk)),
          _time_launch(lambda: zstream.cp_dual_zstream_plain(xx, x0, ya, yd,
                                                             **dk), n=10))
    log(f"[22 B10 per launch, f32 {MAIN_4D}] {ms[0]:.3f} ms (plain "
        f"{ms[1]:.3f} ms)")
    sync()
    return launches["B10"], errs, ms


# ---------------------------------------------------------------- phase 23
def _peak_rises(fn):
    """Run ``fn`` and return its result and whether it allocated on the
    card."""
    sync()
    torch.cuda.reset_peak_memory_stats(DEV)
    before = torch.cuda.memory_allocated(DEV)
    out = fn()
    sync()
    return out, torch.cuda.max_memory_allocated(DEV) > before


def phase_solvers(card):
    noisy = add_noise(cameraman(), 100, seed=0).astype(np.float32)
    model = TVDenoiser(reg=25)
    zero_counters()
    res_admm = model.admm(noisy, 30)   # numpy in, no device=
    res_fista = model.fista(noisy, 100)
    res_pre = chambolle_pock_precond(noisy[None, None], n_iter=300, reg=25.0)
    sync()
    require_launches(read_counters(), "ADMM, FISTA and the preconditioned CP "
                     "run no kernel, as in the JAX package")
    for name, res in (("admm", res_admm), ("fista", res_fista),
                      ("precond", res_pre)):
        require(res.x.is_cuda and res.loss.is_cuda
                and res.x.dtype == torch.float32
                and bool(torch.isfinite(res.x).all())
                and bool(torch.isfinite(res.loss).all()),
                f"{name}: a numpy image is solved on the card in float32")
        require(float(res.loss[-1]) < float(res.loss[0]),
                f"{name}: the loss falls")
    require(isinstance(res_pre.state, CPPrecondState), "precond state type")
    # all minimise the cameraman objective: after these iteration counts
    # each is within 2% of the 300-iteration CP value
    finals = {"admm(30)": float(res_admm.loss[-1]),
              "fista(100)": float(res_fista.loss[-1]),
              "precond(300)": float(res_pre.loss[-1])}
    for name, val in finals.items():
        require(abs(val - CAMERAMAN_LOSS) / CAMERAMAN_LOSS < 0.02,
                f"{name} reaches the cameraman objective: {val:.1f}")
    log(f"[23 solvers on the card] TVDenoiser.admm / .fista / "
        f"chambolle_pock_precond from numpy cameraman on {res_admm.x.device}: "
        f"final losses {finals} (CP after 300: {CAMERAMAN_LOSS})")

    zero_counters()
    out_eps = denoise_tv_chambolle(noisy, weight=25.0, eps=2e-4,
                                   max_num_iter=400)
    sync()
    eps_launches = read_counters()
    require(eps_launches["B1"] == eps_launches["B2"]
            and 0 < eps_launches["B1"] < 400 and eps_launches["B1"] % 20 == 0,
            f"eps=2e-4 stops early on the card, in chunks of 20 kernel "
            f"iterations: {eps_launches}")
    full = denoise_tv_chambolle(noisy, weight=25.0, max_num_iter=400)
    require(isinstance(out_eps, np.ndarray) and out_eps.shape == (256, 256)
            and bool(np.isfinite(out_eps).all())
            and np.abs(out_eps - full).max() > 0, "eps result")
    rgb = np.stack([noisy, noisy[::-1], noisy[:, ::-1]], axis=-1).copy()
    (out_cpl, used_card) = _peak_rises(lambda: denoise_tv_chambolle(
        rgb, weight=25.0, max_num_iter=40, channel_axis=-1,
        coupled_channels=True))
    out_ind = denoise_tv_chambolle(rgb, weight=25.0, max_num_iter=40,
                                   channel_axis=-1)
    require(used_card and out_cpl.shape == rgb.shape
            and bool(np.isfinite(out_cpl).all())
            and np.abs(out_cpl - out_ind).max() > 1e-3,
            "coupled channels: solved on the card, differs from independent")
    log(f"[23 denoise_tv_chambolle] eps=2e-4 stopped after "
        f"{eps_launches['B1']} of 400 iterations (launches {eps_launches}); "
        f"coupled_channels=True on a 256 x 256 x 3 image: on the card, max "
        f"|coupled - independent| {np.abs(out_cpl - out_ind).max():.3g}")

    # tolerance-based stopping on the certified gap, from a numpy volume
    x0 = torch.as_tensor(noisy, device=DEV)[None, None]
    conv = run_until_converged(chambolle_pock, x0, tol=1e-3, chunk=50,
                               max_iter=3000, criterion="gap", reg=25.0)
    n_run = len(conv.loss)
    gap = float(pd_gap(conv.state, x0, reg=25.0))
    require(n_run < 3000 and conv.loss.is_cuda
            and gap <= 1e-3 * float(conv.loss[-1]),
            f"criterion='gap' stops before max_iter: {n_run}, gap {gap:.4g}")
    # a checkpointed run, interrupted and resumed, equals the whole one
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "run.npz")
        kw = dict(reg=25.0, fused=False)
        run_checkpointed(chambolle_pock, x0, 40, checkpoint_path=path,
                         checkpoint_every=20, **kw)
        resumed = run_checkpointed(chambolle_pock, x0, 100,
                                   checkpoint_path=path, checkpoint_every=20,
                                   **kw)
    whole = chambolle_pock(x0, n_iter=100, **kw)
    require(torch.equal(resumed.x, whole.x)
            and torch.equal(resumed.loss, whole.loss) and resumed.x.is_cuda,
            "run_checkpointed resumed from its file equals the whole run")
    log(f"[23 state] run_until_converged(chambolle_pock, criterion='gap', "
        f"tol=1e-3) stopped after {n_run} of 3000 iterations (gap / loss "
        f"{gap / float(conv.loss[-1]):.3g}); run_checkpointed(100, every 20) "
        f"interrupted at 40 and resumed: bit-equal to the whole run")

    # rates (CUDA events; whole solver calls)
    def rate(fn, n_it, repeats=3):
        return n_it / (_best_ms(fn, repeats) / 1e3)

    cam = {"admm": rate(lambda: admm(x0, n_iter=30, reg=25.0), 30),
           "fista": rate(lambda: fista(x0, n_iter=100, reg=25.0), 100),
           "precond": rate(lambda: chambolle_pock_precond(
               x0, n_iter=100, reg=25.0), 100)}
    cfg = TVConfig(scheme="hybrid", reg_time=0.5)
    v0 = torch.as_tensor(np.random.default_rng(0).random(MAIN_4D),
                         dtype=torch.float32, device=DEV)
    big = {"admm": rate(lambda: admm(v0, n_iter=2, reg=1.0, cfg=cfg), 2, 1),
           "fista": rate(lambda: fista(v0, n_iter=5, reg=1.0, cfg=cfg), 5, 1),
           "precond": rate(lambda: chambolle_pock_precond(
               v0, n_iter=5, reg=1.0, cfg=cfg), 5, 1)}
    log("[23 rates, plain PyTorch solvers] cameraman f32: "
        + ", ".join(f"{k} {v:.1f} it/s" for k, v in cam.items())
        + f"; {MAIN_4D} f32 hybrid reg_time=0.5: "
        + ", ".join(f"{k} {v:.2f} it/s" for k, v in big.items())
        + f" (ADMM with 8 CG iterations each); card {card}")
    del v0
    torch.cuda.empty_cache()
    sync()


# ---------------------------------------------------------------- phase 24
SHARD_4D = (MAIN_4D[0] // 4,) + MAIN_4D[1:]  # a z-shard of the sharded path
HALO_SMALL, HALO_SMALL_MESH = (6, 4, 16, 128), (3, 2)     # 2 x 2-plane shards
OVERLAP_SMALL, OVERLAP_SMALL_MESH = (9, 3, 16, 128), (3, 1)  # 3-plane shards
SHARDED_MESH = (4, 1)  # the sharded main path: 4 z-shards on the one card
# the B8 kernels' storage pairs: the other phases' and bf16 x with an f32 dual
SHARD_STORAGE = dict(STORAGE, **{"bf16+f32dual": (torch.bfloat16,
                                                  torch.float32)})
# (scheme, reg_time, M) that reach each table the B8 kernels are built for
# (kernels.tables.BOUNDARY_TABLES) on 9 slices
B8_TABLE_CONFIGS = {1: ("upwind", 0.0, 3), 3: ("upwind", 0.5, 3),
                    5: ("downwind", 0.0, 3), 7: ("downwind", 0.5, 3),
                    9: ("hybrid", 0.0, 3), 11: ("hybrid", 0.5, 3),
                    13: ("central", 0.0, 3), 15: ("central", 0.5, 3),
                    20: ("central", 0.5, 2)}
# the sharded TV (B3 / B4 halo mode) on the 4D cell: the shard of a (2 x 2)
# grid beside SHARD_4D, a z-shard
GRID_2X2 = (2, 2)
SHARD_2X2 = (MAIN_4D[0] // 2, MAIN_4D[1] // 2) + MAIN_4D[2:]
# an even width (whole rows of 16 bytes: B3's cp.async fill) and an odd one
# (its element-by-element fill; ragged tiles of B4)
HALO_TV_WIDTHS = ((20, 128), (7, 37))


def _halo_tv_table_configs():
    """{table id: (cfg, whole volume's (Nz, M))} reaching each of the 21
    tables the B3 / B4 halo kernels are built for, with Nz and M of 2 or 4,
    so that a z-cut (2, 1) and a t-cut (1, 2) mesh both divide them."""
    out = {}
    for scheme, reg_z, reg_time, Nz, M in itertools.product(
            SCHEMES, (1.0, 0.0), (0.5, 0.0), (4, 2), (4, 2)):
        cfg = TVConfig(scheme=scheme, reg_z_over_reg=reg_z,
                       reg_time=reg_time)
        out.setdefault(tables.table_id(cfg, Nz, M), (cfg, (Nz, M)))
    require(sorted(out) == list(range(len(tables.TABLES))),
            f"a configuration for every table, got {sorted(out)}")
    return out


def _halo_tv_bounds(shard, cfg, table_dims, dtype):
    """The bounds of B3 and B4 in halo mode on one shard: the bytes its table
    needs, each once -- x at the shard and at the planes its z and t
    channels read across the shard's faces (B3 one a side; B4 two for a
    central channel), B4 also the norms at the shard and one plane a side
    (not for aniso), and the outputs (norms, G) -- over the HBM rate, and
    the operations per voxel the unsharded bounds count (main)."""
    Nz, M, Nr, Nc = shard
    chans, _ = scheme_channels(cfg.scheme, *table_dims, cfg.reg_z_over_reg,
                               cfg.reg_time)
    kinds = {a: {ch.kind for ch in chans if ch.axis == a}
             for a in (AXIS_Z, AXIS_T)}
    across = {AXIS_Z: M, AXIS_T: Nz}  # planes on one face of the shard
    own, plane, xb = Nz * M, Nr * Nc, dtype.itemsize
    x3 = own + sum(2 * across[a] for a in kinds if kinds[a])
    x4 = own + sum(2 * (2 if "ctr" in kinds[a] else 1) * across[a]
                   for a in kinds if kinds[a])
    n4 = 0 if cfg.norm == "aniso" else x3
    Nd, vox = len(chans), own * plane
    return {"B3halo": bound((x3 * xb + own * 4) * plane, (4 * Nd + 4) * vox),
            "B4halo": bound((x4 * xb + n4 * 4 + own * xb) * plane,
                            (10 * Nd + 2) * vox)}


def _halo_sides(shard, chans):
    """The planes on one face of a shard along z and t, and for each axis
    whether the table's channels read x one plane below (BWD, CTR) and one
    plane above (FWD, CTR) along it."""
    face = {AXIS_Z: shard[1], AXIS_T: shard[0]}
    sides = {a: (any(c.kind in ("bwd", "ctr") for c in chans if c.axis == a),
                 any(c.kind in ("fwd", "ctr") for c in chans if c.axis == a))
             for a in face}
    return face, sides


def _halo_b5_bound(shard, cfg, table_dims, x_dt, d_dt):
    """The bound of B5 in its halo mode on one shard: x_bar at the shard and
    at the planes its table's z and t channels read beyond it (one plane a
    side that a channel reads, as B1's halo mode: _halo_cp_bounds), the dual
    read and written, each once, over the HBM rate; 10 operations a channel
    and voxel, as the unsharded B5's bound counts them.  Returns (ms, what
    sets it, bytes)."""
    Nz, M, Nr, Nc = shard
    chans, _ = scheme_channels(cfg.scheme, *table_dims, cfg.reg_z_over_reg,
                               cfg.reg_time)
    face, sides = _halo_sides(shard, chans)
    own, plane, Nd = Nz * M, Nr * Nc, len(chans)
    x_planes = own + sum(face[a] * sum(sides[a]) for a in face)
    n_bytes = (x_planes * x_dt.itemsize + 2 * own * Nd * d_dt.itemsize) * plane
    return bound(n_bytes, 10 * Nd * own * plane) + (n_bytes,)


def _halo_cp_bounds(shard, cfg, table_dims, x_dt, d_dt):
    """The bounds of B1 and B2 in their sharded modes on one shard: each
    input once and each output once.  ``interior`` computes the planes
    1 .. Nz-2: B1 reads x there and at the z planes its channels read
    (the shard's edge planes), x0, y_A and the dual there and writes y_A
    and the dual; B2 reads x, x0, y_A and the dual there and the dual's z
    channels at the edge plane each reads, and writes x.  ``halo_mode``
    computes the whole shard and reads, beyond it, the neighbour planes its
    table reads: x one plane a side along z and t (B1), a channel's dual
    one plane on the side its adjoint reads (B2).  Operations per voxel as
    main's bounds count them."""
    Nz, M, Nr, Nc = shard
    chans, _ = scheme_channels(cfg.scheme, *table_dims, cfg.reg_z_over_reg,
                               cfg.reg_time)
    Nd, plane = len(chans), Nr * Nc
    xb, db = x_dt.itemsize, d_dt.itemsize
    face, sides = _halo_sides(shard, chans)
    # the dual planes one channel's adjoint reads beyond its slots: FWD
    # the plane below, BWD the one above, CTR both
    y_nb = {a: sum(2 if c.kind == "ctr" else 1 for c in chans if c.axis == a)
            for a in face}
    out = {}
    for mode in ("interior", "halo_mode"):
        own = (Nz - 2 if mode == "interior" else Nz) * M
        if mode == "interior":
            x_planes = own + M * sum(sides[AXIS_Z])
            y_extra = M * y_nb[AXIS_Z]
        else:
            x_planes = own + sum(face[a] * sum(sides[a]) for a in face)
            y_extra = sum(face[a] * y_nb[a] for a in face)
        vox = own * plane
        out[f"B1 {mode}"] = bound(
            x_planes * plane * xb + (3 * xb + 2 * Nd * db) * vox,
            (10 * Nd + 10) * vox)
        out[f"B2 {mode}"] = bound(
            (4 * xb + Nd * db) * vox + y_extra * plane * db,
            (4 * Nd + 8) * vox)
    return out


def _halo_tv_case(what, xw, tm, cfg, mesh_zt, note):
    """B3 and B4 in halo mode on the shards of the volume ``xw`` cut by a
    (z, t) mesh, extended as the sharded TV extends them: each shard's
    norms and G against the plain versions (``note`` takes the errors), its
    TV partials within 1e-6, and the gathered norms and G bit for bit the
    unsharded per-table kernels' on ``xw`` (the TV sums within 1e-6: the
    partials are summed per block of the shard)."""
    shape = tuple(xw.shape)
    kind = "bf16" if xw.dtype == torch.bfloat16 else "f32"
    chans, _ = scheme_channels(cfg.scheme, shape[0], shape[1],
                               cfg.reg_z_over_reg, cfg.reg_time)
    gz = fused_halo._axis_ghost_kind(chans, AXIS_Z)
    gt = fused_halo._axis_ghost_kind(chans, AXIS_T)
    xs = shard_volume(xw, make_mesh(*mesh_zt), mesh_zt[1] > 1)
    mode = dict(cfg=cfg, halo_mode=True, table_dims=shape[:2])
    x1 = fused_halo._extend_axis(fused_halo._extend_axis(xs, 0, gz), 1, gt)
    k = grid_map(lambda xe: fused.tv_norms(xe, tm, **mode), x1)
    p = grid_map(lambda xe: fused.tv_norms_plain(xe, tm, **mode), x1)
    for (nk, tk), (np_, tp) in _cells(k, p):
        require(torch.equal(torch.isinf(nk), torch.isinf(np_)),
                f"B3 halo {what}: +inf norms at the same voxels")
        note("B3halo", kind, (torch.where(torch.isinf(nk), 0.0, nk),
                              torch.where(torch.isinf(np_), 0.0, np_)),
             tol=F32_TOL_GD)
        rel = abs(float(tk.sum() - tp.sum())) / float(tp.sum())
        require(rel <= 1e-6, f"B3 halo {what}: TV sum {rel:.3g}")
    x2 = fused_halo._extend_axis2(fused_halo._extend_axis2(xs, 0, gz), 1, gt)
    if cfg.norm == "aniso":
        n1 = grid_map(lambda xe: None, x2)
    else:
        n1 = fused_halo._extend_norms(grid_map(lambda c: c[0], k))
    G = grid_map(lambda xe, ne: fused.tv_subgrad(xe, ne, tm, **mode), x2, n1)
    for g, xe, ne in _cells(G, x2, n1):
        note("B4halo", kind, (g, fused.tv_subgrad_plain(xe, ne, tm, **mode)),
             tol=F32_TOL_GD)
    norms_w, parts_w = fused.tv_norms(xw, tm, cfg=cfg)
    G_w = fused.tv_subgrad(xw, norms_w, tm, cfg=cfg)
    require(_bits_equal(gather_volume(grid_map(lambda c: c[0], k)), norms_w),
            f"B3 halo {what}: the shards' norms equal the unsharded "
            f"per-table kernel's bit for bit")
    require(_bits_equal(gather_volume(G), G_w),
            f"B4 halo {what}: the shards' G equals the unsharded per-table "
            f"kernel's bit for bit")
    tv = sum(float(c[1].sum()) for (c,) in _cells(k))
    rel = abs(tv - float(parts_w.sum())) / float(parts_w.sum())
    require(rel <= 1e-6, f"B3 halo {what}: the shards' TV {rel:.3g} from the "
            f"unsharded kernel's")


def _halo_tv_times(card):
    """B3 and B4 in halo mode per launch on one shard of the 4D cell (a
    z-shard and a (2 x 2) grid's shard, f32 and bf16, hybrid reg_time=0.5):
    wall (CUDA events around 50 launches), the kernel alone on the device
    (torch.profiler), the plain versions, and the bounds."""
    cfg = TVConfig(scheme="hybrid", reg_time=0.5)
    chans, _ = scheme_channels(cfg.scheme, *MAIN_4D[:2], cfg.reg_z_over_reg,
                               cfg.reg_time)
    gz = fused_halo._axis_ghost_kind(chans, AXIS_Z)
    gt = fused_halo._axis_ghost_kind(chans, AXIS_T)
    base = torch.rand(MAIN_4D, generator=torch.Generator(
        device=DEV).manual_seed(77), device=DEV)
    mode = dict(cfg=cfg, halo_mode=True, table_dims=MAIN_4D[:2])
    out, lines = {}, []
    for tag, mesh_zt, shard in (("z4", SHARDED_MESH, SHARD_4D),
                                ("2x2", GRID_2X2, SHARD_2X2)):
        for dtype in (torch.float32, torch.bfloat16):
            xs = shard_volume(base.to(dtype), make_mesh(*mesh_zt),
                              mesh_zt[1] > 1)
            x1 = fused_halo._extend_axis(
                fused_halo._extend_axis(xs, 0, gz), 1, gt)[1][0]
            x2 = fused_halo._extend_axis2(
                fused_halo._extend_axis2(xs, 0, gz), 1, gt)[1][0]
            n1 = fused_halo._extend_norms(grid_map(
                lambda xe: fused.tv_norms(xe, **mode)[0],
                fused_halo._extend_axis(fused_halo._extend_axis(
                    xs, 0, gz), 1, gt)))[1][0]
            runs = {"B3halo": (lambda: fused.tv_norms(x1, **mode),
                               lambda: fused.tv_norms_plain(x1, **mode),
                               "tv_norms_spec_kernel"),
                    "B4halo": (lambda: fused.tv_subgrad(x2, n1, **mode),
                               lambda: fused.tv_subgrad_plain(x2, n1, **mode),
                               "tv_subgrad_spec_kernel")}
            bounds = _halo_tv_bounds(shard, cfg, MAIN_4D[:2], dtype)
            key = f"{tag} {str(dtype)[6:]}"
            for kid, (run, plain, kernel) in runs.items():
                ms = _time_launch(run)
                _, by_kernel = device_time(
                    lambda: [run() for _ in range(50)], 50, DEV)
                dev = sum(v for k, v in by_kernel.items() if kernel in k)
                require(dev > 0, f"{kid} {key}: {kernel} on the device")
                out[(kid, key)] = dict(ms=ms, device_ms=dev,
                                       plain_ms=_time_launch(plain, n=5),
                                       bound=bounds[kid])
                b = bounds[kid]
                lines.append(f"{kid} {key} {shard}: {ms:.4f} ms wall, "
                             f"{dev:.4f} on the device, plain "
                             f"{out[(kid, key)]['plain_ms']:.3f}; bound "
                             f"{b[0]:.4f} ms ({b[1]}): "
                             f"{b[0] / dev:.1%} of it on the device")
            del xs, x1, x2, n1
    log("[24 B3 / B4 halo per launch, hybrid reg_time=0.5, one shard of "
        f"{MAIN_4D} with its ghost or neighbour planes] " + "; ".join(lines)
        + f"; card {card}")
    sync()
    return out


def _halo_cp_cases():
    """(name, cfg, options, storage) of the sharded kernel modes: the four
    schemes, the norms, the fidelities, nonneg, a tmul plane, bf16."""
    hyb = dict(scheme="hybrid", reg_time=0.5)
    for scheme in SCHEMES:
        yield f"{scheme}-time", TVConfig(scheme=scheme, reg_time=0.5), {}, "f32"
    yield "hybrid-zt", TVConfig(scheme="hybrid", **CONFIGS["zt"]), {}, "f32"
    for norm in ("aniso", "huber"):
        yield (f"hybrid-time-{norm}", TVConfig(norm=norm, huber_delta=0.3,
                                               **hyb), {}, "f32")
    yield ("hybrid-time-tmul-l1", TVConfig(**hyb),
           dict(tmul=True, fidelity="l1", fid_weight=0.7), "f32")
    yield ("central-time-tmul-kl-nonneg",
           TVConfig(scheme="central", reg_time=0.5),
           dict(tmul=True, fidelity="kl", fid_weight=0.7, nonneg=True), "f32")
    for storage in ("f32+bf16dual", "bf16+bf16dual"):
        yield f"hybrid-time-{storage}", TVConfig(**hyb), {}, storage
        yield f"central-time-tmul-{storage}", TVConfig(
            scheme="central", reg_time=0.5), dict(tmul=True), storage


class _ShardedState:
    """A CP state of a whole volume that keeps the solvers' invariant (zero
    duals at globally invalid slots: one kernel pass A from zero duals), cut
    into a mesh's shards on the card."""

    def __init__(self, shape, mesh_zt, cfg, opts, storage, gen):
        x_dt, d_dt = SHARD_STORAGE[storage]
        self.cfg, self.shape = cfg, shape
        self.fid = dict(fidelity=opts.get("fidelity", "l2"),
                        fid_weight=opts.get("fid_weight", 1.0))
        self.nonneg = opts.get("nonneg", False)
        self.tm = _gd_tmul(shape, cfg, gen) if opts.get("tmul") else None
        self.chans, _ = scheme_channels(cfg.scheme, shape[0], shape[1],
                                        cfg.reg_z_over_reg, cfg.reg_time)
        self.ghost_z = fused_halo._axis_ghost_kind(self.chans, AXIS_Z)
        self.ghost_t = fused_halo._axis_ghost_kind(self.chans, AXIS_T)
        self.dual_kw = dict(cfg=cfg, sigma_D=0.5, sigma_A=1.0, reg=0.5,
                            **self.fid)
        self.primal_kw = dict(cfg=cfg, tau=default_tau(cfg, shape[0],
                                                       shape[1]),
                              nonneg=self.nonneg, **self.fid)
        x0 = torch.rand(shape, generator=gen, device=DEV) + 0.5
        x = x0 + 0.1 * torch.rand(shape, generator=gen, device=DEV)
        y_A = torch.zeros_like(x0)
        y_D = torch.zeros((shape[0], shape[1], len(self.chans)) + shape[2:],
                          device=DEV)
        fused.cp_dual(x, x0, y_A, y_D, self.tm, **self.dual_kw)
        x = x + 0.05 * torch.rand(shape, generator=gen, device=DEV)
        self.mesh = make_mesh(*mesh_zt)
        self.st = mesh_zt[1] > 1
        self.x, self.x0, self.y_A, self.y_D = (
            shard_volume(t, self.mesh, self.st)
            for t in (x.to(x_dt), x0.to(x_dt), y_A.to(x_dt), y_D.to(d_dt)))
        self.sharded = dict(table_dims=shape[:2])

    def copies(self):
        return tuple(grid_map(torch.clone, g)
                     for g in (self.x, self.y_A, self.y_D))

    def on_mesh(self, mesh_zt):
        """The same state cut into the shards of another (z, t) mesh."""
        out = object.__new__(_ShardedState)
        out.__dict__.update(vars(self))
        out.mesh, out.st = make_mesh(*mesh_zt), mesh_zt[1] > 1
        out.x, out.x0, out.y_A, out.y_D = (
            shard_volume(gather_volume(g), out.mesh, out.st)
            for g in (self.x, self.x0, self.y_A, self.y_D))
        return out


def _cells(*grids):
    """The grids' shards side by side, in (iz, it) order."""
    return [cells for rows in zip(*grids) for cells in zip(*rows)]


def _overlap_vs_ghost(shape, mesh_zt, cfg, opts, storage, gen, n_iter=20):
    """A sharded solve of ``n_iter`` iterations on the overlapped step (B1 /
    B2 with ``interior`` and the B8 kernels) and on the ghost-plane step
    (B1 / B2 in ``halo_mode``), from the same state: x, y_A and y_D must be
    equal bit for bit, the losses within 1e-5 relative (bf16 1e-4: the
    partial sums are taken in other blocks)."""
    x_dt, d_dt = SHARD_STORAGE[storage]
    noisy = torch.rand(shape, generator=gen, device=DEV) + 0.5
    wt = (1.0 + torch.rand(shape[2:], generator=gen, device=DEV))[None, None]
    mesh = make_mesh(*mesh_zt)
    st = init_state(noisy, cfg)
    state = [shard_volume(t, mesh, False) for t in (
        noisy.to(x_dt), st.x.to(x_dt), st.y_A.to(x_dt),
        fused.to_internal_layout(st.y_D).to(d_dt))]
    out = {}
    for overlap in (False, True):
        solve = make_sharded_cp_solver_fused(
            mesh, cfg, shape, reg=0.5, n_iter=n_iter, shard_time=False,
            overlap=overlap, dtype=x_dt, dual_dtype=d_dt,
            weight_time=wt if opts.get("tmul") else None,
            fidelity=opts.get("fidelity", "l2"),
            fidelity_weight=opts.get("fid_weight", 1.0),
            nonneg=opts.get("nonneg", False))
        require(solve.overlap == overlap, "the step asked for")
        x, y_A, y_D, losses = solve(*state)
        out[overlap] = (gather_volume(x), gather_volume(y_A),
                        gather_volume(y_D), losses)
    for g, o, name in zip(out[False][:3], out[True][:3], ("x", "y_A", "y_D")):
        require(torch.equal(g, o) and bool(torch.isfinite(g.float()).all()),
                f"{shape} {storage}: the overlapped step's {name} after "
                f"{n_iter} iterations equals the ghost path's bit for bit")
    rel = float(((out[True][3] - out[False][3]).abs()
                 / out[False][3].abs()).max())
    require(rel <= (1e-5 if storage == "f32" else 1e-4),
            f"{shape} {storage}: overlapped losses {rel:.3g} from the ghost "
            f"path's")
    return rel


def _interior_and_boundary(s, name, kind, note):
    """B1 / B2 with ``interior`` and then the two B8 kernels on the shards of
    ``s``, each against its plain version (``note`` takes the errors), and
    the shards' TV and fidelity sums."""
    x_halo = fused_halo._halo_planes(s.x, 0, s.ghost_z)
    (kx, kA, kD), (px, pA, pD) = s.copies(), s.copies()
    k_tv, p_tv = [], []
    for xs, x0, a, d, pa, pd in _cells(s.x, s.x0, kA, kD, pA, pD):
        k_tv.append(fused.cp_dual(xs, x0, a, d, s.tm, interior=True,
                                  **s.sharded, **s.dual_kw)[2])
        p_tv.append(fused.cp_dual_plain(
            xs, x0, pa, pd, s.tm, interior=True, **s.sharded,
            **s.dual_kw)[2])
        note("B1int", kind, (a, pa), (d, pd))
    for i, (xs, xh, x0, a, d, pa, pd) in enumerate(_cells(
            s.x, x_halo, s.x0, kA, kD, pA, pD)):
        fused.cp_dual_boundary(xs, xh, x0, a, d, k_tv[i], s.tm,
                               **s.sharded, **s.dual_kw)
        fused.cp_dual_boundary_plain(xs, xh, x0, pa, pd, p_tv[i],
                                     s.tm, **s.sharded, **s.dual_kw)
        note("B8dual", kind, (a, pa), (d, pd))
        rel = abs(float(k_tv[i].sum() - p_tv[i].sum())) / float(p_tv[i].sum())
        require(rel <= 1e-5, f"B1 interior + B8 {name}: TV sum {rel:.3g}")
    k_halo = fused_halo._sparse_channel_halo(kD, 0, s.chans, AXIS_Z)
    p_halo = fused_halo._sparse_channel_halo(pD, 0, s.chans, AXIS_Z)
    for xs, x0, a, d, h, ps, pa, pd, ph in _cells(
            kx, s.x0, kA, kD, k_halo, px, pA, pD, p_halo):
        _, k_fid = fused.cp_primal(xs, x0, a, d, s.tm, interior=True,
                                   **s.sharded, **s.primal_kw)
        _, p_fid = fused.cp_primal_plain(
            ps, x0, pa, pd, s.tm, interior=True, **s.sharded,
            **s.primal_kw)
        note("B2int", kind, (xs[1:-1], ps[1:-1]), scale=0.5)
        fused.cp_primal_boundary(xs, x0, a, d, h, k_fid, s.tm,
                                 **s.sharded, **s.primal_kw)
        fused.cp_primal_boundary_plain(ps, x0, pa, pd, ph, p_fid, s.tm,
                                       **s.sharded, **s.primal_kw)
        note("B8primal", kind, (xs, ps), scale=0.5)
        rel = abs(float(k_fid.sum() - p_fid.sum())) / float(p_fid.sum())
        require(rel <= (1e-4 if kind == "bf16" else 1e-5),
                f"B2 interior + B8 {name}: fidelity sum {rel:.3g}")


def _cp_step_on_shards(s, overlap):
    """One CP step (pass A, then pass B) of the sharded state ``s`` on copies
    of its x, y_A and y_D: the ghost-plane step (B1 / B2 in halo mode) or
    the overlapped one (B1 / B2 interior, then B8), as
    ``make_sharded_cp_solver_fused`` runs them; x', y_A', y_D' gathered."""
    x, y_A, y_D = s.copies()
    kw = dict(**s.sharded)
    if overlap:
        x_halo = fused_halo._halo_planes(x, 0, s.ghost_z)
        tv = grid_map(lambda xs, x0, a, d: fused.cp_dual(
            xs, x0, a, d, s.tm, interior=True, **kw, **s.dual_kw)[2],
            x, s.x0, y_A, y_D)
        grid_map(lambda xs, xh, x0, a, d, p: fused.cp_dual_boundary(
            xs, xh, x0, a, d, p, s.tm, **kw, **s.dual_kw),
            x, x_halo, s.x0, y_A, y_D, tv)
        y_halo = fused_halo._sparse_channel_halo(y_D, 0, s.chans, AXIS_Z)
        fid = grid_map(lambda xs, x0, a, d: fused.cp_primal(
            xs, x0, a, d, s.tm, interior=True, **kw, **s.primal_kw)[1],
            x, s.x0, y_A, y_D)
        grid_map(lambda xs, x0, a, d, h, p: fused.cp_primal_boundary(
            xs, x0, a, d, h, p, s.tm, **kw, **s.primal_kw),
            x, s.x0, y_A, y_D, y_halo, fid)
    else:
        kw.update(halo_mode=True, t_sharded=s.st)
        x_ext = fused_halo._extend_axis(
            fused_halo._extend_axis(x, 0, s.ghost_z), 1, s.ghost_t)
        grid_map(lambda xe, x0, a, d: fused.cp_dual(
            xe, x0, a, d, s.tm, **kw, **s.dual_kw), x_ext, s.x0, y_A, y_D)
        y_ext = fused_halo._extend_dual(y_D, s.chans)
        grid_map(lambda xs, x0, a, d, e: fused.cp_primal(
            xs, x0, a, d, s.tm, y_ext=e, **kw, **s.primal_kw),
            x, s.x0, y_A, y_D, y_ext)
    return tuple(gather_volume(g) for g in (x, y_A, y_D))


def _cp_step_whole(s):
    """The same step on the gathered volume through the unsharded kernels
    (B1 and B2 per table, csrc/specialised.cu)."""
    x, x0, y_A, y_D = (gather_volume(g) for g in (s.x, s.x0, s.y_A, s.y_D))
    fused.cp_dual(x, x0, y_A, y_D, s.tm, **s.dual_kw)
    fused.cp_primal(x, x0, y_A, y_D, s.tm, **s.primal_kw)
    return x, y_A, y_D


def _step_bits(s, what, meshes, overlap):
    """x', y_A', y_D' of one step on the shards of each mesh of ``meshes``
    (the ghost-plane step; with ``overlap`` on the first mesh, a z-cut one,
    the overlapped step too) bit for bit the unsharded kernels' on the
    gathered volume.  Returns the number of sharded steps held."""
    want = _cp_step_whole(s)
    runs = [(m, False) for m in meshes] + ([(meshes[0], True)]
                                           if overlap else [])
    for mesh_zt, ov in runs:
        got = _cp_step_on_shards(s.on_mesh(mesh_zt), ov)
        for g, w, name in zip(got, want, ("x'", "y_A'", "y_D'")):
            require(_bits_equal(g, w),
                    f"{what} on {mesh_zt}: "
                    f"{'interior + B8' if ov else 'halo mode'} {name} "
                    f"bit-equal to the unsharded kernels' on the gathered "
                    f"volume")
    return len(runs)


def _halo_cp_tables():
    """B1 / B2 on a shard over every table and storage pair they are built
    for: the halo mode's 21 tables at an even and an odd width (tmul at the
    odd one where the table has time channels) on a 1 x 1 grid, a z-cut
    and a t-cut mesh, and the interior launches' tables (B8's) on 3
    z-shards, followed by B8; each step bit for bit the unsharded kernels'
    on the gathered volume (_step_bits).  Returns (cases, sharded
    steps)."""
    n_case = n_step = 0
    gen = torch.Generator(device=DEV).manual_seed(4321)
    for tid, (cfg, dims) in _halo_tv_table_configs().items():
        has_t = any(a == AXIS_T for a, _ in tables.TABLES[tid])
        for storage, rc in itertools.product(SHARD_STORAGE, HALO_TV_WIDTHS):
            shape = dims + rc
            opts = dict(tmul=has_t and rc[1] % 2 == 1)
            s = _ShardedState(shape, (1, 1), cfg, opts, storage, gen)
            n_step += _step_bits(s, f"halo table {tid} {storage} {shape}",
                                 ((1, 1), (2, 1), (1, 2)), False)
            n_case += 1
    for tid, (scheme, reg_time, M) in B8_TABLE_CONFIGS.items():
        cfg = TVConfig(scheme=scheme, reg_time=reg_time)
        for storage, rc in itertools.product(SHARD_STORAGE, HALO_TV_WIDTHS):
            shape = (9, M) + rc
            require(tables.boundary_table_id(cfg, *shape[:2]) == tid,
                    f"{scheme} reg_time={reg_time} {shape}: table {tid}")
            s = _ShardedState(shape, (1, 1), cfg, dict(tmul=reg_time > 0),
                              storage, gen)
            n_step += _step_bits(s, f"interior table {tid} {storage} "
                                 f"{shape}", ((3, 1),), True)
            n_case += 1
    sync()
    return n_case, n_step


def _kernel_ms(run, kernel, n=50, traces=3):
    """The device ms of one launch of ``kernel`` (a name's substring), the
    mean over the launches a torch.profiler trace of ``n`` calls of ``run``
    (one launch each) recorded, and how many it recorded.  Late in a long
    process a trace has dropped the first records of its window (11 in a
    row in phase 24), so each trace opens with 32 small kernels of its own
    and a pause of 50 ms on the host before the ``n`` calls, and
    closes with one more small kernel; a trace that loses records all the
    same is taken again, up to ``traces`` times, and then its device
    records are logged by name.  Each caller requires the count it returns
    to be ``n``, so that no mean is taken over a part of the launches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    mark = torch.zeros(1, device=DEV)
    for _ in range(traces):
        sync()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(32):
                mark.add_(1.0)
            sync()
            time.sleep(0.05)
            for _ in range(n):
                run()
            mark.add_(1.0)
            sync()
        names = [e.name for e in prof.events()
                 if e.device_type == DeviceType.CUDA]
        ms = [e.time_range.elapsed_us() / 1e3 for e in prof.events()
              if e.device_type == DeviceType.CUDA and kernel in e.name]
        require(bool(ms), f"{kernel} on the device")
        if len(ms) == n:
            break
    else:
        log(f"{kernel}: {len(ms)} of {n} launches in each of {traces} "
            f"traces; the last one's device records by name: "
            f"{dict(collections.Counter(names))}")
    return sum(ms) / len(ms), len(ms)


# what each B1 / B2 instance on a shard runs as, on the device
SHARD_KERNELS = {"B1halo": "cp_dual_shard_kernel",
                 "B1int": "cp_dual_shard_kernel",
                 "B2halo": "cp_primal_shard_kernel",
                 "B2int": "cp_primal_shard_kernel"}


def _halo_cp_times(card):
    """B1 and B2 on one shard of the 4D cell per launch, each instance: a
    z-shard (both modes) and a (2 x 2) grid's shard (halo mode; the
    overlapped step cuts z alone), f32 and bf16 (primary and dual), hybrid
    reg_time=0.5, on operands the sharded step builds: wall (CUDA events
    around 50 launches), the kernel alone on the device (_kernel_ms), the
    plain versions, and the bounds (_halo_cp_bounds)."""
    cfg = TVConfig(scheme="hybrid", reg_time=0.5)
    out, lines = {}, []
    for tag, mesh_zt, shard in (("z4", SHARDED_MESH, SHARD_4D),
                                ("2x2", GRID_2X2, SHARD_2X2)):
        for storage in ("f32", "bf16+bf16dual"):
            s = _ShardedState(MAIN_4D, mesh_zt, cfg, {}, storage,
                              torch.Generator(device=DEV).manual_seed(24))
            x, x0, y_A, y_D = (g[1][0] for g in (s.x, s.x0, s.y_A, s.y_D))
            x_ext = fused_halo._extend_axis(fused_halo._extend_axis(
                s.x, 0, s.ghost_z), 1, s.ghost_t)[1][0]
            y_ext = fused_halo._extend_dual(s.y_D, s.chans)[1][0]
            halo = dict(halo_mode=True, t_sharded=s.st, **s.sharded)
            inner = dict(interior=True, **s.sharded)
            dk, pk = s.dual_kw, s.primal_kw
            runs = {
                "B1halo": (lambda: fused.cp_dual(x_ext, x0, y_A, y_D, **halo,
                                                 **dk),
                           lambda: fused.cp_dual_plain(
                               x_ext, x0, y_A, y_D, **halo, **dk)),
                "B2halo": (lambda: fused.cp_primal(x, x0, y_A, y_D,
                                                   y_ext=y_ext, **halo, **pk),
                           lambda: fused.cp_primal_plain(
                               x, x0, y_A, y_D, y_ext=y_ext, **halo, **pk))}
            if tag == "z4":
                runs["B1int"] = (
                    lambda: fused.cp_dual(x, x0, y_A, y_D, **inner, **dk),
                    lambda: fused.cp_dual_plain(x, x0, y_A, y_D, **inner,
                                                **dk))
                runs["B2int"] = (
                    lambda: fused.cp_primal(x, x0, y_A, y_D, **inner, **pk),
                    lambda: fused.cp_primal_plain(x, x0, y_A, y_D, **inner,
                                                  **pk))
            x_dt, d_dt = SHARD_STORAGE[storage]
            bounds = _halo_cp_bounds(shard, cfg, MAIN_4D[:2], x_dt, d_dt)
            key = f"{tag} {storage}"
            for kid, (run, plain) in runs.items():
                ms = _time_launch(run)
                dev, seen = _kernel_ms(run, SHARD_KERNELS[kid])
                require(seen == 50, f"{kid} {key}: the trace kept all 50 "
                                    f"launches, got {seen}")
                mode = "halo_mode" if kid.endswith("halo") else "interior"
                b = bounds[f"{kid[:2]} {mode}"]
                out[(kid, key)] = dict(ms=ms, device_ms=dev,
                                       plain_ms=_time_launch(plain, n=5),
                                       bound=b)
                lines.append(f"{kid} {key} {shard}: {ms:.4f} ms wall, "
                             f"{dev:.4f} on the device ({seen} of 50 "
                             f"launches kept), plain "
                             f"{out[(kid, key)]['plain_ms']:.3f}; bound "
                             f"{b[0]:.4f} ms ({b[1]}): "
                             f"{b[0] / dev:.1%} of it on the device")
            del s, x, x0, y_A, y_D, x_ext, y_ext
    log("[24 B1 / B2 on a shard per launch, hybrid reg_time=0.5, one shard "
        f"of {MAIN_4D} with its ghost or neighbour planes] "
        + "; ".join(lines) + f"; card {card}")
    sync()
    return out


def phase_halo_kernels(card):
    errs = {k: {"f32": 0.0, "bf16": 0.0}
            for k in ("B1halo", "B2halo", "B1int", "B2int", "B8dual",
                      "B8primal", "B3halo", "B4halo")}

    def note(key, kind, *pairs, scale=0.0, tol=F32_TOL):
        for got, ref in pairs:
            errs[key][kind] = max(errs[key][kind], _compare(
                got, ref, kind == "bf16", scale, tol))

    n, solves, loss_rel = 0, 0, 0.0
    full = ("hybrid-time", "hybrid-time-tmul-l1", "hybrid-time-f32+bf16dual",
            "hybrid-time-bf16+bf16dual")  # at the path's shard shape
    for halo_shape, halo_mesh, ov_shape in (
            (HALO_SMALL, HALO_SMALL_MESH, OVERLAP_SMALL),
            (MAIN_4D, SHARDED_MESH, MAIN_4D)):
        gen = torch.Generator(device=DEV).manual_seed(2468)
        for name, cfg, opts, storage in _halo_cp_cases():
            if halo_shape == MAIN_4D and name not in full:
                continue
            kind = "f32" if storage == "f32" else "bf16"
            # B1 / B2 in halo mode: the ghost-plane step, shard by shard
            s = _ShardedState(halo_shape, halo_mesh, cfg, opts, storage, gen)
            mode = dict(halo_mode=True, t_sharded=s.st, **s.sharded)
            x_ext = fused_halo._extend_axis(
                fused_halo._extend_axis(s.x, 0, s.ghost_z), 1, s.ghost_t)
            (kx, kA, kD), (px, pA, pD) = s.copies(), s.copies()
            for xe, x0, a, d, pa, pd in _cells(x_ext, s.x0, kA, kD, pA, pD):
                _, _, tv_k = fused.cp_dual(xe, x0, a, d, s.tm, **mode,
                                           **s.dual_kw)
                _, _, tv_p = fused.cp_dual_plain(xe, x0, pa, pd, s.tm, **mode,
                                                 **s.dual_kw)
                note("B1halo", kind, (a, pa), (d, pd))
                rel = abs(float(tv_k.sum() - tv_p.sum())) / float(tv_p.sum())
                require(rel <= 1e-5, f"B1 halo {name}: TV sum {rel:.3g}")
            k_ext = fused_halo._extend_dual(kD, s.chans)
            p_ext = fused_halo._extend_dual(pD, s.chans)
            for xs, x0, a, d, e, ps, pa, pd, pe in _cells(
                    kx, s.x0, kA, kD, k_ext, px, pA, pD, p_ext):
                fused.cp_primal(xs, x0, a, d, s.tm, y_ext=e, **mode,
                                **s.primal_kw)
                fused.cp_primal_plain(ps, x0, pa, pd, s.tm, y_ext=pe, **mode,
                                      **s.primal_kw)
                note("B2halo", kind, (xs, ps), scale=0.5)

            # B1 / B2 with interior, then B8 on the edge planes, and 20
            # iterations of the overlapped step against the ghost path
            s = _ShardedState(ov_shape, (halo_mesh[0], 1), cfg, opts, storage,
                              gen)
            if not any(ch.axis == AXIS_Z for ch in s.chans):
                continue
            _interior_and_boundary(s, name, kind, note)
            loss_rel = max(loss_rel, _overlap_vs_ghost(
                ov_shape, (halo_mesh[0], 1), cfg, opts, storage, gen))
            n, solves = n + 1, solves + 1
            del s
        sync()

    # every table and storage the B8 kernels are built for, at an even and
    # an odd width (runs read element by element)
    n_tab = 0
    gen = torch.Generator(device=DEV).manual_seed(8642)
    for tid, (scheme, reg_time, M) in B8_TABLE_CONFIGS.items():
        cfg = TVConfig(scheme=scheme, reg_time=reg_time)
        for storage, shape in itertools.product(
                SHARD_STORAGE, ((9, M, 16, 130), (9, M, 7, 37))):
            require(tables.boundary_table_id(cfg, *shape[:2]) == tid,
                    f"{scheme} reg_time={reg_time} {shape}: table {tid}")
            name = f"table {tid} {storage} {shape}"
            kind = "f32" if storage == "f32" else "bf16"
            _interior_and_boundary(_ShardedState(shape, (3, 1), cfg, {},
                                                 storage, gen),
                                   name, kind, note)
            loss_rel = max(loss_rel, _overlap_vs_ghost(
                shape, (3, 1), cfg, {}, storage, gen))
            n_tab, solves = n_tab + 1, solves + 1
    sync()

    # B3 / B4 in halo mode: shard by shard against the plain versions, and
    # gathered bit for bit against the unsharded per-table kernels
    n_tv = 0
    for shape, mesh_zt in ((HALO_SMALL, HALO_SMALL_MESH),
                           (MAIN_4D, SHARDED_MESH), (MAIN_4D, GRID_2X2)):
        gen = torch.Generator(device=DEV).manual_seed(1357)
        for name, cfg, use_tmul, dtype in _gd_cases():
            if shape == MAIN_4D and name not in ("hybrid-time",
                                                 "hybrid-time-tmul-huber",
                                                 "hybrid-zt-bf16"):
                continue
            xw = torch.rand(shape, generator=gen, device=DEV).to(dtype)
            tm = _gd_tmul(shape, cfg, gen) if use_tmul else None
            _halo_tv_case(f"{name} {shape} on {mesh_zt}", xw, tm, cfg,
                          mesh_zt, note)
            n_tv += 1
        sync()
    # every table the B3 / B4 halo kernels are built for x both storages x
    # an even and an odd width, on a z-cut and a t-cut mesh
    n_tv_tab = 0
    gen = torch.Generator(device=DEV).manual_seed(9753)
    for tid, (cfg, dims) in _halo_tv_table_configs().items():
        for dtype, rc, mesh_zt in itertools.product(
                (torch.float32, torch.bfloat16), HALO_TV_WIDTHS,
                ((2, 1), (1, 2))):
            shape = dims + rc
            xw = torch.rand(shape, generator=gen, device=DEV).to(dtype)
            _halo_tv_case(f"table {tid} {str(dtype)[6:]} {shape} on "
                          f"{mesh_zt}", xw, None, cfg, mesh_zt, note)
            n_tv_tab += 1
    sync()
    # B1 / B2 on a shard over every table and storage pair, each step bit
    # for bit the unsharded kernels' on the gathered volume
    n_cp_tab, n_steps = _halo_cp_tables()
    tv_times = _halo_tv_times(card)
    cp_times = _halo_cp_times(card)
    log(f"[24 sharded kernel modes vs plain] {n} CP cases and {n_tv} TV "
        f"cases, shard by shard, at {HALO_SMALL} on a "
        f"{HALO_SMALL_MESH} mesh / {OVERLAP_SMALL} on "
        f"{OVERLAP_SMALL_MESH} and at {MAIN_4D} as 4 z-shards of {SHARD_4D} "
        f"(TV also as a {GRID_2X2} grid of {SHARD_2X2}): "
        f"pass; B3 / B4 halo also over all {len(tables.TABLES)} tables they "
        f"are built for x f32, bf16 x {HALO_TV_WIDTHS} on a (2, 1) and a "
        f"(1, 2) mesh ({n_tv_tab} cases); in all {n_tv + n_tv_tab} TV cases "
        f"the gathered norms and G bit-equal to the unsharded per-table "
        f"kernels'; max abs err f32 / bf16: "
        + ", ".join(f"{k} {v['f32']:.3g} / {v['bf16']:.3g}"
                    for k, v in errs.items())
        + f"; B8 also over every table it is built for x {len(SHARD_STORAGE)} "
        f"storage pairs x 2 widths at (9, M, 16, 130) / (9, M, 7, 37) on 3 "
        f"z-shards ({n_tab} cases); {solves} sharded solves of 20 iterations "
        f"on the overlapped step bit-equal to the ghost path's in x, y_A and "
        f"y_D (losses within {loss_rel:.3g}); B1 / B2 on a shard over every "
        f"table and storage pair they are built for ({len(tables.TABLES)} x "
        f"{len(SHARD_STORAGE)} x {HALO_TV_WIDTHS} in halo mode on a 1 x 1 "
        f"grid, a (2, 1) and a (1, 2) mesh; {len(B8_TABLE_CONFIGS)} x "
        f"{len(SHARD_STORAGE)} x 2 widths at 9 slices on 3 z-shards in halo "
        f"mode and with interior + B8; {n_cp_tab} cases): all {n_steps} "
        f"sharded steps' x', y_A', y_D' bit-equal to the unsharded kernels' "
        f"on the gathered volume")
    return errs, tv_times, cp_times


# ---------------------------------------------------------------- phase 25
def _sharded_cp(noisy, cfg, mesh_zt, n_iter, reg, **solver_kw):
    """A cold sharded fused CP solve from a numpy volume through the entry
    points a user calls; ``(x, y_A, y_D_int, losses)`` gathered, and the
    solver."""
    mesh = make_mesh(*mesh_zt)
    st_time = mesh_zt[1] > 1
    solve = make_sharded_cp_solver_fused(
        mesh, cfg, noisy.shape, reg=reg, n_iter=n_iter, shard_time=st_time,
        **solver_kw)
    x0 = shard_volume(noisy, mesh, st_time)
    st = init_state(torch.as_tensor(noisy, device=DEV), cfg)
    y_D = fused.to_internal_layout(st.y_D)
    if "dtype" in solver_kw:
        dt = getattr(torch, solver_kw["dtype"])
        x0 = grid_map(lambda a: a.to(dt), x0)
        st, y_D = st._replace(x=st.x.to(dt), y_A=st.y_A.to(dt)), y_D.to(dt)
    x, y_A, y_D, losses = solve(
        x0, shard_volume(st.x, mesh, st_time),
        shard_volume(st.y_A, mesh, st_time),
        shard_volume(y_D, mesh, st_time))
    return gather_volume(x), gather_volume(y_A), gather_volume(y_D), losses


def _same_state(got, ref, what):
    """Sharded ``(x, y_A, y_D_int)`` against a CPResult, slot for slot:
    equal to the bit, else the max abs err within the f32 bar."""
    worst = 0.0
    for g, r in zip(got, (ref.x, ref.state.y_A,
                          fused.to_internal_layout(ref.state.y_D))):
        if not torch.equal(g, r.to(g.dtype)):
            worst = max(worst, _compare(g, r, False, 0.0))
    return f"{what}: " + ("bit-equal" if worst == 0.0
                          else f"max abs err {worst:.3g}")


# what the device time of a sharded CP step is split into, by kernel name
STEP_PARTS = {"B1": ("cp_dual_shard_kernel", "cp_dual_spec_kernel"),
              "B2": ("cp_primal_shard_kernel", "cp_primal_spec_kernel"),
              "B8": ("bnd_dual_kernel", "bnd_primal_kernel"),
              "copies": ("Cat", "copy", "Memcpy", "where")}


def _step_split(by_kernel):
    """``device_time``'s ms by kernel summed into :data:`STEP_PARTS` and the
    rest."""
    out = dict.fromkeys((*STEP_PARTS, "rest"), 0.0)
    for name, ms in by_kernel.items():
        out[next((part for part, keys in STEP_PARTS.items()
                  if any(k in name for k in keys)), "rest")] += ms
    return out


def phase_sharded_main_path(card):
    cfg = TVConfig(scheme="hybrid", reg_time=0.5)
    base = np.random.default_rng(0).random(MAIN_4D).astype(np.float32)
    n_it, n_sh = 20, SHARDED_MESH[0]
    ref = chambolle_pock(torch.as_tensor(base, device=DEV), n_iter=n_it,
                         reg=1.0, cfg=cfg)
    out, launches = {}, {}
    for overlap in (False, True):
        sync()
        zero_counters()
        out[overlap] = _sharded_cp(base, cfg, SHARDED_MESH, n_it, 1.0,
                                   overlap=overlap)
        sync()
        launches[overlap] = read_counters()
    per = n_it * n_sh  # per iteration and shard: one launch of each kernel
    require_launches(launches[False], "sharded CP, ghost path", B1=per, B2=per,
                     B1halo=per, B2halo=per)
    require_launches(launches[True], "sharded CP, overlap path", B1=per,
                     B2=per, B8dual=per, B8primal=per, B1int=per, B2int=per)
    for g, o, name in zip(out[False][:3], out[True][:3], ("x", "y_A", "y_D")):
        require(torch.equal(g, o) and g.is_cuda and bool(
            torch.isfinite(g).all()),
            f"overlap path's {name} equals the ghost path's bit for bit")
    lines = []
    for overlap in (False, True):
        rel = float(((out[overlap][3] - ref.loss).abs() / ref.loss).max())
        require(rel <= 1e-6, f"sharded losses within 1e-6 of the unsharded "
                             f"solve's, got {rel:.3g}")
        lines.append(_same_state(
            out[overlap][:3], ref, "overlap" if overlap else "ghost")
            + f", losses within {rel:.3g}")
    log(f"[25 sharded main path] {MAIN_4D} f32 hybrid reg_time=0.5 from numpy "
        f"as {n_sh} z-shards on one card, {n_it} iterations: launches ghost "
        f"{launches[False]}, overlap {launches[True]}; overlap == ghost bit "
        f"for bit; against chambolle_pock: " + "; ".join(lines))
    del out

    # time sharded too: a (2 x 2) mesh (ghost path; overlap needs z only)
    small = np.random.default_rng(1).random((8, 4, 128, 128)).astype(
        np.float32)
    zero_counters()
    got = _sharded_cp(small, cfg, (2, 2), n_it, 1.0)
    sync()
    two = read_counters()
    require_launches(two, "sharded CP on a (2 x 2) mesh", B1=4 * n_it,
                     B2=4 * n_it, B1halo=4 * n_it, B2halo=4 * n_it)
    ref_s = chambolle_pock(torch.as_tensor(small, device=DEV), n_iter=n_it,
                           reg=1.0, cfg=cfg)
    rel = float(((got[3] - ref_s.loss).abs() / ref_s.loss).max())
    require(rel <= 1e-6, f"(2 x 2) mesh losses {rel:.3g}")
    log(f"[25 t-sharded] (8, 4, 128, 128) on a (2 z x 2 t) mesh, ghost path: "
        + _same_state(got[:3], ref_s, "against chambolle_pock")
        + f", losses within {rel:.3g}")

    # bf16 primary and dual on the overlapped path
    b16 = torch.as_tensor(base, device=DEV).to(torch.bfloat16)
    ref_b = chambolle_pock(b16, n_iter=n_it, reg=1.0, cfg=cfg)
    got = _sharded_cp(base, cfg, SHARDED_MESH, n_it, 1.0, overlap=True,
                      dtype="bfloat16")
    require(got[0].dtype == torch.bfloat16 and got[2].dtype == torch.bfloat16,
            "bf16 storage kept")
    rel = float(((got[3] - ref_b.loss).abs() / ref_b.loss).max())
    require(rel <= 1e-4, f"bf16 sharded losses {rel:.3g}")
    log(f"[25 bf16] {MAIN_4D} bf16 primary + dual, overlap path: "
        + _same_state(got[:3], ref_b, "against chambolle_pock in bf16")
        + f", losses within {rel:.3g}")
    del got, ref_b, b16

    # the sharded GD solver
    mesh = make_mesh(*SHARDED_MESH)
    zero_counters()
    gd = make_sharded_gd_solver_fused(mesh, cfg, MAIN_4D, reg=1.0,
                                      n_iter=n_it, step_size=5e-3,
                                      shard_time=False)
    xs = shard_volume(base, mesh, False)
    gx, glosses = gd(xs, xs)
    sync()
    gd_launches = read_counters()
    require_launches(gd_launches, "sharded GD", B3=per, B4=per)
    gref = subgradient_descent(torch.as_tensor(base, device=DEV), n_iter=n_it,
                               reg=1.0, step_size=5e-3, cfg=cfg)
    gx = gather_volume(gx)
    gerr = float((gx - gref.x).abs().max())
    grel = float(((glosses - gref.loss).abs() / gref.loss).max())
    require(gerr <= F32_TOL_GD["atol"] and grel <= 1e-5,
            f"sharded GD against subgradient_descent: x {gerr:.3g}, losses "
            f"{grel:.3g}")
    whole = torch.as_tensor(base, device=DEV)
    gd_ms = (_best_ms(lambda: gd(xs, xs)) / n_it,
             _best_ms(lambda: subgradient_descent(
                 whole, n_iter=n_it, reg=1.0, step_size=5e-3, cfg=cfg)) / n_it,
             device_time(lambda: gd(xs, xs), n_it, DEV)[0])
    log(f"[25 sharded GD] {MAIN_4D} f32 as {n_sh} z-shards, {n_it} "
        f"iterations: x "
        + ("bit-equal" if torch.equal(gx, gref.x) else f"within {gerr:.3g}")
        + f" of subgradient_descent's, losses within {grel:.3g}; "
        f"{gd_ms[0]:.4f} ms per iteration (device {gd_ms[2]:.4f}, "
        f"torch.profiler) against {gd_ms[1]:.4f} unsharded (whole "
        f"{n_it}-iteration solves, best of 3); card {card}")
    del gx, gref, xs

    # 300 iterations: 8 noisy cameraman slices, upwind (z coupled), 4
    # z-shards of 2 planes
    stack = np.stack([add_noise(cameraman(), 100, seed=z) for z in range(8)]
                     ).astype(np.float32)[:, None]
    up = TVConfig(scheme="upwind")
    long_ref = chambolle_pock(torch.as_tensor(stack, device=DEV), n_iter=300,
                              reg=25.0, cfg=up, return_dual=False)
    long_got = _sharded_cp(stack, up, SHARDED_MESH, 300, 25.0)
    rel = abs(float(long_got[3][-1] - long_ref.loss[-1])) / float(
        long_ref.loss[-1])
    require(rel < 1e-4 and bool(torch.isfinite(long_got[0]).all()),
            f"300-iteration sharded loss within 1e-4 of the unsharded, got "
            f"{rel:.3g}")
    log(f"[25 300 iterations] {stack.shape} upwind reg 25 as 4 z-shards: "
        f"final loss {float(long_got[3][-1]):.2f}, rel err {rel:.3g} vs the "
        f"unsharded {float(long_ref.loss[-1]):.2f}; x "
        + ("bit-equal" if torch.equal(long_got[0], long_ref.x) else
           f"max abs err {float((long_got[0] - long_ref.x).abs().max()):.3g}"))
    del long_got, long_ref

    # times: a whole 40-iteration solve over 40 (its set-up, copies of the
    # state, is under 0.02 ms an iteration)
    mesh = make_mesh(*SHARDED_MESH)
    x0 = shard_volume(base, mesh, False)
    st = init_state(torch.as_tensor(base, device=DEV), cfg)
    args = (x0, shard_volume(st.x, mesh, False),
            shard_volume(st.y_A, mesh, False),
            shard_volume(fused.to_internal_layout(st.y_D), mesh, False))
    del st

    def sharded(overlap, side_stream):
        def run(n):
            solve = make_sharded_cp_solver_fused(
                mesh, cfg, MAIN_4D, reg=1.0, n_iter=n, shard_time=False,
                overlap=overlap)
            solve.side_stream = side_stream
            solve(*args)
        return run

    paths = {"unsharded": lambda n: chambolle_pock(
                 whole, n_iter=n, reg=1.0, cfg=cfg, return_dual=False),
             "ghost": sharded(False, False),
             "overlap, one stream": sharded(True, False),
             "overlap, halo copies on a second stream": sharded(True, True)}
    ms = {k: [] for k in paths}
    for name in (*paths, *reversed(paths), *paths):  # three times, in turns
        ms[name].append(_best_ms(lambda: paths[name](40)) / 40)
    step_ms = {k: min(v) for k, v in ms.items()}
    # the device's share of an iteration: what torch.profiler sums over a
    # 20-iteration solve, and its split by kernel
    dev = {k: device_time(lambda: paths[k](20), 20, DEV) for k in paths}
    dev_ms = {k: v[0] for k, v in dev.items()}
    splits = {k: _step_split(dev[k][1]) for k in ("ghost",
                                                  "overlap, one stream")}
    log(f"[25 times, {MAIN_4D} f32, 4 z-shards] ms per iteration (a "
        f"40-iteration solve, best of 3, three times in turns: least, and "
        f"the turns' spread): "
        + ", ".join(f"{k} {v:.4f} (to {max(ms[k]):.4f}; device "
                    f"{dev_ms[k]:.4f})" for k, v in step_ms.items())
        + f"; ghost / unsharded {step_ms['ghost'] / step_ms['unsharded']:.3f}"
        f", overlap / unsharded "
        f"{step_ms['overlap, one stream'] / step_ms['unsharded']:.3f}; card "
        f"{card}")
    log(f"[25 split, {MAIN_4D} f32, 4 z-shards] device ms per iteration "
        "(torch.profiler over a 20-iteration solve): "
        + "; ".join(f"{k} {dev_ms[k]:.4f} = " + ", ".join(
            f"{part} {t:.4f}" for part, t in v.items())
            for k, v in splits.items()) + f"; card {card}")

    # per launch at the shard: the two B8 kernels and B1 / B2 with interior
    s = _ShardedState(MAIN_4D, SHARDED_MESH, cfg, {}, "f32",
                      torch.Generator(device=DEV).manual_seed(99))
    x, x0s, y_A, y_D = (g[1][0] for g in (s.x, s.x0, s.y_A, s.y_D))
    x_halo = fused_halo._halo_planes(s.x, 0, s.ghost_z)[1][0]
    y_halo = fused_halo._sparse_channel_halo(s.y_D, 0, s.chans, AXIS_Z)[1][0]
    dk, pk = dict(s.dual_kw, **s.sharded), dict(s.primal_kw, **s.sharded)
    _, _, tv = fused.cp_dual(x, x0s, y_A, y_D, interior=True, **dk)
    _, fid = fused.cp_primal(x, x0s, y_A, y_D, interior=True, **pk)
    tv_p = torch.zeros((x.shape[0], 1), device=DEV)
    x_ext = fused_halo._extend_axis(fused_halo._extend_axis(
        s.x, 0, s.ghost_z), 1, s.ghost_t)[1][0]
    y_ext = fused_halo._extend_dual(s.y_D, s.chans)[1][0]

    def b8_dual():
        fused.cp_dual_boundary(x, x_halo, x0s, y_A, y_D, tv, **dk)

    def b8_primal():
        fused.cp_primal_boundary(x, x0s, y_A, y_D, y_halo, fid, **pk)

    launch_ms = {
        "B8dual": (_time_launch(b8_dual),
                   _time_launch(lambda: fused.cp_dual_boundary_plain(
                       x, x_halo, x0s, y_A, y_D, tv_p, **dk), n=10)),
        "B8primal": (_time_launch(b8_primal),
                     _time_launch(lambda: fused.cp_primal_boundary_plain(
                         x, x0s, y_A, y_D, y_halo, tv_p, **pk), n=10)),
        "B1 interior": (_time_launch(lambda: fused.cp_dual(
            x, x0s, y_A, y_D, interior=True, **dk)), None),
        "B2 interior": (_time_launch(lambda: fused.cp_primal(
            x, x0s, y_A, y_D, interior=True, **pk)), None),
        "B1 whole shard": (_time_launch(lambda: fused.cp_dual(
            x, x0s, y_A, y_D, **s.dual_kw)), None),
        "B2 whole shard": (_time_launch(lambda: fused.cp_primal(
            x, x0s, y_A, y_D, **s.primal_kw)), None),
        "B1 halo_mode": (_time_launch(lambda: fused.cp_dual(
            x_ext, x0s, y_A, y_D, halo_mode=True, **dk)), None),
        "B2 halo_mode": (_time_launch(lambda: fused.cp_primal(
            x, x0s, y_A, y_D, halo_mode=True, y_ext=y_ext, **pk)), None),
    }
    # bytes: dual (4 + 2 Nd) arrays of the two planes and the x halo stack;
    # primal (4 + Nd) and the z channels' halo slots it reads (one per
    # fwd / bwd channel, two per ctr one).  Operations as B1 / B2 per voxel.
    Nd = len(s.chans)
    edge = 2 * int(np.prod(SHARD_4D[1:]))
    z_reads = sum(2 if ch.kind == "ctr" else 1 for ch in s.chans
                  if ch.axis == AXIS_Z)
    bounds = {"B8dual": bound(((4 + 2 * Nd) * edge + edge) * 4,
                              (10 * Nd + 10) * edge),
              "B8primal": bound(((4 + Nd) * edge + z_reads * edge // 2) * 4,
                                (4 * Nd + 8) * edge)}
    # a loop of such short launches runs at the host's pace: the kernels'
    # own time is what torch.profiler records on the device
    b8 = (("B8dual", b8_dual), ("B8primal", b8_primal))
    on_dev = {k: device_time(lambda: [fn() for _ in range(50)], 50, DEV)[0]
              for k, fn in b8}
    # the wrapper's own time: what a launch costs the host, which sets the
    # pace wherever it exceeds the kernel's
    host = {k: _host_us(fn) for k, fn in b8}
    log(f"[25 per launch at the shard {SHARD_4D} f32] "
        + ", ".join(f"{k} {v[0]:.4f} ms"
                    + (f" (plain {v[1]:.3f} ms)" if v[1] else "")
                    for k, v in launch_ms.items())
        + f" (CUDA events around 50 launches); on the device "
        f"(torch.profiler): B8dual {on_dev['B8dual']:.4f} ms, B8primal "
        f"{on_dev['B8primal']:.4f} ms; host per launch (200 calls behind "
        f"a busy device): B8dual {host['B8dual']:.1f} us, B8primal "
        f"{host['B8primal']:.1f} us; B8 bounds: dual "
        f"{bounds['B8dual'][0]:.4f} ms, primal {bounds['B8primal'][0]:.4f} ms "
        f"({bounds['B8dual'][1]}): wall per launch "
        + ", ".join(f"{k} {launch_ms[k][0]:.4f} ms = "
                    f"{bounds[k][0] / launch_ms[k][0]:.1%} of the bound, "
                    f"kernel alone {on_dev[k]:.4f} ms = "
                    f"{bounds[k][0] / on_dev[k]:.1%}" for k, _ in b8)
        + f"; card {card}")
    cp_bounds = _halo_cp_bounds(SHARD_4D, cfg, MAIN_4D[:2], torch.float32,
                                torch.float32)
    log(f"[25 B1 / B2 sharded modes per launch at the shard {SHARD_4D} f32] "
        + ", ".join(f"{k} {launch_ms[k][0]:.4f} ms, bound {b[0]:.4f} ms "
                    f"({b[1]}): {b[0] / launch_ms[k][0]:.1%}"
                    for k, b in cp_bounds.items())
        + f"; card {card}")
    sync()
    # B1 and B2 on a shard by mode, as their counters read: the ghost-plane
    # step's (4 z-shards, and the (2 x 2) mesh) and the overlapped step's
    runs = (("ghost z4", launches[False]), ("overlap z4", launches[True]),
            ("ghost 2x2", two))
    modes = {kid: {run: got[kid] for run, got in runs if got[kid]}
             for kid in SHARD_KERNELS}
    return launches[True], gd_launches, launch_ms, bounds, modes


# ---------------------------------------------------------------- phase 26
# the JAX package's cone bench geometry (bench/harness.py::bench_ct_cone:
# the source at twice the width, the detector at the width); the fan takes
# the same distances.  Full orbit, CT_ANGLES angles; the cone's detector is
# (Nz, N): a (M, CT_ANGLES, 16, 512) sinogram
FAN = FanBeamGeometry(source_dist=2.0 * CT_SHAPE[-1], det_dist=CT_SHAPE[-1])
CONE = ConeBeamGeometry(source_dist=2.0 * CT_SHAPE[-1],
                        det_dist=CT_SHAPE[-1])
# the small check: each geometry at 1/16 of the width, f32 on the card
# against float64 on the CPU; the CPU's f32 lands 1e-6 to 1e-5 of the scale
# from its f64 there (A, A_T, FDK, SART), so 1e-4 of the scale holds the
# card to f32 round-off with ten times the room
CT_GEOM_SMALL = (4, 2, 32, 32)
CT_GEOM_TOL = 1e-4


def _geometry(geom):
    """(name, forward projection, pair builder) of a beam geometry."""
    if isinstance(geom, ConeBeamGeometry):
        return "cone", radon_cone, make_cone_projector
    return "fan", radon_fan, make_fan_projector


def _rel_err(got, ref):
    return float((got.cpu().double() - ref).abs().max() / ref.abs().max())


def _geometry_small(geom):
    """A, A_T, FDK and two SART epochs at CT_GEOM_SMALL on the card in f32
    against the same on the CPU in float64: the largest error of each over
    its reference's scale."""
    name, project, pair = _geometry(geom)
    shape = CT_GEOM_SMALL
    small = geom._replace(source_dist=geom.source_dist * shape[-1]
                          / CT_SHAPE[-1],
                          det_dist=geom.det_dist * shape[-1] / CT_SHAPE[-1])
    angles = np.linspace(0.0, 2 * np.pi, 16, endpoint=False)
    rng = np.random.default_rng(0)
    vol = rng.random(shape)
    cpu = torch.device("cpu")
    ref = project(vol, angles, small, device=cpu)
    errs = {"A": _rel_err(project(vol.astype(np.float32), angles, small),
                          ref)}
    y = rng.standard_normal(tuple(ref.shape))
    _, A_T64 = pair(shape, angles, small, dtype=torch.float64)
    _, A_T32 = pair(shape, angles, small)
    errs["A_T"] = _rel_err(A_T32(torch.as_tensor(y, dtype=torch.float32,
                                                 device=DEV)),
                           A_T64(torch.as_tensor(y)))
    if name == "cone":
        errs["fdk"] = _rel_err(
            fdk(ref.float().numpy(), angles, small, shape, method="gather"),
            fdk(ref, angles, small, shape, method="gather"))
    kw = dict(n_iter=2, n_subsets=8, geom=small, method="gather")
    got = sart(ref.float().numpy(), angles, shape, **kw)
    want = sart(ref, angles, shape, **kw)
    errs["sart"] = max(_rel_err(got.x, want.x),
                       _rel_err(got.residual, want.residual))
    require(got.x.device == DEV
            and all(e <= CT_GEOM_TOL for e in errs.values()),
            f"{name} at {shape}: card f32 vs CPU float64 {errs}")
    return errs


def phase_ct_geometries(card):
    """Fan- and cone-beam CT at full width: each geometry's projector pair,
    a 10-iteration cp_reconstruct on B5 + B2 (+ B3 for the loss) against
    the plain step, its split, FDK (cone) and SART; returns each
    geometry's launch counts."""
    cfg = TVConfig(**CT_CFG)
    angles = np.linspace(0.0, 2 * np.pi, CT_ANGLES, endpoint=False)
    n_iter, reg = 10, 0.5
    fw = torch.ones((), device=DEV)
    launches = {}
    for geom in (FAN, CONE):
        name, project, pair = _geometry(geom)
        small = _geometry_small(geom)
        gen = torch.Generator(device=DEV).manual_seed(0)
        vol = torch.rand(CT_SHAPE, generator=gen, device=DEV)
        sino = project(vol, angles, geom)
        sino += 0.5 * torch.randn(sino.shape, generator=gen, device=DEV)
        A, A_T = pair(CT_SHAPE, angles, geom)
        ops = {"A": _time_launch(lambda: A(vol), n=3),
               "A_T": _time_launch(lambda: A_T(sino), n=3)}
        del vol
        start = time.perf_counter()
        op_norm = float(estimate_op_norm(A, A_T, CT_SHAPE, device=DEV))
        ops["estimate_op_norm"] = (time.perf_counter() - start) * 1e3
        kw = dict(n_iter=n_iter, reg=reg, cfg=cfg, nonneg=True,
                  op_norm=op_norm, geom=geom, method="gather")

        def solve(**more):
            return cp_reconstruct(sino, angles, CT_SHAPE, **kw, **more)

        sync()
        torch.cuda.reset_peak_memory_stats(DEV)
        zero_counters()
        res = solve()
        sync()
        launches[name] = read_counters()
        require_launches(launches[name], f"{name} cp_reconstruct",
                         B5=n_iter, B2=n_iter, B3=n_iter)
        peak = {"cp_reconstruct": torch.cuda.max_memory_allocated(DEV)}
        loss = res.loss
        require(bool(torch.isfinite(loss).all())
                and float(loss[-1]) < float(loss[0])
                and tuple(res.x.shape) == CT_SHAPE
                and bool(torch.isfinite(res.x).all()),
                f"{name}: finite x, losses finite and falling")
        st = res.state
        del res
        ms = _best_ms(solve, repeats=2) / n_iter
        plain = solve(fused=False)
        rel = abs(float(loss[-1]) - float(plain.loss[-1])) \
            / float(plain.loss[-1])
        require(rel <= 1e-4, f"{name} fused vs plain final loss {rel:.3g}")
        err_x = float((st.x - plain.x).abs().max())
        del plain
        dev_ms, _ = device_time(solve, n_iter, DEV)

        # the split of one fused iteration, each part alone on the final
        # state (as phase 18)
        sigma = 1.0 / np.sqrt(op_norm ** 2 + operator_norm_bound_sq(
            cfg.scheme, CT_SHAPE[0], CT_SHAPE[1], cfg.reg_z_over_reg,
            cfg.reg_time))
        x, x_bar, y_A = st.x, st.x_bar, st.y_A
        y_D = fused.to_internal_layout(st.y_D)
        at, out = A_T(y_A), torch.empty_like(x)
        split = {
            "A": ops["A"], "A_T": ops["A_T"],
            "B5": _time_launch(lambda: fused.tv_dual(
                x_bar, y_D, cfg=cfg, sigma_D=sigma, reg=reg)),
            "B2": _time_launch(lambda: fused.cp_primal(
                x, x, at, y_D, cfg=cfg, tau=sigma, nonneg=True, out=out)),
            "B3 + loss": _time_launch(lambda: torch.add(
                fidelity_loss(st.s_x, sino, "l2", fw),
                torch.sum(fused.tv_norms(x, cfg=cfg)[1]), alpha=reg))}
        del st, x, x_bar, y_A, y_D, at, out

        def peak_of(fn):
            sync()
            torch.cuda.reset_peak_memory_stats(DEV)
            out = fn()
            sync()
            return out, torch.cuda.max_memory_allocated(DEV)

        extra = ""
        if name == "cone":
            rec, peak["fdk"] = peak_of(
                lambda: fdk(sino, angles, geom, CT_SHAPE, method="gather"))
            require(tuple(rec.shape) == CT_SHAPE
                    and bool(torch.isfinite(rec).all()), "FDK is finite")
            del rec
            ops["fdk"] = _best_ms(lambda: fdk(sino, angles, geom, CT_SHAPE,
                                              method="gather"), repeats=1)
            extra = f"fdk {ops['fdk']:.1f} ms, "
        sart_kw = dict(n_iter=2, n_subsets=8, geom=geom, method="gather")
        rec, peak["sart"] = peak_of(
            lambda: sart(sino, angles, CT_SHAPE, **sart_kw))
        r = rec.residual
        require(bool(torch.isfinite(rec.x).all()) and float(r[1]) < float(
            r[0]), f"{name} SART: finite, residual falling")
        del rec
        ops["sart"] = _best_ms(lambda: sart(sino, angles, CT_SHAPE,
                                            **sart_kw), repeats=1)
        log(f"[26 CT {name} full width] {type(geom).__name__}"
            f"{tuple(geom)}, {CT_SHAPE} f32 x {CT_ANGLES} angles over 2 pi, "
            f"sinogram {tuple(sino.shape)}; small check {CT_GEOM_SMALL} "
            f"card f32 vs CPU float64, max err / scale "
            + ", ".join(f"{k} {v:.2g}" for k, v in small.items())
            + f"; A {ops['A']:.2f} ms, A_T {ops['A_T']:.2f} ms (CUDA events, "
            f"3 calls), estimate_op_norm {ops['estimate_op_norm']:.0f} ms "
            f"(host clock) = {op_norm:.2f}; cp_reconstruct(hybrid "
            f"reg_time=0.5, reg {reg}, nonneg, {n_iter} iterations): "
            f"launches {launches[name]}, loss {float(loss[0]):.6g} -> "
            f"{float(loss[-1]):.6g}, {1e3 / ms:.3f} it/s ({ms:.2f} ms/it, "
            f"best of 2 whole calls), device {dev_ms:.2f} ms/it "
            f"(torch.profiler), idle {100 * (1 - dev_ms / ms):.1f}%; fused "
            f"vs plain final loss rel {rel:.3g}, x max abs err {err_x:.3g}; "
            f"one iteration {ms:.2f} ms = "
            + " + ".join(f"{k} {v:.3f}" for k, v in split.items())
            + f" + rest {ms - sum(split.values()):.3f}; {extra}"
            f"sart(2 epochs, 8 subsets) {ops['sart']:.1f} ms; peak memory "
            + ", ".join(f"{k} {v / 1e9:.2f} GB" for k, v in peak.items())
            + f"; card {card}")
        del sino, loss
        torch.cuda.empty_cache()
    sync()
    return launches


# ---------------------------------------------------------------- phase 27
def phase_compat(card):
    """The reference's own entry points: the GPU battery on the card, and
    tv_CPU (float64 on the CPU) against tv_GPU (f32 on the card) on the
    README's input."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ok = pytv4d_tpu_torch.run_GPU_tests()
    text = buf.getvalue()
    require(ok and text.count("[PASS]") == 12
            and "All GPU tests passed." in text,
            f"run_GPU_tests: {text!r}")
    np.random.seed(0)
    img = np.random.rand(20, 4, 100, 100)
    tv_c, G_c = tv_CPU.tv_hybrid(img)
    require(abs(tv_c - README_TV) <= 1e-12 * README_TV,
            f"tv_CPU.tv_hybrid {tv_c!r} vs {README_TV}")
    zero_counters()
    tv_g, G_g = tv_GPU.tv_hybrid(img)
    sync()
    require_launches(read_counters(), "tv_GPU.tv_hybrid", B3=1, B4=1)
    rel = abs(tv_g - tv_c) / tv_c
    require(rel <= 1e-4, f"tv_GPU vs tv_CPU: rel {rel:.3g}")
    err_G = testing.test_equal(G_c, G_g, 1e-4, "G")
    log(f"[27 compat] run_GPU_tests() on {torch.cuda.get_device_name()}: "
        f"{text.count('[PASS]')} [PASS] (adjointness, 2D->3D and CPU vs GPU "
        f"for the four schemes); README input rand(20, 4, 100, 100), seed "
        f"0: tv_CPU.tv_hybrid {float(tv_c)!r} (float64, CPU), tv_GPU.tv_hybrid "
        f"{tv_g!r} (f32, one B3 + B4 launch), rel {rel:.3g}, G max err / "
        f"mean |G| {err_G:.3g}; card {card}")


# ---------------------------------------------------------------- phase 28
# the small check of the spectral path: f32 on the card against float64 on
# the CPU, and the f32 adjointness and DFT-mode bars (the JAX package's own
# f32 bars for these are 1e-5 and 5e-6)
CT_SPEC_SMALL, CT_SPEC_SMALL_ANGLES = (2, 2, 64, 64), 32
CT_SPEC_TOL = 1e-5


def _scaled(geom, N):
    """``geom`` with its distances scaled from CT_SHAPE's width to N."""
    f = N / CT_SHAPE[-1]
    return geom._replace(source_dist=geom.source_dist * f,
                         det_dist=geom.det_dist * f)


def _spectral_pairs(shape, geoms, precision=None):
    """The spectral pairs' constructors by name: parallel (angles over
    pi), fan, cone order 0 and 1 (angles over 2 pi), each
    ``make(dtype)``."""
    fan, cone = geoms
    return {
        "parallel": lambda dt: make_spectral_projector(
            shape, CT_SPEC_HALF, dtype=dt, precision=precision),
        "fan": lambda dt: make_fan_spectral_projector(
            shape, CT_SPEC_FULL, fan, dtype=dt, precision=precision),
        "cone o0": lambda dt: make_cone_spectral_projector(
            shape, CT_SPEC_FULL, cone, dtype=dt, order=0,
            precision=precision),
        "cone o1": lambda dt: make_cone_spectral_projector(
            shape, CT_SPEC_FULL, cone, dtype=dt, order=1,
            precision=precision)}


CT_SPEC_HALF = np.linspace(0.0, np.pi, CT_SPEC_SMALL_ANGLES, endpoint=False)
CT_SPEC_FULL = np.linspace(0.0, 2 * np.pi, CT_SPEC_SMALL_ANGLES,
                           endpoint=False)


def _rel(a, b):
    return float((a.double() - b.double()).abs().max()
                 / b.double().abs().max())


def _spectral_small():
    """Each spectral pair, ``fbp`` and ``fdk_spectral`` in f32 on the card
    against float64 on the CPU at CT_SPEC_SMALL (max error over the
    reference's scale); the f32 adjointness on the card; 'fft' against
    'matmul'; 'high' bit for bit against 'highest', and 'default''s (TF32)
    difference."""
    shape = CT_SPEC_SMALL
    geoms = (_scaled(FAN, shape[-1]), _scaled(CONE, shape[-1]))
    rng = np.random.default_rng(0)
    vol = rng.random(shape)
    x64 = torch.as_tensor(vol)
    x32 = x64.float().to(DEV)
    errs, adj, modes, tf32 = {}, {}, {}, {}
    refs = {}
    for name, make in _spectral_pairs(shape, geoms).items():
        A64, AT64 = make(torch.float64)
        A32, AT32 = make(torch.float32)
        ref = A64(x64)
        refs[name] = ref
        y64 = torch.as_tensor(rng.random(tuple(ref.shape)))
        y32 = y64.float().to(DEV)
        got, got_T = A32(x32), AT32(y32)
        errs[name] = max(_rel_err(got, ref), _rel_err(got_T, AT64(y64)))
        lhs = float(torch.sum(y32.double() * got.double()))
        rhs = float(torch.sum(got_T.double() * x32.double()))
        adj[name] = abs(lhs - rhs) / abs(lhs)
        out = {}
        try:
            for mode in ("fft", "matmul"):
                ct_spectral._DFT_MODE = mode
                out[mode] = (A32(x32), AT32(y32))
        finally:
            ct_spectral._DFT_MODE = "auto"
        modes[name] = max(_rel(out["matmul"][i], out["fft"][i])
                          for i in range(2))
        by_prec = {}
        for prec in ("high", "highest", "default"):
            A, AT = _spectral_pairs(shape, geoms, prec)[name](torch.float32)
            by_prec[prec] = (A(x32), AT(y32))
        require(all(torch.equal(by_prec["high"][i], by_prec["highest"][i])
                    for i in range(2)),
                f"{name}: precision 'high' equals 'highest' bit for bit")
        tf32[name] = max(_rel(by_prec["default"][i], by_prec["highest"][i])
                         for i in range(2))
    # fbp from the parallel sinogram, fdk_spectral from the cone's
    sino = refs["parallel"]
    errs["fbp"] = _rel_err(
        fbp(sino.float().numpy(), CT_SPEC_HALF, method="spectral"),
        fbp(sino, CT_SPEC_HALF, method="spectral"))
    csino = refs["cone o1"]
    errs["fdk_spectral"] = _rel_err(
        fdk_spectral(csino.float().numpy(), CT_SPEC_FULL, geoms[1], shape),
        fdk_spectral(csino, CT_SPEC_FULL, geoms[1], shape))
    require(all(e <= CT_SPEC_TOL for e in errs.values()),
            f"spectral at {shape}: card f32 vs CPU float64 {errs}")
    require(all(e <= CT_SPEC_TOL for e in adj.values()),
            f"spectral f32 adjointness {adj}")
    require(all(e <= CT_SPEC_TOL for e in modes.values()),
            f"spectral 'fft' vs 'matmul' {modes}")
    return errs, adj, modes, tf32


def _smooth_phantom(shape, seed):
    """Six seeded Gaussian blobs per frame inside the inscribed circle, the
    same in every slice, on the card."""
    rng = np.random.default_rng(seed)
    N = shape[-1]
    c = (N - 1) / 2.0
    r, cc = np.meshgrid(np.arange(N) - c, np.arange(N) - c, indexing="ij")
    vol = np.zeros(shape, np.float32)
    for m in range(shape[1]):
        for _ in range(6):
            r0, c0 = rng.uniform(-0.3 * N, 0.3 * N, 2)
            w = rng.uniform(0.04, 0.1) * N
            vol[:, m] += np.exp(-((r - r0) ** 2 + (cc - c0) ** 2)
                                / (2 * w * w)).astype(np.float32)
    return torch.as_tensor(vol, device=DEV)


def _spectral_geometry(name, geom, angles, sino, n_iter, reg):
    """One geometry at full width: the spectral pair (both DFT modes) and
    the gather pair side by side, the power method, a ``cp_reconstruct``
    (method='spectral') with its launches, rate, idle share and peak memory,
    and two SART epochs of 8 subsets.  Returns its numbers."""
    cfg = TVConfig(**CT_CFG)
    if geom is None:
        S_A, S_AT = make_projector(CT_SHAPE, angles, method="spectral")
        G_A, G_AT = make_projector(CT_SHAPE, angles, method="gather")
    else:
        S_A, S_AT = ct._geometry_pair(geom, CT_SHAPE, angles, torch.float32,
                                      "spectral", None,
                                      tuple(sino.shape[2:]) if isinstance(
                                          geom, ConeBeamGeometry)
                                      else (sino.shape[-1],))
        G_A, G_AT = _geometry(geom)[2](CT_SHAPE, angles, geom)
    gen = torch.Generator(device=DEV).manual_seed(3)
    x = torch.rand(CT_SHAPE, generator=gen, device=DEV)
    ms = {}
    try:
        for mode in ("fft", "matmul"):
            ct_spectral._DFT_MODE = mode
            ms[f"A {mode}"] = _time_launch(lambda: S_A(x), n=5)
            ms[f"A_T {mode}"] = _time_launch(lambda: S_AT(sino), n=5)
    finally:
        ct_spectral._DFT_MODE = "auto"
    ms["A gather"] = _time_launch(lambda: G_A(x), n=3)
    ms["A_T gather"] = _time_launch(lambda: G_AT(sino), n=3)
    del G_A, G_AT
    start = time.perf_counter()
    op_norm = float(estimate_op_norm(S_A, S_AT, CT_SHAPE, device=DEV))
    ms["estimate_op_norm"] = (time.perf_counter() - start) * 1e3
    kw = dict(reg=reg, cfg=cfg, nonneg=True, op_norm=op_norm, geom=geom,
              method="spectral")

    def solve(n=n_iter, **more):
        return cp_reconstruct(sino, angles, CT_SHAPE, n_iter=n, **kw, **more)

    sync()
    torch.cuda.reset_peak_memory_stats(DEV)
    zero_counters()
    res = solve()
    sync()
    launches = read_counters()
    require_launches(launches, f"{name} spectral cp_reconstruct",
                     B5=n_iter, B2=n_iter, B3=n_iter)
    peak = {"cp_reconstruct": torch.cuda.max_memory_allocated(DEV)}
    loss = res.loss
    require(bool(torch.isfinite(loss).all())
            and float(loss[-1]) < float(loss[0])
            and tuple(res.x.shape) == CT_SHAPE
            and bool(torch.isfinite(res.x).all()),
            f"{name} spectral: finite x, losses finite and falling")
    ms["it"] = _best_ms(solve, repeats=2) / n_iter
    dev_ms, _ = device_time(solve, n_iter, DEV)
    out = dict(ms=ms, op_norm=op_norm, launches=launches, peak=peak,
               loss=(float(loss[0]), float(loss[-1])), dev_ms=dev_ms,
               res=res)
    # SART on a smooth phantom's spectral data: its normalizers assume a
    # nonnegative operator, and on a random volume's data, whose highest
    # frequencies meet the spectral splat's ringing, the fan's residual
    # rises from the first epoch (as in the JAX package)
    sino = S_A(_smooth_phantom(CT_SHAPE, seed=4))
    sync()
    torch.cuda.reset_peak_memory_stats(DEV)
    sart_kw = dict(n_iter=2, n_subsets=8, geom=geom, method="spectral")
    rec = sart(sino, angles, CT_SHAPE, **sart_kw)
    sync()
    peak["sart"] = torch.cuda.max_memory_allocated(DEV)
    r = rec.residual
    require(bool(torch.isfinite(rec.x).all()) and float(r[1]) < float(r[0]),
            f"{name} spectral SART: finite, residual falling")
    del rec
    ms["sart"] = _best_ms(lambda: sart(sino, angles, CT_SHAPE, **sart_kw),
                          repeats=1)
    return out


def phase_ct_spectral(card):
    """The spectral CT path: the small checks, then at (16, 4, 512, 512) x
    96 angles each geometry's spectral and gather pairs side by side, the
    'auto' decision, a spectral cp_reconstruct (one B5, B2 and B3 launch per
    iteration), a resumed solve against the uninterrupted one, the cone's
    preconditioner setup, fdk_spectral, SART; then three iterations at
    (96, 16, 512, 512) for the peak memory.  Returns the launches."""
    errs, adj, modes, tf32 = _spectral_small()
    log(f"[28 CT spectral small] {CT_SPEC_SMALL} x {CT_SPEC_SMALL_ANGLES} "
        f"angles (fan and cone at 1/8 of the full-width distances): card "
        f"f32 vs CPU float64, max err / scale "
        + ", ".join(f"{k} {v:.2g}" for k, v in errs.items())
        + f" (<= {CT_SPEC_TOL}); f32 adjointness on the card "
        + ", ".join(f"{k} {v:.2g}" for k, v in adj.items())
        + "; 'matmul' vs 'fft' " + ", ".join(
            f"{k} {v:.2g}" for k, v in modes.items())
        + "; 'high' == 'highest' bit for bit; 'default' (TF32) vs 'highest' "
        + ", ".join(f"{k} {v:.2g}" for k, v in tf32.items()))

    n_iter, reg = 10, 0.5
    angles, sino = _ct_problem(CT_SHAPE, CT_ANGLES, seed=0)
    full = np.linspace(0.0, 2 * np.pi, CT_ANGLES, endpoint=False)
    results, launches = {}, {}
    for name, geom in (("parallel", None), ("fan", FAN), ("cone", CONE)):
        if geom is not None:
            # the data of the spectral pair itself: the rebinned operators
            # differ from the gather ones most on a random volume's highest
            # frequencies, and SART on such mismatched data gains nothing
            gen = torch.Generator(device=DEV).manual_seed(0)
            vol = torch.rand(CT_SHAPE, generator=gen, device=DEV)
            det = ((CT_SHAPE[0], CT_SHAPE[-1]) if name == "cone"
                   else (CT_SHAPE[-1],))
            sino = ct._geometry_pair(geom, CT_SHAPE, full, torch.float32,
                                     "spectral", None, det)[0](vol)
            sino += 0.5 * torch.randn(sino.shape, generator=gen, device=DEV)
            angles = full
            del vol
        r = _spectral_geometry(name, geom, angles, sino, n_iter, reg)
        ms = r["ms"]
        launches[f"{name} spectral"] = r["launches"]
        extra = ""
        if name == "parallel":
            # a resumed solve: 5 + 5 iterations against 10 at once
            whole = r["res"]
            half = cp_reconstruct(sino, angles, CT_SHAPE, n_iter=5, reg=reg,
                                  cfg=TVConfig(**CT_CFG), nonneg=True,
                                  op_norm=r["op_norm"], method="spectral")
            rest = cp_reconstruct(sino, angles, CT_SHAPE, n_iter=5, reg=reg,
                                  cfg=TVConfig(**CT_CFG), nonneg=True,
                                  op_norm=r["op_norm"], method="spectral",
                                  state=half.state)
            same = torch.equal(rest.x, whole.x) and torch.equal(
                torch.cat([half.loss, rest.loss]), whole.loss)
            diff = float((rest.x - whole.x).abs().max())
            require(diff <= 1e-5 * float(whole.x.abs().max()),
                    f"resumed spectral solve differs by {diff:.3g}")
            extra = (f"resumed 5 + 5 vs 10 iterations: "
                     f"{'bit-equal' if same else f'max abs diff {diff:.3g}'}"
                     f"; ")
            del half, rest, whole
        if name == "cone":
            ct._CONE_PRECOND_CACHE.clear()
            A, A_T = ct._geometry_pair(CONE, CT_SHAPE, angles, torch.float32,
                                       "spectral", None,
                                       tuple(sino.shape[2:]))
            sync()
            start = time.perf_counter()
            _, scale = ct._spectral_cone_precond_setup(
                A, A_T, tuple(sino.shape), CT_SHAPE, angles, CONE,
                TVConfig(**CT_CFG), torch.float32, None, DEV)
            sync()
            ms["precond setup"] = (time.perf_counter() - start) * 1e3
            sync()
            torch.cuda.reset_peak_memory_stats(DEV)
            rec = fdk_spectral(sino, angles, CONE, CT_SHAPE)
            sync()
            r["peak"]["fdk_spectral"] = torch.cuda.max_memory_allocated(DEV)
            require(tuple(rec.shape) == CT_SHAPE
                    and bool(torch.isfinite(rec).all()),
                    "fdk_spectral is finite")
            del rec
            ms["fdk_spectral"] = _best_ms(
                lambda: fdk_spectral(sino, angles, CONE, CT_SHAPE))
            extra = (f"preconditioner setup {ms['precond setup'] / 1e3:.2f} "
                     f"s (scale {scale:.4f}), fdk_spectral "
                     f"{ms['fdk_spectral']:.2f} ms, ")
        mode = ct_spectral._dft_mode(DEV)
        spec = ms[f"A {mode}"] + ms[f"A_T {mode}"]
        gath = ms["A gather"] + ms["A_T gather"]
        faster = "spectral" if spec < gath else "gather"
        results[name] = (faster, spec, gath, ms)
        log(f"[28 CT {name} spectral full width] {CT_SHAPE} f32 x "
            f"{CT_ANGLES} angles"
            + (f", {type(geom).__name__}{tuple(geom)}" if geom else "")
            + "; ms (CUDA events): spectral A fft "
            f"{ms['A fft']:.3f} / matmul {ms['A matmul']:.3f}, A_T fft "
            f"{ms['A_T fft']:.3f} / matmul {ms['A_T matmul']:.3f}; gather A "
            f"{ms['A gather']:.3f}, A_T {ms['A_T gather']:.3f}; 'auto' on "
            f"CUDA: {faster} ({spec:.3f} vs {gath:.3f} ms a pair, DFT mode "
            f"{mode}); estimate_op_norm {ms['estimate_op_norm']:.0f} ms "
            f"(host clock) = {r['op_norm']:.2f}; cp_reconstruct(method="
            f"'spectral', hybrid reg_time=0.5, reg {reg}, nonneg, {n_iter} "
            f"iterations): launches {r['launches']}, loss {r['loss'][0]:.6g} "
            f"-> {r['loss'][1]:.6g}, {1e3 / ms['it']:.3f} it/s "
            f"({ms['it']:.3f} ms/it, best of 2 whole calls), device "
            f"{r['dev_ms']:.3f} ms/it (torch.profiler), idle "
            f"{100 * (1 - r['dev_ms'] / ms['it']):.1f}%; {extra}"
            f"sart(2 epochs, 8 subsets) {ms['sart']:.1f} ms; peak memory "
            + ", ".join(f"{k} {v / 1e9:.2f} GB" for k, v in r["peak"].items())
            + f"; card {card}")
        del r, sino
        torch.cuda.empty_cache()
    for name, (faster, spec, gath, _) in results.items():
        require(faster == ct._AUTO_ON_CUDA[name],
                f"'auto' for the {name} beam is "
                f"{ct._AUTO_ON_CUDA[name]!r}, but the {faster} pair is "
                f"faster ({spec:.3f} vs {gath:.3f} ms)")
    pair_ms = {m: sum(r[3][f"A {m}"] + r[3][f"A_T {m}"]
                      for r in results.values()) for m in ("fft", "matmul")}
    log(f"[28 CT spectral DFT mode] A + A_T summed over the three "
        f"geometries: 'fft' {pair_ms['fft']:.3f} ms, 'matmul' "
        f"{pair_ms['matmul']:.3f} ms; faster "
        f"{min(pair_ms, key=pair_ms.get)!r}, 'auto' on CUDA takes "
        f"{ct_spectral._DFT_MODE_ON_CUDA!r}; card {card}")
    sync()

    # capacity: (96, 16, 512, 512) x 96 angles with a bf16 dual; every
    # slice has the parallel geometry above, so its norm is the same
    torch.cuda.empty_cache()
    angles, sino = _ct_problem(NORTH_STAR, CT_ANGLES, seed=1)
    A, A_T = make_projector(CT_SHAPE, angles, method="spectral")
    op_norm = float(estimate_op_norm(A, A_T, CT_SHAPE, device=DEV))
    kw = dict(reg=0.5, cfg=TVConfig(**CT_CFG), nonneg=True, op_norm=op_norm,
              dual_dtype="bfloat16", method="spectral")
    cp_reconstruct(sino, angles, NORTH_STAR, n_iter=1, **kw)  # warm-up
    sync()
    torch.cuda.reset_peak_memory_stats(DEV)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    zero_counters()
    start.record()
    res = cp_reconstruct(sino, angles, NORTH_STAR, n_iter=3, **kw)
    end.record()
    sync()
    require_launches(read_counters(), "spectral capacity cp_reconstruct",
                     B5=3, B2=3, B3=3)
    require(bool(torch.isfinite(res.loss).all())
            and float(res.loss[-1]) < float(res.loss[0]),
            "spectral capacity losses finite and falling")
    peak = torch.cuda.max_memory_allocated(DEV)
    log(f"[28 CT spectral capacity] cp_reconstruct({NORTH_STAR} f32 x "
        f"{CT_ANGLES} angles, method='spectral', bf16 dual, 3 iterations): "
        f"{start.elapsed_time(end) / 3:.1f} ms per iteration (whole call), "
        f"peak memory {peak / 1e9:.2f} GB of "
        f"{torch.cuda.get_device_properties(DEV).total_memory / 1e9:.1f}, "
        f"final loss {float(res.loss[-1]):.6g}; card {card}")
    del res, sino
    torch.cuda.empty_cache()
    sync()
    return launches


# ---------------------------------------------------------------- phase 29
SHARDED_2D_MESH = (4, 2)    # the 2d TGV solve's (z, t) mesh: 8 B7 launches
SHARDED_4D_MESH = (4, 1)    # the coupled 4d solve: z only
# a sharded CT solve's x against the unsharded plain solve, of the scale:
# CT_GEOM_TOL's room over f32 round-off (its op_norm is summed over shards
# in another order, which moves every step in the last bits)
CT_SHARD_TOL = 1e-4


def _wall_ms(fn, repeats=2):
    """Fastest of ``repeats`` host-clock times of ``fn()`` and a
    synchronise, after one warm-up, ms."""
    fn()
    sync()
    best = float("inf")
    for _ in range(repeats):
        start = time.perf_counter()
        fn()
        sync()
        best = min(best, (time.perf_counter() - start) * 1e3)
    return best


def _wall_and_device(run, n_it):
    """``(wall, device, B6's kernels)`` ms per iteration of ``run()``, which
    enqueues ``n_it`` iterations: the device's time is every kernel, copy and
    memset torch.profiler records."""
    dev_ms, by_kernel = device_time(run, n_it, DEV)
    b6 = sum(v for k, v in by_kernel.items()
             if "tgv_pq" in k or "tgv_xw" in k)
    return _wall_ms(run) / n_it, dev_ms, b6


def _sharded_tgv_2d(card):
    """The 2d TGV solve as 8 shards: one B7 launch each, no B6."""
    base = np.random.default_rng(0).random(MAIN_4D).astype(np.float32)
    n_it, kw = 100, dict(alpha1=1.0, alpha0=2.0)
    mesh = make_mesh(*SHARDED_2D_MESH)
    xs = shard_volume(base, mesh)
    sync()
    zero_counters()
    res = tgv_denoise_sharded(xs, mesh, n_iter=n_it, **kw)
    sync()
    launches = read_counters()
    require_launches(launches, "tgv_denoise_sharded 2d", B7=8)
    x = torch.as_tensor(base, device=DEV)
    ref = tgv_denoise(x, n_iter=n_it, **kw)
    require(torch.equal(gather_volume(res.x), ref.x)
            and torch.equal(gather_d_volume(res.w), ref.w),
            "sharded 2d TGV: x and w bit-equal to the unsharded solve")
    rel = float(((res.loss - ref.loss).abs() / ref.loss.abs()).max())
    require(rel <= 1e-6, f"sharded 2d TGV loss within 1e-6, got {rel:.3g}")
    ms = {"sharded": _best_ms(lambda: tgv_denoise_sharded(
              xs, mesh, n_iter=n_it, **kw), 2) / n_it,
          "unsharded": _best_ms(lambda: tgv_denoise(x, n_iter=n_it, **kw),
                                2) / n_it}
    log(f"[29 sharded TGV 2d] {MAIN_4D} f32 on a {SHARDED_2D_MESH} mesh, "
        f"{n_it} its with the loss ({card}): launches {launches}; x, w "
        f"bit-equal to the unsharded solve, loss max rel diff {rel:.3g}; "
        f"ms/it sharded {ms['sharded']:.4f}, unsharded "
        f"{ms['unsharded']:.4f}")
    return launches["B7"], ms


def _sharded_tgv_coupled(card):
    """The 4d TGV solve on 4 z-shards, ghost and overlapped paths, f32 and
    bf16, and the 3d solve on a (4, 2) mesh, against the unsharded stream
    solve."""
    base = np.random.default_rng(0).random(MAIN_4D).astype(np.float32)
    x = torch.as_tensor(base, device=DEV)
    n_it, kw = 20, dict(alpha1=1.0, alpha0=2.0)
    mesh = make_mesh(*SHARDED_4D_MESH)
    n_sh = SHARDED_4D_MESH[0]
    out, launches, ms = {}, {}, {}
    for dt in ("float32", "bfloat16"):
        for overlap in (False, True):
            solve = make_sharded_tgv_stream_solver(
                mesh, MAIN_4D, "4d", n_iter=n_it, dtype=dt, overlap=overlap,
                **kw)
            x0 = shard_volume(base, mesh)
            sync()
            zero_counters()
            res = solve(x0)
            sync()
            got = read_counters()
            per = (3 if overlap else 1) * n_sh * n_it
            require_launches(got, f"sharded 4d TGV {dt} overlap={overlap}",
                             B6pq=per, B6xw=per)
            launches["overlap" if overlap else "ghost"] = got["B6pq"]
            out[dt, overlap] = (gather_volume(res.x), gather_d_volume(res.w))
            del res
            if dt == "float32":
                ms["overlap" if overlap else "ghost"] = _wall_and_device(
                    lambda: solve(x0), n_it)
    require(all(_bits_equal(a, b) for a, b in zip(
        out["bfloat16", True], out["bfloat16", False])),
        "bf16 sharded 4d TGV: the overlapped path bit-equal to the ghost "
        "path")
    f32_same = all(torch.equal(a, b) for a, b in zip(
        out["float32", True], out["float32", False]))
    ref = tgv_denoise(x, n_iter=n_it, axes="4d", compute_loss=False, **kw)
    err = max(_compare(out["float32", False][0], ref.x, False, 0.0,
                       F32_TOL_20),
              _compare(out["float32", False][1], ref.w, False, 0.0,
                       F32_TOL_20))
    del out

    ms["unsharded"] = _wall_and_device(lambda: tgv_denoise(
        x, n_iter=n_it, axes="4d", compute_loss=False, **kw), n_it)
    log(f"[29 sharded TGV 4d] {MAIN_4D} on {n_sh} z-shards, {n_it} its "
        f"({card}): B6 PQ / XW launches ghost {launches['ghost']}, overlap "
        f"{launches['overlap']} each; bf16 overlap == ghost bit for bit; "
        f"f32 overlap {'==' if f32_same else '!='} ghost; f32 vs the "
        f"unsharded stream solve max abs err {err:.3g} (atol "
        f"{F32_TOL_20['atol']}, rtol {F32_TOL_20['rtol']}); ms/it wall / "
        f"device (of it B6's kernels): " + ", ".join(
            f"{k} {w:.4f} / {d:.4f} ({b6:.4f})"
            for k, (w, d, b6) in ms.items()))

    mesh3 = make_mesh(*SHARDED_2D_MESH)
    solve = make_sharded_tgv_stream_solver(mesh3, MAIN_4D, "3d",
                                           n_iter=n_it, **kw)
    sync()
    zero_counters()
    res = solve(shard_volume(base, mesh3))
    sync()
    got = read_counters()
    per = SHARDED_2D_MESH[0] * SHARDED_2D_MESH[1] * n_it
    require_launches(got, "sharded 3d TGV", B6pq=per, B6xw=per)
    launches["3d"] = got["B6pq"]
    ref = tgv_denoise(x, n_iter=n_it, axes="3d", compute_loss=False, **kw)
    err3 = max(_compare(gather_volume(res.x), ref.x, False, 0.0, F32_TOL_20),
               _compare(gather_d_volume(res.w), ref.w, False, 0.0,
                        F32_TOL_20))
    log(f"[29 sharded TGV 3d] {MAIN_4D} on a {SHARDED_2D_MESH} mesh: "
        f"launches {got}; vs the unsharded stream solve max abs err "
        f"{err3:.3g}")
    return launches, ms


def _multihost(card):
    """One NCCL rank: initialize, then the sharded fused CP on
    global_mesh(z=4) bit for bit against the one-process solve."""
    import socket

    import torch.distributed as dist

    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    start = time.perf_counter()
    multihost.initialize(f"127.0.0.1:{port}", num_processes=1, process_id=0)
    init_s = time.perf_counter() - start
    try:
        require(dist.is_initialized() and dist.get_backend() == "nccl"
                and dist.get_world_size() == 1, "one NCCL rank")
        probe = torch.full((1,), 3.0, device=DEV)
        dist.all_reduce(probe)
        require(float(probe) == 3.0, "an all_reduce over the NCCL group")
        mesh = multihost.global_mesh(z=SHARDED_MESH[0])
        require(mesh.device.type == "cuda" and mesh.process_count == 1,
                f"the global mesh on the card, got {mesh}")
        cfg = TVConfig(scheme="hybrid", reg_time=0.5)
        base = np.random.default_rng(0).random(MAIN_4D).astype(np.float32)
        st = init_state(torch.as_tensor(base, device=DEV), cfg)

        def place(a):
            return multihost.host_local_to_global(mesh, a)

        solve = make_sharded_cp_solver_fused(mesh, cfg, MAIN_4D, reg=1.0,
                                             n_iter=20, shard_time=False)
        sync()
        zero_counters()
        x, y_A, y_D, losses = solve(place(base), place(st.x),
                                    place(st.y_A),
                                    place(fused.to_internal_layout(st.y_D)))
        sync()
        got = read_counters()
        n = 20 * SHARDED_MESH[0]
        mode = "int" if solve.overlap else "halo"
        require(got["B1"] == got["B1" + mode] == n
                and got["B2"] == got["B2" + mode] == n,
                f"multihost CP: B1 = B2 = {n}, each in its {mode} mode, got "
                f"{got}")
        ref = _sharded_cp(base, cfg, SHARDED_MESH, 20, 1.0)
        same = all(torch.equal(multihost.global_to_host_local(mesh, g), r)
                   for g, r in zip((x, y_A, y_D), ref[:3]))
        require(same and torch.equal(losses, ref[3]),
                "the NCCL-rank sharded CP bit-equal to the one-process one")
    finally:
        dist.destroy_process_group()
    log(f"[29 multihost] one NCCL rank ({card}): init {init_s:.2f} s, "
        f"global_mesh {mesh}; 20 fused CP its on {MAIN_4D}: launches {got}; "
        f"x, y_A, y_D and the losses bit-equal to the one-process sharded "
        f"solve (overlap={solve.overlap})")
    return got


def _sharded_ct_case(name, sino, angles, mesh, sharding, geom, card):
    """A 10-iteration cp_reconstruct of a sinogram grid (no kernel: the
    projector per shard, the plain halo TV) against the unsharded plain and
    fused solves."""
    cfg = TVConfig(**CT_CFG)
    n_iter = 10
    kw = dict(n_iter=n_iter, reg=0.5, cfg=cfg, nonneg=True, geom=geom)
    grid = shard(sino, sharding)
    sync()
    torch.cuda.reset_peak_memory_stats(DEV)
    base = torch.cuda.memory_allocated(DEV)
    zero_counters()
    # the plain halo TV (PR 13's path; phase 32 runs the fused one)
    res = cp_reconstruct(grid, angles, CT_SHAPE, fused=False, **kw)
    sync()
    require_launches(read_counters(), f"sharded {name} CT")
    peak = torch.cuda.max_memory_allocated(DEV) - base
    plain = cp_reconstruct(sino, angles, CT_SHAPE, fused=False, **kw)
    fast = cp_reconstruct(sino, angles, CT_SHAPE, **kw)
    x = gather_volume(res.x)
    rel = float(((res.loss - plain.loss).abs() / plain.loss.abs()).max())
    require(rel <= 1e-5, f"sharded {name} CT losses within 1e-5 of the "
                         f"unsharded solve, got {rel:.3g}")
    scale = float(plain.x.abs().max())
    err_x = float((x - plain.x).abs().max()) / scale
    require(err_x <= CT_SHARD_TOL, f"sharded {name} CT x within "
                                   f"{CT_SHARD_TOL} of the scale, got "
                                   f"{err_x:.3g}")
    rel_fast = float(((res.loss - fast.loss).abs() / fast.loss.abs()).max())
    require(bool(torch.isfinite(x).all()) and float(res.loss[-1])
            < float(res.loss[0]), f"sharded {name} CT: finite, falling")
    op_norm = float(estimate_op_norm(*ct._select_projector(
        sino, angles, CT_SHAPE, None, geom), CT_SHAPE, device=DEV))
    # the projector's share of a sharded iteration: one A and one A_T on
    # every shard, as the loop applies them
    cells = [(b, v) for row_b, row_v in zip(grid, res.x)
             for b, v in zip(row_b, row_v)]
    A, A_T = ct._select_projector(cells[0][0], angles, tuple(
        cells[0][1].shape), None, geom)
    pair_ms = _best_ms(lambda: [(A(v), A_T(b)) for b, v in cells], 2)
    del plain, fast, res
    kw["op_norm"] = op_norm
    sync()
    torch.cuda.reset_peak_memory_stats(DEV)
    base = torch.cuda.memory_allocated(DEV)
    ms_un = _best_ms(lambda: cp_reconstruct(sino, angles, CT_SHAPE, **kw),
                     2) / n_iter
    peak_un = torch.cuda.max_memory_allocated(DEV) - base
    ms_sh = _best_ms(lambda: cp_reconstruct(grid, angles, CT_SHAPE,
                                            fused=False, **kw), 2) / n_iter
    log(f"[29 sharded CT {name}] {CT_SHAPE} x {CT_ANGLES} angles on a "
        f"{tuple(mesh.shape.values())} mesh, method='auto' "
        f"({ct._resolve_method('auto', ct._geometry_name(geom), DEV)}), "
        f"{n_iter} its ({card}): launches none; losses vs the unsharded plain "
        f"solve max rel {rel:.3g}, vs the fused one {rel_fast:.3g}; x vs "
        f"plain {err_x:.3g} of the scale; it/s sharded {1e3 / ms_sh:.2f} "
        f"({ms_sh:.3f} ms/it, of it the projector pair on every shard "
        f"{pair_ms:.3f}), unsharded fused {1e3 / ms_un:.2f} "
        f"({ms_un:.3f}); peak memory above the sinogram and what was "
        f"allocated before: sharded {peak / 1e9:.2f} GB, unsharded "
        f"{peak_un / 1e9:.2f} GB")
    return ms_sh, ms_un


def phase_sharded_slice(card):
    """Phase 29: the sharded TGV solvers, one NCCL rank of the multihost
    path and the sharded CT solve, at full width from numpy or seeded
    inputs.  Returns B6's and B7's launches on the sharded paths."""
    b7, ms2d = _sharded_tgv_2d(card)
    b6, ms4d = _sharded_tgv_coupled(card)
    _multihost(card)
    angles, sino = _ct_problem(CT_SHAPE, CT_ANGLES, seed=0)
    mesh = make_mesh(4, 2)
    _sharded_ct_case("parallel", sino, angles, mesh,
                     sinogram_sharding(mesh), None, card)
    del sino
    gen = torch.Generator(device=DEV).manual_seed(0)
    vol = torch.rand(CT_SHAPE, generator=gen, device=DEV)
    full = np.linspace(0.0, 2 * np.pi, CT_ANGLES, endpoint=False)
    sino = radon_cone(vol, full, CONE)
    sino += 0.5 * torch.randn(sino.shape, generator=gen, device=DEV)
    del vol
    mesh = make_mesh(1, 4)
    _sharded_ct_case("cone", sino, full, mesh, cone_sinogram_sharding(mesh),
                     CONE, card)
    del sino
    torch.cuda.empty_cache()
    sync()
    return {"B7": b7, "B6": b6, "ms_2d": ms2d, "ms_4d": ms4d}


# ---------------------------------------------------------------- phase 30
# the z-DFT tier's small checks: f32 on the card against float64 on the CPU
# and the f32 dot test, at the JAX package's adjointness shape
ZDFT_SMALL, ZDFT_SMALL_ANGLES = (4, 2, 24, 24), 5
ZDFT_TOL = 1e-5
# the certification: the JAX test's shape and blobs (tests/test_ct_spectral.py
# test_cone_zdft_beats_gather_vs_analytic), against exact cone integrals
ZDFT_CERT_SHAPE, ZDFT_CERT_ANGLES = (16, 1, 64, 64), 16
ZDFT_BLOBS = [(5.5, 0.45, 0.55, 2.0, 1.0), (9.5, 0.60, 0.40, 2.2, 0.7),
              (7.5, 0.40, 0.42, 1.8, 0.5)]
# the example twins and the line each prints last
EXAMPLES = ("torch_a_getting_started", "torch_b_schemes_math",
            "torch_c_4d_sharded", "torch_d_ct_reconstruction", "torch_e_tgv",
            "torch_f_inverse_problems")


def _zdft_oracle(ang, geom, Nz, N):
    """Exact cone integrals of ZDFT_BLOBS (isotropic 3D Gaussians) at
    every detector cell, ``(1, A, Nz, N)``, float64."""
    cz, c0 = (Nz - 1) / 2.0, (N - 1) / 2.0
    u_ax = (np.arange(N) - (N - 1) / 2.0) * geom.spacing_u()
    v_ax = (np.arange(Nz) - (Nz - 1) / 2.0) * geom.spacing_v()
    orc = np.zeros((1, len(ang), Nz, N))
    for a, b in enumerate(ang):
        sinb, cosb = np.sin(b), np.cos(b)
        Sr, Sc, Sz = (c0 - geom.source_dist * sinb,
                      c0 - geom.source_dist * cosb, cz)
        Dr = c0 + geom.det_dist * sinb + u_ax[None, :] * cosb
        Dc = c0 + geom.det_dist * cosb - u_ax[None, :] * sinb
        Dz = cz + v_ax[:, None] + 0 * Dr
        dr, dc, dz = Dr - Sr, Dc - Sc, Dz - Sz
        inv = 1.0 / np.sqrt(dr ** 2 + dc ** 2 + dz ** 2)
        dr, dc, dz = dr * inv, dc * inv, dz * inv
        for (z0, rr, cc, s, amp) in ZDFT_BLOBS:
            wr, wc, wz = Sr - rr * N, Sc - cc * N, Sz - z0
            proj = wr * dr + wc * dc + wz * dz
            rho2 = (wr ** 2 + wc ** 2 + wz ** 2) - proj ** 2
            orc[0, a] += amp * np.sqrt(np.pi) * s * np.exp(-rho2 / s ** 2)
    return orc


def _cuda_device_ms(run):
    """Device ms of ``run()``: every kernel, copy and memset that
    ``torch.profiler`` records with CUDA activity alone (the tier issues
    tens of thousands of small ops an application; recording the host's
    ops too costs minutes)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
        sync()
    ms = sum(e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA) / 1e3
    require(ms > 0.0, "torch.profiler recorded the z-DFT iteration's kernels")
    return ms


def _zdft_certification():
    """Order 2 ('trig') and the gather cone against the exact integrals on
    the card in f32, at D_so = 2N and 4N: relative errors in norm."""
    Nz, _, N, _ = ZDFT_CERT_SHAPE
    z, r, c = np.mgrid[:Nz, :N, :N].astype(float)
    vol = np.zeros(ZDFT_CERT_SHAPE)
    for (z0, rr, cc, s, amp) in ZDFT_BLOBS:
        vol[:, 0] += amp * np.exp(-(((z - z0) ** 2 + (r - rr * N) ** 2
                                     + (c - cc * N) ** 2) / s ** 2))
    x = torch.as_tensor(vol, dtype=torch.float32, device=DEV)
    ang = np.linspace(0, 2 * np.pi, ZDFT_CERT_ANGLES, endpoint=False) + 0.03
    errs = {}
    for mult in (2.0, 4.0):
        geom = ConeBeamGeometry(source_dist=mult * N, det_dist=0.5 * N)
        orc = _zdft_oracle(ang, geom, Nz, N)

        def rel(a):
            a = a.double().cpu().numpy()
            return float(np.linalg.norm(a - orc) / np.linalg.norm(orc))

        e = {"gather": rel(radon_cone(x, ang, geom)),
             "order 2": rel(radon_cone_spectral(x, ang, geom, order=2,
                                                z_kernel="trig")),
             "order 2 oversample 8": rel(radon_cone_spectral(
                 x, ang, geom, order=2, z_kernel="trig", oversample=8.0))}
        require(e["order 2"] < e["gather"]
                and e["order 2 oversample 8"] < 0.004
                and e["order 2 oversample 8"] < 0.15 * e["gather"],
                f"z-DFT certification at D_so = {mult}N: {e}")
        errs[mult] = e
    return errs


def _zdft_grad_check():
    """The gradient of cp_inverse's reconstruction error in reg on the card
    (f32, tests/test_solvers.py's setup): autograd against a central
    difference, and the plain step (no B5 launch)."""
    rng = np.random.default_rng(41)
    shape = (1, 1, 12, 12)
    truth = np.zeros(shape)
    truth[0, 0, 3:9, 3:9] = 1.0
    b = torch.as_tensor(truth + 0.1 * rng.standard_normal(shape),
                        dtype=torch.float32, device=DEV)
    t = torch.as_tensor(truth, dtype=torch.float32, device=DEV)

    def err(reg):
        res = cp_inverse(lambda v: v, b, shape, A_T=lambda v: v, n_iter=40,
                         reg=reg, op_norm=1.0)
        return torch.sum(torch.square(res.x - t))

    reg = torch.tensor(0.15, device=DEV, requires_grad=True)
    zero_counters()
    (g,) = torch.autograd.grad(err(reg), reg)
    sync()
    got = read_counters()
    h = 1e-3
    fd = (float(err(0.15 + h)) - float(err(0.15 - h))) / (2 * h)
    require(got["B5"] == 0 and got["B2"] == 0,
            f"a reg that requires grad takes the plain step: {got}")
    require(abs(float(g) - fd) <= 0.01 * abs(fd),
            f"d/d reg on the card {float(g)} vs central difference {fd}")
    return float(g), fd


def _ct_grad_check():
    """The gradients of ``cp_reconstruct`` in ``reg`` and
    ``tgv_reconstruct`` in ``alpha1`` through the gather pairs on the card
    (f32): the C4 setup of ROADMAP.md (the sinogram of a seeded (1, 1, 12,
    12) volume at 5 angles, 5 iterations at 0.05), autograd against a
    central difference.  The backward of a gather pair's transpose is its
    forward projector, so the sampler's transpose is never differentiated
    (it has no derivative on a CUDA device)."""
    vol = torch.as_tensor(np.random.default_rng(0).random((1, 1, 12, 12)),
                          dtype=torch.float32, device=DEV)
    angles = np.linspace(0.0, np.pi, 6)[:-1]
    sino = radon(vol, angles)
    out = {}
    for name, fn, arg in (("cp_reconstruct", cp_reconstruct, "reg"),
                          ("tgv_reconstruct", tgv_reconstruct, "alpha1")):
        def f(v):
            res = fn(sino, angles, vol.shape, n_iter=5, method="gather",
                     **{arg: v})
            return torch.sum(res.x)

        value = torch.tensor(0.05, device=DEV, requires_grad=True)
        (g,) = torch.autograd.grad(f(value), value)
        h = 1e-3
        fd = (float(f(0.05 + h)) - float(f(0.05 - h))) / (2 * h)
        require(bool(torch.isfinite(g)) and abs(float(g) - fd)
                <= 0.01 * abs(fd),
                f"d/d {arg} of {name} (gather) on the card {float(g)} vs "
                f"central difference {fd}")
        out[name] = (float(g), fd)
    return out


def _run_examples():
    """The six example twins, each in its own process with --device cuda,
    all at once: each must exit 0 and end with its OK line.  Seconds each,
    to its own exit."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    procs, secs, failed = {}, {}, {}
    start = time.perf_counter()
    try:
        for name in EXAMPLES:
            out = tempfile.TemporaryFile()
            procs[name] = (subprocess.Popen(
                [sys.executable,
                 os.path.join(ROOT, "examples", f"{name}.py"), "--device",
                 "cuda"], stdout=out, stderr=subprocess.STDOUT, env=env,
                cwd=ROOT, stdin=subprocess.DEVNULL), out)
        while len(secs) < len(procs):
            require(time.perf_counter() - start < 600,
                    f"example twins within 600 s: done {sorted(secs)}")
            for name, (proc, _) in procs.items():
                if name not in secs and proc.poll() is not None:
                    secs[name] = time.perf_counter() - start
            time.sleep(0.1)
        for name, (proc, out) in procs.items():
            out.seek(0)
            text = out.read().decode(errors="replace")
            lines = text.strip().splitlines()
            if proc.returncode != 0 or not lines or lines[-1] != "OK":
                failed[name] = (proc.returncode, text[-3000:])
    finally:
        for proc, out in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            out.close()
    require(not failed, f"example twins on the card: {failed}")
    return secs


def phase_ct_zdft(card):
    """Phase 30: the z-DFT offset-line cone tier (order=2) on the card.
    Times its A and A_T at (16, 4, 512, 512) x 96 angles beside order 1,
    the f32 dot test there; at ZDFT_SMALL the card's f32 against the CPU's
    float64 and the dot test; the certification against exact Gaussian
    integrals; cp_inverse on the order-2 pair (one B5 and B2 launch per
    iteration, one B3 per loss); the gradient in reg on the plain step; the
    example twins.  Returns the solve's launches."""
    secs = {}
    t0 = time.perf_counter()
    # small: card f32 against CPU float64, dot test
    rng = np.random.default_rng(5)
    geom_s = _scaled(CONE, ZDFT_SMALL[-1])
    ang_s = np.linspace(0, 2 * np.pi, ZDFT_SMALL_ANGLES, endpoint=False) \
        + 0.05
    A64, AT64 = make_cone_spectral_projector(
        ZDFT_SMALL, ang_s, geom_s, dtype=torch.float64, order=2)
    A32, AT32 = make_cone_spectral_projector(
        ZDFT_SMALL, ang_s, geom_s, dtype=torch.float32, order=2)
    x64 = torch.as_tensor(rng.random(ZDFT_SMALL))
    ref = A64(x64)
    y64 = torch.as_tensor(rng.random(tuple(ref.shape)))
    x32, y32 = x64.float().to(DEV), y64.float().to(DEV)
    got, got_T = A32(x32), AT32(y32)
    small_err = max(_rel_err(got, ref), _rel_err(got_T, AT64(y64)))
    lhs = float(torch.sum(y32.double() * got.double()))
    small_dot = abs(lhs - float(torch.sum(got_T.double() * x32.double()))) \
        / abs(lhs)
    require(small_err <= ZDFT_TOL and small_dot <= ZDFT_TOL,
            f"z-DFT at {ZDFT_SMALL}: card f32 vs CPU float64 {small_err:.3g}, "
            f"dot test {small_dot:.3g}")
    # does a complex64 bmm honour the TF32 flag?  (The tier's stages run
    # planar real bmms, whose precision the flag sets; this says whether a
    # complex one would have.)
    a = torch.randn((8, 256, 256), dtype=torch.complex64, device=DEV)
    by = {}
    for prec in ("default", "highest"):
        with ct_spectral._matmul_precision(prec, DEV):
            by[prec] = torch.view_as_real(torch.bmm(a, a))
    complex_tf32 = _rel(by["default"], by["highest"])
    del a, by
    secs["small"] = time.perf_counter() - t0

    # full width: A and A_T of order 2 and order 1, one timed call each
    t0 = time.perf_counter()
    angles = np.linspace(0.0, 2 * np.pi, CT_ANGLES, endpoint=False)
    gen = torch.Generator(device=DEV).manual_seed(0)
    vol = torch.rand(CT_SHAPE, generator=gen, device=DEV)
    ms, peak = {}, {}
    for order in (1, 2):
        A, A_T = make_cone_spectral_projector(
            CT_SHAPE, angles, CONE, order=order, precision="high")
        y = A(vol)                          # the warm-ups, and A_T's input
        A_T(y)
        torch.cuda.empty_cache()
        for name, fn in (("A", lambda: A(vol)), ("A_T", lambda: A_T(y))):
            sync()
            torch.cuda.reset_peak_memory_stats(DEV)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn()
            end.record()
            sync()
            ms[name, order] = start.elapsed_time(end)
            peak[name, order] = torch.cuda.max_memory_allocated(DEV)
            if order == 2:
                if name == "A":
                    Ax = out
                else:
                    ATy = out
        del out
    lhs = float(torch.sum(y.double() * Ax.double()))
    full_dot = abs(lhs - float(torch.sum(ATy.double() * vol.double()))) \
        / abs(lhs)
    require(bool(torch.isfinite(Ax).all()) and bool(torch.isfinite(ATy).all())
            and tuple(Ax.shape) == (CT_SHAPE[1], CT_ANGLES, CT_SHAPE[0],
                                    CT_SHAPE[-1]),
            "order 2 at full width: finite, the cone layout")
    del Ax, ATy, y
    torch.cuda.empty_cache()
    secs["operators"] = time.perf_counter() - t0
    zd = ct_spectral._zdft_consts(CONE, angles, CT_SHAPE[0], CT_SHAPE[0],
                                  CT_SHAPE[-1], CT_SHAPE[-1], 2.0, "hat",
                                  torch.float32, DEV)
    nodes = [len(s["nodes"]) for s in zd["slabs"]]
    # one node of the widest slab, one regime's angles in one chunk: the
    # tables' build against the two stage products
    g = zd["grid"]
    ang_v = g.thetas[ct_spectral._regime_split(g.thetas)[0]]
    N = CT_SHAPE[-1]
    Fk = torch.rand((2 * N + 1, 2 * CT_SHAPE[1], N), device=DEV)
    delta = zd["slabs"][-1]["nodes"][0]

    def tables():
        return ct_spectral._modulated_tables(ang_v, True, N, g.n_s, g.ds,
                                             delta, torch.float32, DEV)

    split = {"tables": _best_ms(tables, repeats=2)}
    tabs = tables()
    split["stages"] = _best_ms(lambda: ct_spectral._modulated_apply(Fk, tabs),
                               repeats=2)
    del Fk, tabs
    torch.cuda.empty_cache()
    log(f"[30 CT z-DFT operators] order=2 ('hat', precision 'high') at "
        f"{CT_SHAPE} f32 x {CT_ANGLES} angles over 2 pi, "
        f"{type(CONE).__name__}{tuple(CONE)}: {len(nodes)} slabs, "
        f"{sum(nodes)} offset nodes {nodes}; ms (CUDA events, one call after "
        f"a warm-up): A {ms['A', 2]:.1f} (order 1 {ms['A', 1]:.3f}, "
        f"{ms['A', 2] / ms['A', 1]:.1f}x), A_T {ms['A_T', 2]:.1f} (order 1 "
        f"{ms['A_T', 1]:.3f}, {ms['A_T', 2] / ms['A_T', 1]:.1f}x); peak "
        f"memory A {peak['A', 2] / 1e9:.2f} GB (order 1 "
        f"{peak['A', 1] / 1e9:.2f}), A_T {peak['A_T', 2] / 1e9:.2f} GB "
        f"(order 1 {peak['A_T', 1] / 1e9:.2f}); one node, {len(ang_v)} "
        f"angles of one regime in one chunk: tables {split['tables']:.2f} ms, "
        f"the two stage products {split['stages']:.2f} ms; f32 dot test "
        f"{full_dot:.3g}; "
        f"at {ZDFT_SMALL} x {ZDFT_SMALL_ANGLES}: card f32 vs CPU float64 "
        f"{small_err:.3g}, dot test {small_dot:.3g} (<= {ZDFT_TOL}); a "
        f"complex64 bmm under TF32 vs IEEE: {complex_tf32:.3g} (0: the flag "
        f"not honoured); "
        f"{secs['small']:.1f} s + {secs['operators']:.1f} s; card {card}")

    # the certification
    t0 = time.perf_counter()
    errs = _zdft_certification()
    secs["certification"] = time.perf_counter() - t0
    log(f"[30 CT z-DFT certification] {ZDFT_CERT_SHAPE} x "
        f"{ZDFT_CERT_ANGLES} angles f32 on the card against exact cone "
        f"integrals of 3D Gaussians, relative error: "
        + "; ".join(f"D_so = {m:g}N: " + ", ".join(
            f"{k} {100 * v:.3f}%" for k, v in e.items())
            for m, e in errs.items())
        + f" (order 2 < gather, oversample 8 < 0.4% and < 0.15x gather); "
        f"{secs['certification']:.1f} s")

    # the solve: cp_inverse on the order-2 pair, 3 iterations
    t0 = time.perf_counter()
    n_iter = 3
    A, A_T = make_cone_spectral_projector(CT_SHAPE, angles, CONE, order=2)
    sino = A(vol)
    sino += 0.5 * torch.randn(sino.shape, generator=gen, device=DEV)
    del vol
    start = time.perf_counter()
    op_norm = float(power_iteration(A, A_T, CT_SHAPE, n_iter=3, device=DEV))
    norm_s = time.perf_counter() - start
    kw = dict(n_iter=n_iter, reg=0.5, cfg=TVConfig(**CT_CFG), nonneg=True,
              op_norm=op_norm)

    def solve():
        return cp_inverse(A, sino, CT_SHAPE, A_T=A_T, **kw)

    sync()
    torch.cuda.reset_peak_memory_stats(DEV)
    zero_counters()
    start = time.perf_counter()
    res = solve()
    sync()
    wall = (time.perf_counter() - start) * 1e3 / n_iter
    launches = read_counters()
    peak_solve = torch.cuda.max_memory_allocated(DEV)
    require_launches(launches, "cp_inverse on the order-2 pair", B5=n_iter,
                     B2=n_iter, B3=n_iter)
    require(bool(torch.isfinite(res.loss).all())
            and float(res.loss[-1]) < float(res.loss[0])
            and bool(torch.isfinite(res.x).all()),
            "z-DFT cp_inverse: finite, losses falling")
    loss = (float(res.loss[0]), float(res.loss[-1]))

    def one_more():
        # an iteration more from the solve's state: A_T and A, the kernels
        return cp_inverse(A, sino, CT_SHAPE, A_T=A_T, state=res.state,
                          **dict(kw, n_iter=1))

    one_ms = _best_ms(one_more, repeats=1)
    dev_ms = _cuda_device_ms(one_more)
    del res
    secs["solve"] = time.perf_counter() - t0
    del sino, A, A_T
    torch.cuda.empty_cache()
    log(f"[30 CT z-DFT solve] cp_inverse(order-2 pair, {CT_SHAPE} f32 x "
        f"{CT_ANGLES} angles, hybrid reg_time=0.5, reg 0.5, nonneg, "
        f"{n_iter} iterations, op_norm {op_norm:.4g} from a 3-step power "
        f"method in {norm_s:.1f} s): launches {launches}, loss "
        f"{loss[0]:.6g} -> {loss[1]:.6g}, {1e3 / wall:.4f} it/s "
        f"({wall:.1f} ms/it, one call); an iteration more from its state "
        f"{one_ms:.1f} ms, device {dev_ms:.1f} ms (torch.profiler, CUDA "
        f"activity only), idle {100 * (1 - dev_ms / one_ms):.1f}%; peak "
        f"memory {peak_solve / 1e9:.2f} GB; {secs['solve']:.1f} s; "
        f"card {card}")

    # the gradient in reg, and the example twins
    t0 = time.perf_counter()
    g, fd = _zdft_grad_check()
    ct_grads = _ct_grad_check()
    secs["gradient"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    ex = _run_examples()
    secs["examples"] = time.perf_counter() - t0
    log(f"[30 CT z-DFT gradient, examples] d/d reg of cp_inverse's error "
        f"(1, 1, 12, 12) f32, 40 iterations, on the card: autograd {g:.6g}, "
        f"central difference {fd:.6g} ({100 * abs(g - fd) / abs(fd):.3f}%; "
        f"no B5 / B2 launch); through the gather pairs (1, 1, 12, 12) f32, "
        f"5 angles, 5 iterations at 0.05: "
        + ", ".join(f"{k} autograd {a:.6g}, central difference {b:.6g} "
                    f"({100 * abs(a - b) / abs(b):.3f}%)"
                    for k, (a, b) in ct_grads.items())
        + f"; {secs['gradient']:.1f} s; example twins with "
        f"--device cuda, all exit 0 with their OK line, s each: "
        + ", ".join(f"{k} {v:.1f}" for k, v in ex.items())
        + f" ({secs['examples']:.1f} s at once); phase seconds "
        + ", ".join(f"{k} {v:.1f}" for k, v in secs.items()))
    sync()
    return launches


# ---------------------------------------------------------------- phase 31
GRID_MESHES = {"z4": (4, 1), "2x2": (2, 2), "4x2": (4, 2)}


def _on_grid(what, run, **expected):
    """``run()`` with every counter at 0 before it and read after it; the
    counters named in ``expected`` must read as given, every other 0."""
    sync()
    zero_counters()
    out = run()
    sync()
    got = read_counters()
    require_launches(got, what, **expected)
    return out


def _turns(runs, n_it, repeats=5):
    """ms per iteration of each of ``runs`` (each runs ``n_it`` of them):
    one warm-up call each, then ``repeats`` turns in which every run is
    timed once in its order (CUDA events), so that a drift of the card's
    clock or power falls on all alike.  ``(median, least, most)`` a run."""
    for run in runs:
        run()
    sync()
    times = [[] for _ in runs]
    for _ in range(repeats):
        for run, got in zip(runs, times):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            run()
            end.record()
            sync()
            got.append(start.elapsed_time(end) / n_it)
    return [(statistics.median(t), min(t), max(t)) for t in times]


def _turns_text(names, stats):
    """``name median (least to most)`` of :func:`_turns`' results."""
    return ", ".join(f"{name} {med:.4f} ({lo:.4f} to {hi:.4f})"
                     for name, (med, lo, hi) in zip(names, stats))


def _loss_rel(got, ref):
    return float(((got.float() - ref.float()).abs()
                  / ref.float().abs()).max())


def phase_grid_entry(card):
    """Phase 31: the normal entry points handed a grid of shards of the 4D
    cell, (32, 8, 256, 256) f32 from numpy, hybrid reg_time=0.5, as 4
    z-shards, a (2 x 2) and a (4 x 2) grid on the card: each call's kernel
    launches, its result against the same call on the whole volume, and
    its ms per iteration beside the direct call of the sharded solver
    (phases 25 and 29) and the whole volume's.  Returns the launches by
    kernel and call."""
    cfg = TVConfig(scheme="hybrid", reg_time=0.5)
    base = np.random.default_rng(0).random(MAIN_4D).astype(np.float32)
    whole = torch.as_tensor(base, device=DEV)
    grids = {k: shard_volume(base, make_mesh(*m), m[1] > 1)
             for k, m in GRID_MESHES.items()}
    n_it, t0 = 20, time.perf_counter()
    per = n_it * 4
    launches, lines = {}, []

    def direct_cp(grid, dual_dtype=None):
        mesh = make_mesh(len(grid), len(grid[0]))
        solve = make_sharded_cp_solver_fused(
            mesh, cfg, MAIN_4D, reg=1.0, n_iter=n_it,
            shard_time=len(grid[0]) > 1, dual_dtype=dual_dtype)
        Nd = num_channels(cfg.scheme, MAIN_4D[0], MAIN_4D[1],
                          cfg.reg_z_over_reg, cfg.reg_time)
        y_A = grid_map(torch.zeros_like, grid)
        y_D = grid_map(lambda a: a.new_zeros(
            (a.shape[0], a.shape[1], Nd) + tuple(a.shape[2:])), grid)
        return lambda: solve(grid, grid, y_A, y_D)

    # CP: the overlapped step on 4 z-shards (B1, B2, B8), the ghost step on
    # (2 x 2) (B1, B2); phase 25's bars against chambolle_pock
    for name, key, dual in (("cp z4", "z4", None),
                            ("cp z4 bf16 dual", "z4", "bfloat16"),
                            ("cp 2x2", "2x2", None)):
        grid = grids[key]
        b8 = per if key == "z4" else 0
        mode = "int" if key == "z4" else "halo"
        expect = {"B1": per, "B2": per, "B8dual": b8, "B8primal": b8,
                  "B1" + mode: per, "B2" + mode: per}
        res = _on_grid(name, lambda: chambolle_pock(
            grid, n_iter=n_it, reg=1.0, cfg=cfg, dual_dtype=dual), **expect)
        launches[name] = expect
        ref = chambolle_pock(whole, n_iter=n_it, reg=1.0, cfg=cfg,
                             dual_dtype=dual)
        rel = _loss_rel(res.loss, ref.loss)
        require(rel <= (1e-4 if dual else 1e-6),
                f"{name}: losses within the bar of the whole volume's, got "
                f"{rel:.3g}")
        err = _compare(gather_volume(res.x), ref.x, dual is not None, 1.0)
        require(is_grid(res.state.y_D) and res.state.y_D[0][0].dtype
                == torch.float32, f"{name}: y_D a float32 grid")
        # all three return the dual in the kernels' layout or not at all
        ms = _turns((lambda: chambolle_pock(
                        grid, n_iter=n_it, reg=1.0, cfg=cfg,
                        dual_dtype=dual, return_dual=False),
                     direct_cp(grid, dual),
                     lambda: chambolle_pock(
                        whole, n_iter=n_it, reg=1.0, cfg=cfg,
                        dual_dtype=dual, return_dual=False)), n_it)
        lines.append(f"{name}: losses within {rel:.3g}, x within {err:.3g}; "
                     "ms/it, median (least to most) of 5 turns: "
                     + _turns_text(("entry point, return_dual=False",
                                    "direct make_sharded_cp_solver_fused",
                                    "whole volume"), ms))
        del res, ref

    # GD and tv_and_subgrad on 4 z-shards: B3 and B4 in their halo mode
    grid = grids["z4"]
    gd_kw = dict(n_iter=n_it, reg=1.0, step_size=5e-3, cfg=cfg)
    res = _on_grid("gd z4", lambda: subgradient_descent(grid, **gd_kw),
                   B3=per, B4=per)
    launches["gd z4"] = dict(B3=per, B4=per)
    ref = subgradient_descent(whole, **gd_kw)
    rel = max(_loss_rel(res.loss, ref.loss), _loss_rel(res.tv, ref.tv))
    require(rel <= 1e-5, f"gd z4: loss and tv histories within 1e-5 of "
                         f"the whole volume's, got {rel:.3g}")
    err = _compare(gather_volume(res.x), ref.x, False, 0.0, F32_TOL_GD)
    solve = make_sharded_gd_solver_fused(make_mesh(4), cfg, MAIN_4D,
                                         reg=1.0, n_iter=n_it,
                                         step_size=5e-3, shard_time=False)
    ms = _turns((lambda: subgradient_descent(grid, **gd_kw),
                 lambda: solve(grid, grid),
                 lambda: subgradient_descent(whole, **gd_kw)), n_it)
    lines.append(f"gd z4: loss and tv within {rel:.3g}, x within {err:.3g}; "
                 "ms/it, median (least to most) of 5 turns: "
                 + _turns_text(("entry point",
                                "direct make_sharded_gd_solver_fused",
                                "whole volume"), ms))
    del res, ref
    tv_kw = dict(scheme="hybrid", reg_time=0.5)
    tv, G = _on_grid("tv z4", lambda: pytv4d_tpu_torch.tv_and_subgrad(
        grid, **tv_kw), B3=4, B4=4)
    launches["tv z4"] = dict(B3=4, B4=4)
    tv_ref, G_ref = pytv4d_tpu_torch.tv_and_subgrad(whole, **tv_kw)
    rel = abs(float(tv) - float(tv_ref)) / abs(float(tv_ref))
    require(rel <= 1e-5, f"tv z4: tv within 1e-5, got {rel:.3g}")
    err = _compare(gather_volume(G), G_ref, False, 0.0, F32_TOL_GD)
    direct = fused_halo.make_sharded_tv_and_subgrad_fused(
        make_mesh(4), cfg, MAIN_4D, shard_time=False)
    # a call is ~3 ms of host work on 4 shards: a turn times n_it calls
    ms = _turns((lambda: [pytv4d_tpu_torch.tv_and_subgrad(grid, **tv_kw)
                          for _ in range(n_it)],
                 lambda: [direct(grid) for _ in range(n_it)],
                 lambda: [pytv4d_tpu_torch.tv_and_subgrad(whole, **tv_kw)
                          for _ in range(n_it)]), n_it)
    lines.append(f"tv_and_subgrad z4: tv within {rel:.3g}, G within "
                 f"{err:.3g}; ms a call ({n_it} calls a turn), median "
                 "(least to most) of 5 turns: " + _turns_text(
                     ("entry point", "direct "
                      "make_sharded_tv_and_subgrad_fused", "whole volume"),
                     ms))
    del G, G_ref

    # TGV: '2d' on (4 x 2), one B7 a shard; '4d' on 4 z-shards, B6 PQ and
    # XW a shard and iteration; '4d' on (2 x 2) cuts time: the plain loop
    tk = dict(n_iter=n_it, alpha1=1.0, alpha0=2.0)
    grid = grids["4x2"]
    res = _on_grid("tgv 2d 4x2", lambda: tgv_denoise(grid, **tk), B7=8)
    launches["tgv 2d 4x2"] = dict(B7=8)
    ref = tgv_denoise(whole, **tk)
    require(torch.equal(gather_volume(res.x), ref.x)
            and torch.equal(gather_d_volume(res.w), ref.w),
            "tgv 2d 4x2: x and w bit-equal to the whole volume's")
    rel = _loss_rel(res.loss, ref.loss)
    require(rel <= 1e-6, f"tgv 2d 4x2: loss within 1e-6, got {rel:.3g}")
    mesh42 = make_mesh(4, 2)
    ms = _turns((lambda: tgv_denoise(grid, **tk),
                 lambda: tgv_denoise_sharded(grid, mesh42, **tk),
                 lambda: tgv_denoise(whole, **tk)), n_it)
    lines.append(f"tgv 2d 4x2: x, w bit-equal, loss within {rel:.3g}; "
                 "ms/it, median (least to most) of 5 turns: "
                 + _turns_text(("entry point", "direct tgv_denoise_sharded",
                                "whole volume"), ms))
    del res, ref
    grid = grids["z4"]
    lean = dict(tk, axes="4d", compute_loss=False)
    res = _on_grid("tgv 4d z4", lambda: tgv_denoise(grid, **lean),
                   B6pq=per, B6xw=per)
    launches["tgv 4d z4"] = dict(B6pq=per, B6xw=per)
    ref = tgv_denoise(whole, **lean)
    err = max(_compare(gather_volume(res.x), ref.x, False, 0.0, F32_TOL_20),
              _compare(gather_d_volume(res.w), ref.w, False, 0.0,
                       F32_TOL_20))
    solve = make_sharded_tgv_stream_solver(make_mesh(4), MAIN_4D, "4d",
                                           n_iter=n_it, alpha1=1.0,
                                           alpha0=2.0)
    ms = _turns((lambda: tgv_denoise(grid, **lean), lambda: solve(grid),
                 lambda: tgv_denoise(whole, **lean)), n_it)
    lines.append(f"tgv 4d z4: x, w within {err:.3g} of the whole volume's "
                 "stream solve; ms/it, median (least to most) of 5 turns: "
                 + _turns_text(("entry point",
                                "direct make_sharded_tgv_stream_solver",
                                "whole volume"), ms))
    del res, ref
    # '4d' on 4 z-shards with the per-iteration loss: the sharded stream
    # solver, its objective (tgv_objective, a sum over shards) sampled
    # every iteration; the whole volume streams with the objective kernel
    full = dict(tk, axes="4d")
    res = _on_grid("tgv 4d z4 loss", lambda: tgv_denoise(grid, **full),
                   B6pq=per, B6xw=per)
    launches["tgv 4d z4 loss"] = dict(B6pq=per, B6xw=per)
    ref = tgv_denoise(whole, **full)
    require(res.loss.shape == (n_it,) and res.loss.dtype == torch.float32,
            "tgv 4d z4 loss: a float32 loss every iteration")
    rel = _loss_rel(res.loss, ref.loss)
    require(rel <= 1e-5, f"tgv 4d z4 loss: loss within 1e-5 of the whole "
                         f"volume's, got {rel:.3g}")
    err = _compare(gather_volume(res.x), ref.x, False, 0.0, F32_TOL_20)
    lines.append(f"tgv 4d z4 with the per-iteration loss: loss within "
                 f"{rel:.3g}, x within {err:.3g} of the whole volume's "
                 "streamed solve (B6 and the objective kernel)")
    del res, ref
    grid = grids["2x2"]
    res = _on_grid("tgv 4d 2x2", lambda: tgv_denoise(grid, **full))
    ref = tgv_denoise(whole, **full)  # the whole volume streams, B6 + obj
    rel = _loss_rel(res.loss, ref.loss)
    require(rel <= 1e-5, f"tgv 4d 2x2: loss within 1e-5, got {rel:.3g}")
    err = _compare(gather_volume(res.x), ref.x, False, 0.0, F32_TOL_20)
    ms = _turns((lambda: tgv_denoise(grid, **full),
                 lambda: tgv_denoise(whole, **full)), n_it)
    lines.append(f"tgv 4d 2x2 (the plain loop on the grid, no launch): loss "
                 f"within {rel:.3g}, x within {err:.3g}; ms/it, median "
                 "(least to most) of 5 turns: " + _turns_text(
                     ("entry point", "whole volume, streamed"), ms))
    del res, ref

    # ADMM and FISTA: plain loops on the exchanged stencils, no kernel
    grid = grids["z4"]
    for name, fn, n in (("admm z4", admm, 5), ("fista z4", fista, n_it)):
        res = _on_grid(name, lambda: fn(grid, n_iter=n, reg=1.0, cfg=cfg))
        ref = fn(whole, n_iter=n, reg=1.0, cfg=cfg)
        rel = _loss_rel(res.loss, ref.loss)
        require(rel <= 1e-5, f"{name}: losses within 1e-5, got {rel:.3g}")
        err = _compare(gather_volume(res.x), ref.x, False, 0.0, F32_TOL_20)
        ms = _turns((lambda: fn(grid, n_iter=n, reg=1.0, cfg=cfg),
                     lambda: fn(whole, n_iter=n, reg=1.0, cfg=cfg)), n)
        lines.append(f"{name}: losses within {rel:.3g}, x within {err:.3g}; "
                     "ms/it, median (least to most) of 5 turns: "
                     + _turns_text(("entry point", "whole volume"), ms))
        del res, ref
    torch.cuda.empty_cache()
    log(f"[31 entry points on a grid] {MAIN_4D} f32 hybrid reg_time=0.5 "
        f"from numpy, {n_it} iterations (ADMM 5), as {sorted(GRID_MESHES)} "
        f"grids ({card}); launches by call {launches}; "
        + "; ".join(lines)
        + f"; {time.perf_counter() - t0:.1f} s")
    out = {}
    for call, got in launches.items():
        for kid, n in got.items():
            if n:
                out.setdefault(kid, {})[call] = n
    return out


# ---------------------------------------------------------------- phase 32
CT_GRIDS = {"z4": (4, 1), "2x2": (2, 2)}
# the checks that take the plain step (precond) or no solver: a smaller
# parallel problem, and a cone one cut along t
CT32_SMALL, CT32_SMALL_ANGLES = (8, 2, 128, 128), 32
CT32_CONE_SHAPE = (8, 4, 128, 128)
CT32_CONE = ConeBeamGeometry(source_dist=256.0, det_dist=128.0)
CT32_BF16_TOL = 1e-3  # x of a bf16-dual grid solve, of the scale


def _b5_halo_tables():
    """B5's halo launch over every table it is built for (21) x the 4
    storage pairs x an even and an odd width, on three grids of each
    volume: 1 x 1, (2 x 2), and a z-cut into one-plane shards (z4, or z2
    where the table needs Nz = 2, central's FWD z channel).  Each shard's
    x_bar is extended by its ghost or neighbour planes as the sharded CT
    solve extends it; its y_D' must lie within the CP bar of the plain
    version (bf16 one ulp) with its TV partials' sum within 1e-5, and the
    gathered y_D' must equal the unsharded B5's on the whole volume bit for
    bit.  Returns (cases, shard launches, max abs errs f32 / bf16)."""
    n_case = n_shard = 0
    errs = {"f32": 0.0, "bf16": 0.0}
    gen = torch.Generator(device=DEV).manual_seed(5321)
    for tid, (cfg, dims) in _halo_tv_table_configs().items():
        chans, _ = scheme_channels(cfg.scheme, *dims, cfg.reg_z_over_reg,
                                   cfg.reg_time)
        gz = fused_halo._axis_ghost_kind(chans, AXIS_Z)
        gt = fused_halo._axis_ghost_kind(chans, AXIS_T)
        kw = dict(cfg=cfg, sigma_D=0.4, reg=0.5)
        for storage, rc in itertools.product(SHARD_STORAGE, HALO_TV_WIDTHS):
            x_dt, d_dt = SHARD_STORAGE[storage]
            kind = "f32" if storage == "f32" else "bf16"
            shape = dims + rc
            x = torch.randn(shape, generator=gen, device=DEV).to(x_dt)
            y = (0.3 * torch.randn(dims + (len(chans),) + rc, generator=gen,
                                   device=DEV)).to(d_dt)
            want, _ = fused.tv_dual(x, y.clone(), **kw)
            for mesh_zt in ((1, 1), (2, 2), (dims[0], 1)):
                mesh, st = make_mesh(*mesh_zt), mesh_zt[1] > 1
                xe = fused_halo._extend_axis(fused_halo._extend_axis(
                    shard_volume(x, mesh, st), 0, gz), 1, gt)
                ys = shard_volume(y, mesh, st)
                mode = dict(halo_mode=True, table_dims=dims, **kw)
                got = grid_map(lambda a, b: fused.tv_dual(a, b.clone(),
                                                          **mode), xe, ys)
                for (g, tk), a, b in _cells(got, xe, ys):
                    p, tp = fused.tv_dual_plain(a, b.clone(), **mode)
                    errs[kind] = max(errs[kind], _compare(
                        g, p, kind == "bf16", kw["reg"]))
                    rel = abs(float(tk.sum()) - float(tp.sum())) / float(
                        tp.sum())
                    require(rel <= 1e-5, f"B5 halo table {tid} {storage} "
                            f"{shape} on {mesh_zt}: TV sum {rel:.3g}")
                    n_shard += 1
                require(_bits_equal(gather_volume(grid_map(
                    lambda c: c[0], got)), want),
                    f"B5 halo table {tid} {storage} {shape} on {mesh_zt}: "
                    f"y_D' bit-equal to the unsharded B5's on the gathered "
                    f"volume")
            n_case += 1
    sync()
    return n_case, n_shard, errs


def _b5_halo(card):
    """B5 in its halo mode (``csrc/specialised_tv.cu``, the HALO instance of
    ``tv_dual_spec_kernel``): over every table and storage pair on three
    grids (``_b5_halo_tables``), and on one of 4 z-shards of the CT cell,
    ``(4, 4, 512, 512)`` with its ghost planes, hybrid ``reg_time=0.5``:
    against its plain version (f32, a bf16 dual and bf16, the CP bar) and
    on the device (``_kernel_ms``) beside its bound (``_halo_b5_bound``)
    in each storage, and in f32 its time against the plain version's in
    alternating turns."""
    n_case, n_shard, table_errs = _b5_halo_tables()
    cfg = TVConfig(**CT_CFG)
    Nd = num_channels(cfg.scheme, CT_SHAPE[0], CT_SHAPE[1],
                      cfg.reg_z_over_reg, cfg.reg_time)
    local = (CT_SHAPE[0] // 4,) + CT_SHAPE[1:]
    gen = torch.Generator(device=DEV).manual_seed(32)
    x_ext = torch.randn((local[0] + 2, local[1] + 2) + local[2:],
                        generator=gen, device=DEV)
    y0 = 0.3 * torch.randn(local[:2] + (Nd,) + local[2:], generator=gen,
                           device=DEV)
    kw = dict(cfg=cfg, sigma_D=0.3, reg=0.5, halo_mode=True,
              table_dims=CT_SHAPE[:2])
    out = dict(kernel="tv_dual_spec_kernel<T, TX, TD, true>",
               source="pytv4d_tpu_torch/csrc/specialised_tv.cu",
               at_storage={})
    errs = dict(table_errs)
    for name, (x_dt, d_dt) in (("f32", (torch.float32, torch.float32)),
                               ("bf16 dual", (torch.float32, torch.bfloat16)),
                               ("bf16", (torch.bfloat16, torch.bfloat16))):
        xs, y = x_ext.to(x_dt), y0.to(d_dt)
        got, parts = fused.tv_dual(xs, y.clone(), **kw)
        want, want_parts = fused.tv_dual_plain(xs, y.clone(), **kw)
        sync()
        kind = "f32" if name == "f32" else "bf16"
        errs[kind] = max(errs[kind], _compare(got, want, kind == "bf16",
                                              kw["reg"]))
        rel = abs(float(parts.sum()) - float(want_parts.sum())) / abs(
            float(want_parts.sum()))
        require(rel <= 1e-5, f"B5 halo {name}: TV partials within 1e-5 of "
                             f"the plain version's, got {rel:.3g}")
        dev_ms, seen = _kernel_ms(lambda: fused.tv_dual(xs, y, **kw),
                                  "tv_dual_spec_kernel")
        require(seen == 50, f"B5 halo {name}: the trace kept all 50 "
                            f"launches, got {seen}")
        b_ms, by, n_bytes = _halo_b5_bound(local, cfg, CT_SHAPE[:2], x_dt,
                                           d_dt)
        out["at_storage"][name] = dict(device_ms=dev_ms, seen=seen,
                                       bound_ms=b_ms, bound_by=by,
                                       bytes=n_bytes)
        del xs, y, got, want
    y_k, y_p = y0.clone(), y0.clone()
    n = 20
    ms = _turns((lambda: [fused.tv_dual(x_ext, y_k, **kw) for _ in range(n)],
                 lambda: [fused.tv_dual_plain(x_ext, y_p, **kw)
                          for _ in range(n)]), n, repeats=3)
    f32 = out["at_storage"]["f32"]
    out.update(shard=list(local), ms=ms[0][0], plain_ms=ms[1][0],
               device_ms=f32["device_ms"], bound_ms=f32["bound_ms"],
               bound_by=f32["bound_by"], bytes=f32["bytes"],
               max_abs_err=errs["f32"], max_abs_err_bf16=errs["bf16"],
               table_cases=n_case, table_shards=n_shard)
    log(f"[32 B5 halo mode] tv_dual_spec_kernel's HALO instance over all "
        f"{len(tables.TABLES)} tables x {len(SHARD_STORAGE)} storage pairs "
        f"x {HALO_TV_WIDTHS} on a 1 x 1, a (2 x 2) and a z-cut grid "
        f"({n_case} volumes, {n_shard} shard launches): each shard within "
        f"the CP bar of its plain version (max abs err f32 "
        f"{table_errs['f32']:.3g}, bf16 {table_errs['bf16']:.3g}), the "
        f"gathered y_D' bit-equal to the unsharded B5's in every case; one "
        f"of 4 z-shards of {CT_SHAPE}, {local} + ghost planes, hybrid "
        f"reg_time=0.5 ({card}): max |kernel - plain| f32 "
        f"{errs['f32']:.3g}, bf16 {errs['bf16']:.3g}; f32 ms a launch, "
        f"median (least to most) of 3 turns of {n}: "
        + _turns_text(("kernel", "plain"), ms)
        + f", kernel at {f32['bound_ms'] / ms[0][0]:.1%} of its bound "
        f"(events); on the device, beside the bound (the planes its table "
        f"reads): "
        + ", ".join(f"{k} {v['device_ms']:.4f} ms ({v['seen']} of 50 "
                    f"launches recorded), bound {v['bound_ms']:.4f} ms "
                    f"({v['bound_by']}, {v['bytes'] / 1e6:.1f} MB): "
                    f"{v['bound_ms'] / v['device_ms']:.1%}"
                    for k, v in out["at_storage"].items()))
    return out


def _held(name, res, ref, loss_rtol=1e-5, x_tol=CT_SHARD_TOL):
    """``res`` (a grid call's result) holds to ``ref`` (the whole
    volume's): losses within ``loss_rtol``, x within ``x_tol`` of the
    scale.  Returns the two errors."""
    rel = _loss_rel(res.loss, ref.loss)
    require(rel <= loss_rtol, f"{name}: losses within {loss_rtol} of the "
                              f"whole volume's, got {rel:.3g}")
    scale = float(ref.x.abs().max())
    err = float((gather_volume(res.x).float() - ref.x.float()).abs().max()
                ) / scale
    require(err <= x_tol and bool(torch.isfinite(ref.x).all()),
            f"{name}: x within {x_tol} of the scale, got {err:.3g}")
    return rel, err


def _rel_of(got, want):
    """max |gathered grid - whole| over the whole's largest |value|."""
    return float((gather_volume(got) - want).abs().max()) / float(
        want.abs().max())


def phase_grid_ct(card):
    """Phase 32: the CT entry points and the remaining solver entry points
    handed a grid of shards, against the same call on the whole volume.
    The CT cell, (16, 4, 512, 512) x 96 angles from numpy (f32, hybrid
    reg_time=0.5, nonneg), as 4 z-shards and a (2 x 2) grid:
    ``cp_reconstruct`` (method 'auto', the spectral pair on the card; f32,
    a bf16 dual, resumed from a whole-volume state, an array
    fidelity_weight) on B5 / B2 / B3 in their halo mode, timed beside the
    plain halo path and the whole volume in turns; ``precond`` on the
    gather pair and on the spectral cone cut along t, ``tgv_reconstruct``,
    ``fdk``, ``fbp`` and ``sart``; on the 4D cell's 4 z-shards
    ``chambolle_pock_precond``, ``run_until_converged``,
    ``run_checkpointed`` (written on the grid, resumed on the volume) and
    the five ``TVDenoiser`` methods.  Returns the launches by kernel and
    call, and B5's halo mode against its plain version."""
    t0 = time.perf_counter()
    halo = _b5_halo(card)
    cfg = TVConfig(**CT_CFG)
    rng = np.random.default_rng(32)
    vol = torch.as_tensor(rng.random(CT_SHAPE, dtype=np.float32), device=DEV)
    angles = np.linspace(0.0, np.pi, CT_ANGLES, endpoint=False)
    sino = radon(vol, angles)
    sino += torch.as_tensor(0.5 * rng.standard_normal(
        tuple(sino.shape), dtype=np.float32), device=DEV)
    weight = rng.random(tuple(sino.shape), dtype=np.float32) + 0.5
    del vol
    A, A_T = make_projector(CT_SHAPE, angles)  # 'auto': the spectral pair
    n_it = 10
    kw = dict(n_iter=n_it, reg=0.5, cfg=cfg, nonneg=True,
              op_norm=float(estimate_op_norm(A, A_T, CT_SHAPE, device=DEV)))
    grids = {k: shard(sino, sinogram_sharding(make_mesh(*m)))
             for k, m in CT_GRIDS.items()}
    launches, lines = {}, []
    per = dict(B5=n_it * 4, B2=n_it * 4, B2halo=n_it * 4, B3=n_it * 4)

    def ct_case(name, run_grid, run_whole, expect=per, **bars):
        res = _on_grid(name, run_grid, **expect)
        launches[name] = dict(expect)
        rel, err = _held(name, res, run_whole(), **bars)
        lines.append(f"{name}: losses within {rel:.3g}, x within {err:.3g} "
                     f"of the scale")
        return res

    for key in CT_GRIDS:
        ct_case(f"cp_reconstruct {key}", lambda: cp_reconstruct(
            grids[key], angles, CT_SHAPE, **kw),
            lambda: cp_reconstruct(sino, angles, CT_SHAPE, **kw))
    ct_case("cp_reconstruct z4 bf16 dual", lambda: cp_reconstruct(
        grids["z4"], angles, CT_SHAPE, dual_dtype="bfloat16", **kw),
        lambda: cp_reconstruct(sino, angles, CT_SHAPE, dual_dtype="bfloat16",
                               **kw), loss_rtol=1e-4, x_tol=CT32_BF16_TOL)
    half = dict(kw, n_iter=n_it // 2)
    first = cp_reconstruct(sino, angles, CT_SHAPE, **half)
    full = cp_reconstruct(sino, angles, CT_SHAPE, **kw)
    ct_case("cp_reconstruct z4 resumed", lambda: cp_reconstruct(
        grids["z4"], angles, CT_SHAPE, state=first.state, **half),
        lambda: full._replace(loss=full.loss[n_it // 2:]),
        expect={k: v // 2 for k, v in per.items()})
    del first, full
    ct_case("cp_reconstruct z4 fidelity_weight", lambda: cp_reconstruct(
        grids["z4"], angles, CT_SHAPE, fidelity_weight=weight, **kw),
        lambda: cp_reconstruct(sino, angles, CT_SHAPE,
                               fidelity_weight=weight, **kw))
    ms = _turns((lambda: cp_reconstruct(grids["z4"], angles, CT_SHAPE, **kw),
                 lambda: cp_reconstruct(grids["z4"], angles, CT_SHAPE,
                                        fused=False, **kw),
                 lambda: cp_reconstruct(sino, angles, CT_SHAPE, **kw)), n_it,
                repeats=3)
    lines.append("cp_reconstruct z4 ms/it, median (least to most) of 3 "
                  "turns: " + _turns_text(
                      ("fused grid (B5 / B2 / B3 halo)",
                       "plain halo grid (fused=False)", "whole volume"), ms))
    grid_ms = {"fused": ms[0][0], "plain": ms[1][0], "whole": ms[2][0]}
    del grids
    fb = _on_grid("fbp z4", lambda: fbp(shard(sino, sinogram_sharding(
        make_mesh(4))), angles))
    rel = _rel_of(fb, fbp(sino, angles))
    require(rel <= 1e-5, f"fbp z4 within 1e-5, got {rel:.3g}")
    lines.append(f"fbp z4 within {rel:.3g}")
    del fb, sino

    # the plain step and the calls with no solver, at smaller shapes
    rng = np.random.default_rng(33)
    small = torch.as_tensor(rng.random(CT32_SMALL, dtype=np.float32),
                            device=DEV)
    ang_s = np.linspace(0.0, np.pi, CT32_SMALL_ANGLES, endpoint=False)
    sino_s = radon(small, ang_s)
    grid_s = shard(sino_s, sinogram_sharding(make_mesh(4)))
    pk = dict(n_iter=n_it, reg=0.05, cfg=cfg, precond=True, nonneg=True,
              method="gather")
    ct_case("cp_reconstruct precond gather z4", lambda: cp_reconstruct(
        grid_s, ang_s, CT32_SMALL, **pk),
        lambda: cp_reconstruct(sino_s, ang_s, CT32_SMALL, **pk), expect={})
    sk = dict(n_iter=1, n_subsets=8, method="gather")
    got = _on_grid("sart z4", lambda: sart(grid_s, ang_s, CT32_SMALL, **sk))
    want = sart(sino_s, ang_s, CT32_SMALL, **sk)
    res_rel = float(((got.residual - want.residual).abs()
                     / want.residual.abs()).max())
    require(res_rel <= 1e-5, f"sart z4: residual within 1e-5, got "
                             f"{res_rel:.3g}")
    rel = _rel_of(got.x, want.x)
    require(rel <= 1e-4, f"sart z4: x within 1e-4, got {rel:.3g}")
    lines.append(f"sart z4: x within {rel:.3g}, residual {res_rel:.3g}")
    cone_vol = torch.as_tensor(rng.random(CT32_CONE_SHAPE, dtype=np.float32),
                               device=DEV)
    ang_c = np.linspace(0.0, 2 * np.pi, CT32_SMALL_ANGLES, endpoint=False)
    sino_c = radon_cone(cone_vol, ang_c, CT32_CONE)
    grid_c = shard(sino_c, cone_sinogram_sharding(make_mesh(1, 4)))
    ck = dict(n_iter=n_it, reg=0.05, cfg=cfg, geom=CT32_CONE, precond=True,
              method="spectral")
    ct_case("cp_reconstruct precond spectral cone t4", lambda: cp_reconstruct(
        grid_c, ang_c, CT32_CONE_SHAPE, **ck),
        lambda: cp_reconstruct(sino_c, ang_c, CT32_CONE_SHAPE, **ck),
        expect={})
    tk = dict(n_iter=5, alpha1=0.05, alpha0=0.1, geom=CT32_CONE)
    ct_case("tgv_reconstruct cone t4", lambda: tgv_reconstruct(
        grid_c, ang_c, CT32_CONE_SHAPE, **tk),
        lambda: tgv_reconstruct(sino_c, ang_c, CT32_CONE_SHAPE, **tk),
        expect={})
    got = _on_grid("fdk t4", lambda: fdk(grid_c, ang_c, CT32_CONE,
                                         CT32_CONE_SHAPE))
    rel = _rel_of(got, fdk(sino_c, ang_c, CT32_CONE, CT32_CONE_SHAPE))
    require(rel <= 1e-5, f"fdk cone t4 within 1e-5, got {rel:.3g}")
    lines.append(f"fdk cone t4 within {rel:.3g}")
    del small, sino_s, grid_s, cone_vol, sino_c, grid_c, got, want

    # the remaining solver entry points on the 4D cell's 4 z-shards
    base = np.random.default_rng(0).random(MAIN_4D).astype(np.float32)
    whole = torch.as_tensor(base, device=DEV)
    grid = shard_volume(base, make_mesh(4), False)
    den = dict(reg=1.0, cfg=cfg)
    n4 = 10 * 4

    def solver_case(name, run_grid, run_whole, expect, **bars):
        res = _on_grid(name, run_grid, **expect)
        launches[name] = dict(expect)
        rel, err = _held(name, res, run_whole(), **bars)
        lines.append(f"{name}: losses within {rel:.3g}, x within {err:.3g}")

    solver_case("chambolle_pock_precond z4", lambda: chambolle_pock_precond(
        grid, n_iter=5, **den), lambda: chambolle_pock_precond(
        whole, n_iter=5, **den), {})
    cp_launches = dict(B1=n4, B2=n4, B8dual=n4, B8primal=n4, B1int=n4,
                       B2int=n4)
    conv = dict(chunk=5, max_iter=10, tol=1e-12, **den)
    solver_case("run_until_converged z4", lambda: run_until_converged(
        chambolle_pock, grid, **conv), lambda: run_until_converged(
        chambolle_pock, whole, **conv), cp_launches, loss_rtol=1e-6)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "grid.npz")
        _on_grid("run_checkpointed z4 (written)", lambda: run_checkpointed(
            chambolle_pock, grid, 10, path, 5, **den), **cp_launches)
        launches["run_checkpointed z4 (written)"] = cp_launches
        # the npz holds the whole arrays: the volume resumes from it
        res = _on_grid("run_checkpointed, resumed on the volume",
                       lambda: run_checkpointed(chambolle_pock, whole, 20,
                                                path, 5, **den), B1=10, B2=10)
    ref = chambolle_pock(whole, n_iter=20, **den)
    rel = _loss_rel(res.loss, ref.loss)
    err = float((res.x - ref.x).abs().max())
    require(rel <= 1e-6 and err <= 1e-4, f"run_checkpointed: written on the "
            f"grid, resumed on the volume, losses within 1e-6 ({rel:.3g}) "
            f"and x within 1e-4 ({err:.3g}) of the uninterrupted solve")
    lines.append(f"run_checkpointed z4 -> volume: losses within {rel:.3g}, x "
                 f"within {err:.3g}")
    del res, ref
    dk = {"cp": (dict(n_iter=10), cp_launches),
          "gd": (dict(n_iter=10), dict(B3=n4, B4=n4)),
          "tgv": (dict(n_iter=10, alpha0=2.0), dict(B7=4)),
          "admm": (dict(n_iter=3), {}),
          "fista": (dict(n_iter=10), {})}
    model = TVDenoiser(reg=1.0, cfg=cfg)
    for meth, (mkw, expect) in dk.items():
        solver_case(f"TVDenoiser.{meth} z4", lambda: getattr(model, meth)(
            grid, **mkw), lambda: getattr(model, meth)(whole, **mkw), expect,
            loss_rtol=1e-5, x_tol=1e-4)
    del whole, grid
    torch.cuda.empty_cache()
    log(f"[32 CT and solver entry points on a grid] {CT_SHAPE} x "
        f"{CT_ANGLES} angles from numpy as {sorted(CT_GRIDS)} grids, "
        f"{n_it} iterations; {CT32_SMALL} x {CT32_SMALL_ANGLES} (gather "
        f"precond, SART) on 4 z-shards; the cone {CT32_CONE_SHAPE} x "
        f"{CT32_SMALL_ANGLES} cut along t; {MAIN_4D} on 4 z-shards ({card}); "
        f"launches by call {launches}; " + "; ".join(lines)
        + f"; {time.perf_counter() - t0:.1f} s")
    out = {}
    for call, got in launches.items():
        for kid, n in got.items():
            if n:
                out.setdefault(kid, {})[call] = n
    halo["launches_grid"] = out.get("B5", {})
    halo["grid_ms_per_it"] = grid_ms
    return out, halo


# ---------------------------------------------------------------- phase 33
# the keys of each dict of pytv4d_tpu/bench/harness.py (the sweeps': of each
# shard count's row); tests/test_torch_bench_harness.py holds the port's to
# the JAX package's on the CPU
HARNESS_KEYS = {
    "bench_solver": {"it_per_s", "gvox_it_per_s", "est_gb_per_s",
                     "roofline_fraction"},
    "sweep": {"it_per_s", "efficiency"},
    "bench_ct": {"radon_proj_per_s", "radon_s", "adjoint_proj_per_s",
                 "adjoint_s", "normal_op_scan_it_per_s", "recon_it_per_s",
                 "recon_final_loss"},
    "bench_ct_cone": {"cone_fwd_proj_per_s", "cone_fwd_s",
                      "cone_adjoint_proj_per_s", "cone_adjoint_s",
                      "cone_normal_op_scan_it_per_s", "cone_recon_it_per_s",
                      "cone_recon_final_loss", "cone_fdk_s",
                      "cone_sart_epochs_per_s"},
}
HARNESS_SHARDS = [1, 2, 4]  # the sweeps' shard counts, all on the one card
CT_KERNELS = ("B5", "B2", "B3")  # the fused CT step's launches


def phase_harness(card):
    """Phase 33: the benchmark harness (``pytv4d_tpu_torch.bench``) on the
    card at the JAX package's defaults: each function's dict (its keys the
    JAX harness's, every value finite and positive), launches, peak memory
    and seconds; ``bench_ct_production``'s final loss against a direct
    ``cp_reconstruct`` of the same seeded inputs.  Returns the launches by
    kernel and call."""
    t0 = time.perf_counter()
    launches = {}

    def call(name, run, keys, need=()):
        ct.clear_projector_cache()
        torch.cuda.empty_cache()
        sync()
        torch.cuda.reset_peak_memory_stats(DEV)
        zero_counters()
        t = time.perf_counter()
        res = run()
        sync()
        secs = time.perf_counter() - t
        got = read_counters()
        rows = [res]
        if keys == "sweep":
            require(sorted(res) == HARNESS_SHARDS,
                    f"{name}: shard counts {HARNESS_SHARDS}, got {sorted(res)}")
            rows = list(res.values())
        for row in rows:
            require(set(row) == HARNESS_KEYS[keys],
                    f"{name}: keys {sorted(HARNESS_KEYS[keys])}, got "
                    f"{sorted(row)}")
            require(all(np.isfinite(v) and v > 0 for v in row.values()),
                    f"{name}: every value finite and positive, got {row}")
        for kid in need:
            require(got[kid] >= 1, f"{name}: {kid} launched, got {got}")
        launches[name] = {k: n for k, n in got.items() if n}
        log(f"[33 harness] {name}: {json.dumps(res)}")
        log(f"[33 harness] {name}: launches {launches[name]}, peak "
            f"{torch.cuda.max_memory_allocated(DEV) / 1e9:.2f} GB, "
            f"{secs:.1f} s")
        return res

    call("bench_solver", bench.bench_solver, "bench_solver", ("B1", "B2"))
    call("bench_solver bf16 dual",
         lambda: bench.bench_solver(dual_dtype=torch.bfloat16),
         "bench_solver", ("B1", "B2"))
    call("weak_scaling", lambda: bench.weak_scaling(
        device_counts=HARNESS_SHARDS), "sweep")
    call("weak_scaling_tgv", lambda: bench.weak_scaling_tgv(
        device_counts=HARNESS_SHARDS), "sweep", ("B6pq", "B6xw"))
    call("bench_ct", bench.bench_ct, "bench_ct", CT_KERNELS)
    prod = call("bench_ct_production", bench.bench_ct_production,
                "bench_ct", CT_KERNELS)
    call("bench_ct_cone", bench.bench_ct_cone, "bench_ct_cone", CT_KERNELS)

    # bench_ct_production's solve, called directly on the same seeded
    # inputs and operator norm (the spectral pair has no atomics)
    ct.clear_projector_cache()
    vol = torch.as_tensor(np.random.default_rng(0).random(CT_SHAPE),
                          dtype=torch.float32, device=DEV)
    angles = np.linspace(0.0, np.pi, CT_ANGLES,
                         endpoint=False).astype(np.float32)
    A, A_T = make_projector(CT_SHAPE, angles, method="spectral")
    sino = A(vol)
    op_norm = float(estimate_op_norm(A, A_T, CT_SHAPE, device=DEV))
    ref = float(cp_reconstruct(sino, angles, CT_SHAPE, n_iter=30, reg=0.5,
                               cfg=TVConfig(**CT_CFG), op_norm=op_norm,
                               method="spectral").loss[-1])
    rel = abs(prod["recon_final_loss"] - ref) / abs(ref)
    require(rel <= 1e-6, f"bench_ct_production's final loss within 1e-6 of "
            f"a direct cp_reconstruct's {ref}, got {rel:.3g}")
    del vol, sino, A, A_T
    ct.clear_projector_cache()
    torch.cuda.empty_cache()
    log(f"[33 harness] ({card}) bench_ct_production's final loss "
        f"{prod['recon_final_loss']!r} against a direct cp_reconstruct's "
        f"{ref!r}: {rel:.3g} relative; {time.perf_counter() - t0:.1f} s")
    out = {}
    for name, got in launches.items():
        for kid, n in got.items():
            out.setdefault(kid, {})[name] = n
    return out


def main():
    card = phase_device()
    phase_build()
    errs = phase_kernels()
    launches = phase_main_path()
    phase_golden()
    kernel_ms = phase_throughput(card)
    phase_north_star()
    gd_errs = phase_gd_kernels()
    gd_launches = phase_gd_main_path()
    gd_ms = phase_gd_4d(card)
    phase_gd_north_star()
    tgv_errs = phase_tgv_kernels()
    tgv_launches = phase_tgv_main_path()
    tgv_ms = phase_tgv_rates(card)
    phase_tgv_north_star()
    inv_errs = phase_inverse_kernels()
    inv_launches = phase_inverse_main_path()
    op_norm, b5_ms, b5_bound = phase_ct_full_width(card)
    phase_ct_capacity(op_norm)
    res_errs = phase_resident_kernels()
    res_launches, res_ms, res_bounds = phase_resident_main_path(card)
    z_launches, z_errs, z_ms = phase_zstream(card)
    phase_solvers(card)
    halo_errs, halo_tv, halo_cp = phase_halo_kernels(card)
    (sh_launches, sh_gd_launches, sh_ms, sh_bounds,
     sh_modes) = phase_sharded_main_path(card)
    ct_launches = phase_ct_geometries(card)
    phase_compat(card)
    ct_launches.update(phase_ct_spectral(card))
    sharded = phase_sharded_slice(card)
    ct_launches["cone_zdft"] = phase_ct_zdft(card)
    on_grid = phase_grid_entry(card)
    on_grid_ct, b5_halo = phase_grid_ct(card)
    for kid, calls in on_grid_ct.items():
        on_grid.setdefault(kid, {}).update(calls)
    harness = phase_harness(card)

    # B1-B4 bounds at the shape their times were taken at: MAIN_4D float32,
    # hybrid with reg_time=0.5 (Nd channels).  Bytes: each array once per
    # pass (utils.profiling).  Operations per voxel, counted from the
    # sources: B1 about 10 per channel (difference, weights, dual update,
    # projection, TV partial) plus 10 for the fidelity dual and the norm;
    # B2 4 per channel plus 8; B3 4 per channel plus 4; B4 10 per channel
    # (two neighbour slots recomputed) plus 2.
    cfg = TVConfig(scheme="hybrid", reg_time=0.5)
    Nd = num_channels(cfg.scheme, MAIN_4D[0], MAIN_4D[1], cfg.reg_z_over_reg,
                      cfg.reg_time)
    vox = int(np.prod(MAIN_4D))
    tv_1, tv_2 = tv_traffic_model(MAIN_4D, torch.float32, cfg.norm)
    bounds = {"B1": bound((4 + 2 * Nd) * 4 * vox, (10 * Nd + 10) * vox),
              "B2": bound((4 + Nd) * 4 * vox, (4 * Nd + 8) * vox),
              "B3": bound(tv_1, (4 * Nd + 4) * vox),
              "B4": bound(tv_2, (10 * Nd + 2) * vox),
              "B5": b5_bound,  # (1 + 2 Nd) arrays, 10 operations a channel
              **tgv_ms["bounds"], **res_bounds, **sh_bounds,
              # on a z-shard of MAIN_4D, f32 (phase 24)
              **{kid: halo_tv[(kid, "z4 float32")]["bound"]
                 for kid in ("B3halo", "B4halo")},
              **{kid: halo_cp[(kid, "z4 f32")]["bound"]
                 for kid in SHARD_KERNELS}}
    bounds["B10"] = bounds["B1"]  # the byte model counts x once already
    require((4 + 2 * Nd + 4 + Nd) * 4 * vox == cp_traffic_model(
        MAIN_4D, Nd, dtype=torch.float32), "B1 + B2 bytes are the CP model's")

    def entry(kid, name, source, replaces, n_launches, err, ms, err_bf16=None,
              **extra):
        # no single PyTorch call computes any of these functions, so there
        # is no library time to set beside them
        out = {"name": f"{re.match(r'B[0-9]+', kid).group()} {name}",
               "route": "cuda",
               "source": f"pytv4d_tpu_torch/csrc/{source}",
               "replaces": f"pytv4d_tpu/kernels/{replaces}",
               "launches": n_launches, "max_abs_err": err, "ms": ms[0],
               "plain_ms": ms[1], "bound_ms": bounds[kid][0],
               "bound_by": bounds[kid][1], "library_ms": None}
        if replaces is None:
            out["replaces"] = None  # a kernel the JAX package has no twin of
        if err_bf16 is not None:
            out["max_abs_err_bf16"] = err_bf16
        out.update(extra)
        if kid in on_grid:
            # phase 31: the normal entry points handed a grid of shards
            out["launches_grid"] = on_grid[kid]
        if kid in harness:
            # phase 33: the benchmark harness's functions
            out["launches_harness"] = harness[kid]
        if kid in ("B2", "B3", "B5"):
            # the fan- and cone-beam cp_reconstruct path (phase 26), the
            # spectral path of each geometry (phase 28) and cp_inverse on
            # the z-DFT cone pair (phase 30)
            out["launches_ct_geometries"] = {
                name: got[kid] for name, got in ct_launches.items()}
        return out

    def at_shards(times, kid):
        # phase 24's times of a halo-mode kernel at each shard and storage,
        # each beside its own bound (bf16's counts half the bytes)
        return {key: {**{k: v for k, v in got.items() if k != "bound"},
                      "bound_ms": got["bound"][0],
                      "bound_by": got["bound"][1]}
                for (k_id, key), got in times.items() if k_id == kid}

    stream_ms = tgv_ms[("4d", "f32")]
    # every B3 and B4 launch on a grid is one of their halo mode; B1 and
    # B2's there are their sharded modes', counted as B1halo ... B2int
    grid_tv = {k: on_grid.pop(k) for k in ("B3", "B4") if k in on_grid}
    for kid in ("B1", "B2"):
        on_grid.pop(kid, None)
    kernels = [
        # phase 6: each also per launch in every storage pair, with its
        # device ms and its bound
        entry("B1", "cp_dual_spec_kernel (CP pass A, per channel table)",
              "specialised.cu", "fused.py:652", launches["B1"],
              errs["B1"]["f32"], kernel_ms["B1"], errs["B1"]["bf16"],
              at_storage=kernel_ms["at_storage"]["B1"]),
        entry("B2", "cp_primal_spec_kernel (CP pass B, per channel table)",
              "specialised.cu", "fused.py:859", launches["B2"],
              errs["B2"]["f32"], kernel_ms["B2"], errs["B2"]["bf16"],
              at_storage=kernel_ms["at_storage"]["B2"]),
        entry("B3", "tv_norms_spec_kernel (TV pass 1)", "specialised_tv.cu",
              "fused.py:1353", gd_launches["B3"], gd_errs["B3"]["f32"],
              gd_ms["f32"]["B3"], gd_errs["B3"]["bf16"]),
        entry("B4", "tv_subgrad_spec_kernel (TV pass 2)", "specialised.cu",
              "fused.py:1473", gd_launches["B4"], gd_errs["B4"]["f32"],
              gd_ms["f32"]["B4"], gd_errs["B4"]["bf16"]),
        entry("B5", "tv_dual_spec_kernel (CP pass A, inverse problems)",
              "specialised_tv.cu", "fused.py:759", inv_launches["B5"],
              inv_errs["f32"], b5_ms, inv_errs["bf16"],
              # phase 32: its halo mode, the kernel's HALO instance, on
              # one of 4 z-shards of the CT cell and over every table
              halo_mode=b5_halo),
        entry("B6pq", "tgv_pq_kernel (TGV pass PQ)", "tgv_stream.cu",
              "tgv_stream.py:344", tgv_launches["B6pq"],
              tgv_errs["B6pq"]["f32"], stream_ms["pq"],
              tgv_errs["B6pq"]["bf16"],
              launches_sharded=sharded["B6"]),
        entry("B6xw", "tgv_xw_kernel (TGV pass XW)", "tgv_stream.cu",
              "tgv_stream.py:435", tgv_launches["B6xw"],
              tgv_errs["B6xw"]["f32"], stream_ms["xw"],
              tgv_errs["B6xw"]["bf16"],
              launches_sharded=sharded["B6"]),
        # phase 12: against tgv_objective in float64, abs and rel; phase
        # 13: one launch an iteration of the users' 4d call
        entry("B6obj", "tgv_obj_kernel (TGV objective, one float partial a "
              "block)", "tgv_stream.cu", None, tgv_launches["B6obj"],
              tgv_errs["B6obj"]["f32"], stream_ms["obj"],
              tgv_errs["B6obj"]["bf16"],
              max_rel_err=tgv_errs["B6obj_rel"]["f32"],
              max_rel_err_bf16=tgv_errs["B6obj_rel"]["bf16"]),
        entry("B7", "tgv_onchip_kernel (2d TGV whole solve, each slice's "
              "state in its cluster's shared memory)", "tgv_onchip.cu",
              "tgv_resident.py:58", tgv_launches["B7"],
              tgv_errs["B7"]["f32"], tgv_ms["B7"],
              launches_sharded={"2d": sharded["B7"]}),
        entry("B7l2", "tgv_resident_kernel (2d TGV whole solve, the state in "
              "global memory: slices too large for the chip)",
              "tgv_resident.cu", "tgv_resident.py:58", tgv_launches["B7l2"],
              tgv_errs["B7l2"]["f32"], tgv_ms["B7l2"]),
        entry("B9cp", "reso_cp_kernel (CP whole solve, each band's state "
              "in shared memory, per channel table)", "resident_onchip.cu",
              "resident.py:50", res_launches["B9cp"], res_errs["B9cp"],
              res_ms["B9cp"]),
        entry("B9gd", "reso_gd_kernel (GD whole solve, each band's state "
              "in shared memory, per channel table)", "resident_onchip.cu",
              "resident.py:109", res_launches["B9gd"], res_errs["B9gd"],
              res_ms["B9gd"]),
        entry("B9cpl2", "resident_cp_kernel (CP whole solve, the state in "
              "global memory: volumes too large for the chip)",
              "resident.cu", "resident.py:50", res_launches["B9cpl2"],
              res_errs["B9cpl2"], res_ms["B9cpl2"]),
        entry("B9gdl2", "resident_gd_kernel (GD whole solve, the state in "
              "global memory: volumes too large for the chip)",
              "resident.cu", "resident.py:109", res_launches["B9gdl2"],
              res_errs["B9gdl2"], res_ms["B9gdl2"]),
        entry("B10", "zstream_spec_kernel (CP pass A marching along z, "
              "per channel table)", "cp_zstream.cu", "zstream.py:70",
              z_launches, z_errs["f32"], z_ms, z_errs["bf16"]),
        entry("B8dual", "bnd_dual_kernel (CP pass A, a shard's z-edge "
              "planes, per channel table)", "cp_boundary.cu", "fused.py:1093",
              sh_launches["B8dual"], halo_errs["B8dual"]["f32"],
              sh_ms["B8dual"], halo_errs["B8dual"]["bf16"]),
        entry("B8primal", "bnd_primal_kernel (CP pass B, a shard's "
              "z-edge planes, per channel table)", "cp_boundary.cu",
              "fused.py:1187",
              sh_launches["B8primal"], halo_errs["B8primal"]["f32"],
              sh_ms["B8primal"], halo_errs["B8primal"]["bf16"]),
        *(entry(kid, f"{kernel}, halo mode ({what} on a shard, per "
                "channel table)", source, replaces, sh_gd_launches[kid[:2]],
                halo_errs[kid]["f32"],
                (halo_tv[(kid, "z4 float32")]["ms"],
                 halo_tv[(kid, "z4 float32")]["plain_ms"]),
                halo_errs[kid]["bf16"],
                # phase 24: the kernel alone, and the other shards
                device_ms=halo_tv[(kid, "z4 float32")]["device_ms"],
                at_shards=at_shards(halo_tv, kid),
                # phases 31-32: the grid entry points
                launches_grid=grid_tv.get(kid[:2]))
          for kid, kernel, what, source, replaces in (
              ("B3halo", "tv_norms_spec_kernel", "TV pass 1",
               "specialised_tv.cu", "fused.py:1353"),
              ("B4halo", "tv_subgrad_spec_kernel", "TV pass 2",
               "specialised.cu", "fused.py:1473"))),
        *(entry(kid, f"{SHARD_KERNELS[kid]}, {mode} ({what} on a shard, "
                "per channel table)", "specialised_cp.cu", replaces,
                sh_modes[kid]["ghost z4" if mode == "halo mode"
                              else "overlap z4"], halo_errs[kid]["f32"],
                (halo_cp[(kid, "z4 f32")]["ms"],
                 halo_cp[(kid, "z4 f32")]["plain_ms"]),
                halo_errs[kid]["bf16"],
                # phase 24: the kernel alone, and the other shards
                device_ms=halo_cp[(kid, "z4 f32")]["device_ms"],
                at_shards=at_shards(halo_cp, kid),
                # phase 25: the ghost-plane and the overlapped step
                # (phases 31-32, the grid entry points: launches_grid)
                launches_sharded=sh_modes[kid])
          for kid, what, mode, replaces in (
              ("B1halo", "CP pass A", "halo mode", "fused.py:652"),
              ("B1int", "CP pass A", "interior", "fused.py:652"),
              ("B2halo", "CP pass B", "halo mode", "fused.py:859"),
              ("B2int", "CP pass B", "interior", "fused.py:859"))),
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
