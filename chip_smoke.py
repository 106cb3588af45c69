"""End-to-end check of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Builds the CP kernels (B1 pass A, B2 pass B) from ``pytv4d_tpu_torch/csrc``,
holds each against its plain PyTorch version, drives the port's main path
(``TVDenoiser.cp`` on the cameraman image) through the kernels, replays the
(16, 4, 512, 512) reference trajectory, measures the 4D CP rate of kernels
and plain versions, and runs the (96, 16, 512, 512) volume.  Every phase
raises on failure; nothing falls back to the CPU.  The last line of stdout
is one JSON object with ``"ok": true`` and the device.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from pytv4d_tpu_torch.core.config import TVConfig
from pytv4d_tpu_torch.core.schemes import SCHEMES, num_channels
from pytv4d_tpu_torch.kernels import build, fused
from pytv4d_tpu_torch.kernels.dispatch import t_plane_multiplier
from pytv4d_tpu_torch.models import TVDenoiser, add_noise
from pytv4d_tpu_torch.solvers.cp import chambolle_pock, default_tau
from pytv4d_tpu_torch.utils import cameraman, has_real_cameraman
from pytv4d_tpu_torch.utils.profiling import (
    cp_traffic_model,
    roofline_fraction,
    time_iterations,
)

ROOT = os.path.dirname(os.path.abspath(__file__))
DEV = torch.device("cuda", 0)

CAMERAMAN_LOSS = 38575639.48  # f64 reference, BASELINE.md
SMALL, MAIN_4D = (4, 3, 16, 128), (32, 8, 256, 256)
CAMERAMAN = (1, 1, 256, 256)  # what the main path launches the kernels on
NORTH_STAR = (96, 16, 512, 512)
# the scheme configs of the JAX package's kernel tests
CONFIGS = {"base": {}, "time": dict(reg_time=0.5),
           "zt": dict(reg_time=0.7, reg_z_over_reg=0.3),
           "noz": dict(reg_z_over_reg=0.0)}
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
BF16_RTOL = 2.0 ** -7
BF16_MAX_FLIPPED = 0.01


def log(msg):
    print(msg, flush=True)


def sync():
    torch.cuda.synchronize(DEV)


def require(cond, what):
    if not cond:
        raise RuntimeError(f"check failed: {what}")


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
def phase_build():
    t0 = time.perf_counter()
    path, seconds, compiler_log = build.build("cp_fused")
    fused._lib()  # load and bind
    usage = [ln.strip() for ln in compiler_log.splitlines()
             if "registers" in ln or "spill" in ln]
    log(f"[2 build] {os.path.relpath(path, ROOT)}: nvcc {seconds:.1f} s, "
        f"load {time.perf_counter() - t0 - seconds:.2f} s; ptxas: "
        + " | ".join(usage))
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
        for name, kw in CONFIGS.items():
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


def _compare(got, ref, bf16, scale):
    """Max |got - ref| after checking the tolerance stated above."""
    got, ref = got.float(), ref.float()
    err = (got - ref).abs()
    f32_bar = F32_TOL["atol"] + F32_TOL["rtol"] * ref.abs()
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
                f"f32 outputs within atol 2e-6 rtol 1e-5 (max err "
                f"{float(err.max()):.3g})")
    return float(err.max())


def phase_kernels():
    reg, sigma_D, sigma_A = 0.5, 0.5, 1.0
    errs = {"B1": {"f32": 0.0, "bf16": 0.0}, "B2": {"f32": 0.0, "bf16": 0.0}}
    n = 0
    for shape in (SMALL, CAMERAMAN, MAIN_4D):
        gen = torch.Generator(device=DEV).manual_seed(1234)
        for name, cfg, opts, storage in _cases():
            opts = dict(opts)
            use_tmul = opts.pop("tmul", False)
            nonneg = opts.pop("nonneg", False)
            fid_kw = dict(fidelity=opts.get("fidelity", "l2"),
                          fid_weight=opts.get("fid_weight", 1.0))
            tau = default_tau(cfg, shape[0], shape[1], sigma_A)
            x, x0, y_A, y_D = _state(shape, cfg, STORAGE[storage], gen,
                                     fid_kw["fidelity"])
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
                    tmul = tmul.float().contiguous()
            k = [t.clone() for t in (x, y_A, y_D)]
            p = [t.clone() for t in (x, y_A, y_D)]
            dual_kw = dict(cfg=cfg, sigma_D=sigma_D, sigma_A=sigma_A, reg=reg,
                           **fid_kw)
            prim_kw = dict(cfg=cfg, tau=tau, nonneg=nonneg, **fid_kw)
            _, _, tv_k = fused.cp_dual(k[0], x0, k[1], k[2], tmul, **dual_kw)
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
    log(f"[3 kernels vs plain] {n} cases at {SMALL}, {CAMERAMAN} and "
        f"{MAIN_4D}: pass; "
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
    fused.cp_dual.launches = 0
    fused.cp_primal.launches = 0
    res = TVDenoiser(reg=25).cp(noisy[0, 0], n_iter=300)
    sync()
    launches = {"B1": fused.cp_dual.launches, "B2": fused.cp_primal.launches}
    require(launches == {"B1": 300, "B2": 300},
            f"both kernels launched 300 times, got {launches}")
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
        if tag == "f32":
            r = _Run(noisy, cfg, d_dt, plain=False)
            args = (r.x, r.x0, r.y_A, r.y_D)
            kw = r.kw
            dk = dict(cfg=cfg, sigma_D=kw["sigma_D"], sigma_A=kw["sigma_A"],
                      reg=kw["reg"])
            pk = dict(cfg=cfg, tau=kw["tau"])
            kernel_ms["B1"] = (_time_launch(lambda: fused.cp_dual(*args, **dk)),
                               _time_launch(lambda: fused.cp_dual_plain(
                                   *args, **dk)))
            kernel_ms["B2"] = (_time_launch(
                lambda: fused.cp_primal(*args, **pk)),
                _time_launch(lambda: fused.cp_primal_plain(*args, **pk)))
            log(f"[6 per launch, f32 {MAIN_4D}] B1 {kernel_ms['B1'][0]:.3f} "
                f"ms (plain {kernel_ms['B1'][1]:.3f} ms), B2 "
                f"{kernel_ms['B2'][0]:.3f} ms (plain {kernel_ms['B2'][1]:.3f}"
                f" ms); card {card}")
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


def main():
    card = phase_device()
    phase_build()
    errs = phase_kernels()
    launches = phase_main_path()
    phase_golden()
    kernel_ms = phase_throughput(card)
    phase_north_star()
    source = "pytv4d_tpu_torch/csrc/cp_fused.cu"
    kernels = [
        {"name": "B1 cp_dual_kernel (CP pass A)", "route": "cuda",
         "source": source, "replaces": "pytv4d_tpu/kernels/fused.py:652",
         "launches": launches["B1"], "max_abs_err": errs["B1"]["f32"],
         "max_abs_err_bf16": errs["B1"]["bf16"], "ms": kernel_ms["B1"][0],
         "plain_ms": kernel_ms["B1"][1]},
        {"name": "B2 cp_primal_kernel (CP pass B)", "route": "cuda",
         "source": source, "replaces": "pytv4d_tpu/kernels/fused.py:859",
         "launches": launches["B2"], "max_abs_err": errs["B2"]["f32"],
         "max_abs_err_bf16": errs["B2"]["bf16"], "ms": kernel_ms["B2"][0],
         "plain_ms": kernel_ms["B2"][1]},
    ]
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
