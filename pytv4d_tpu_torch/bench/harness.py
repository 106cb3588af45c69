"""Benchmark harness: solver throughput, the sharding sweeps and CT
throughput (the port of ``pytv4d_tpu/bench/harness.py``, with its function
names, signatures and dict keys).

Every function measures the CUDA device unless ``device`` names another
(``device="cpu"`` runs it on the CPU, as the tests do); without a CUDA
device and with no ``device`` it raises ``RuntimeError``.  Its inputs are
made from a seed with numpy, as the JAX package's are.

Timing is the JAX harness's: the host clock around a whole call, ended by a
``utils.profiling.force_read`` of its output, the best of ``repeats`` after
one warm-up call where the JAX harness makes one.  A rate is therefore the
call as a user sees it, set-up included, not the device time of its kernels.
``roofline_fraction`` is taken against the H100's HBM rate
(``utils.profiling.H100_HBM_PEAK_GBPS``).

The sweeps' ``device_counts`` are shard counts: the port's mesh puts all of
a process's shards on its one device (``parallel``), so on one card the
sweep's ``efficiency`` is the cost of sharding, not weak scaling across
cards.  By default they are the JAX rule's counts up to the number of
devices: ``torch.cuda.device_count()`` on the card, 1 on the CPU.
"""

from __future__ import annotations

import functools
import time
from typing import Dict

import numpy as np
import torch

from ..core.config import TVConfig
from ..core.schemes import num_channels
from ..kernels.dispatch import as_dtype
from ..models.ct import (
    ConeBeamGeometry,
    _resolve_method,
    cp_reconstruct,
    estimate_op_norm,
    fdk,
    make_projector,
    sart,
)
from ..models.ct_spectral import make_cone_spectral_projector
from ..parallel import (
    make_mesh,
    make_sharded_cp_solver,
    make_sharded_tgv_stream_solver,
    shard_d_volume,
    shard_volume,
)
from ..solvers.cp import chambolle_pock, init_state
from ..utils.profiling import cp_traffic_model, force_read, roofline_fraction


def _device(device) -> torch.device:
    """Where a harness call runs: ``device``, else the CUDA device."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "the harness measures the CUDA device, and none is "
                "available; pass device='cpu' to run it on the CPU")
        device = "cuda"
    return torch.device(device)


def _uniform(rng, shape, dtype, device):
    """``rng.random(shape)`` as ``dtype`` on ``device``."""
    return torch.as_tensor(rng.random(shape)).to(device=device, dtype=dtype)


def _best_of(fn, repeats: int):
    """``(seconds, output)``: the least host-clock time of ``repeats`` calls
    of ``fn``, each ended by a :func:`force_read` of what it returns, and
    the last call's output."""
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = fn()
        force_read(out)
        best = min(best, time.perf_counter() - t0)
    return best, out


def bench_solver(shape=(32, 8, 256, 256), n_iter=50, repeats=3,
                 cfg: TVConfig = TVConfig(scheme="hybrid", reg_time=0.5),
                 device=None, **solver_kwargs) -> Dict[str, float]:
    """Steady-state CP throughput of ``chambolle_pock`` (the fused step
    where ``kernels.dispatch.can_fuse`` takes it); ``solver_kwargs`` go to
    it (``dual_dtype``, ...)."""
    rng = np.random.default_rng(0)
    noisy = _uniform(rng, shape, torch.float32, _device(device))

    def run():
        res = chambolle_pock(noisy, n_iter=n_iter, reg=1.0, cfg=cfg,
                             **solver_kwargs)
        return res.x, res.loss

    force_read(run())
    it_s = n_iter / _best_of(run, repeats)[0]
    nd = num_channels(cfg.scheme, shape[0], shape[1], cfg.reg_z_over_reg,
                      cfg.reg_time)
    traffic = cp_traffic_model(shape, nd)
    return {
        "it_per_s": it_s,
        "gvox_it_per_s": it_s * float(np.prod(shape)) / 1e9,
        "est_gb_per_s": traffic * it_s / 1e9,
        "roofline_fraction": roofline_fraction(traffic, it_s),
    }


def _weak_scaling_sweep(make_solve_and_args, base_shape, n_iter, repeats,
                        device_counts, device) -> Dict[int, Dict[str, float]]:
    """Shared sweep scaffold: the volume a shard holds stays constant while
    z grows with the shard count; efficiency(n) = it/s(n) / it/s(first) —
    1.0 is perfect scaling."""
    device = _device(device)
    if device_counts is None:
        n_dev = torch.cuda.device_count() if device.type == "cuda" else 1
        device_counts = [n for n in (1, 2, 4, 8, 16, 32) if n <= n_dev]
    results: Dict[int, Dict[str, float]] = {}
    for n in device_counts:
        mesh = make_mesh(z=n, t=1, device=device)
        shape = (base_shape[0] * n,) + tuple(base_shape[1:])
        solve, args = make_solve_and_args(mesh, shape)
        force_read(solve(*args))
        results[n] = {"it_per_s": n_iter / _best_of(lambda: solve(*args),
                                                     repeats)[0]}
    base = results[device_counts[0]]["it_per_s"]
    for n in device_counts:
        results[n]["efficiency"] = results[n]["it_per_s"] / base
    return results


def _build_cp(rng, cfg, n_iter, mesh, shape):
    """The sharded CP sweep's solve at one mesh: the plain halo solver
    (``parallel.halo``) and its cold-start arguments."""
    noisy = _uniform(rng, shape, torch.float32, mesh.device)
    solve = make_sharded_cp_solver(mesh, cfg, shape, reg=1.0, n_iter=n_iter,
                                   shard_time=False)
    st = init_state(noisy, cfg)
    args = (
        shard_volume(noisy, mesh, shard_time=False),
        shard_volume(st.x, mesh, shard_time=False),
        shard_volume(st.y_A, mesh, shard_time=False),
        shard_d_volume(st.y_D, mesh, shard_time=False),
    )
    return solve, args


def weak_scaling(base_shape=(8, 2, 128, 128), n_iter=20, repeats=3,
                 device_counts=None,
                 cfg: TVConfig = TVConfig(scheme="hybrid", reg_time=0.5),
                 device=None) -> Dict[int, Dict[str, float]]:
    """Sharding sweep of the plain halo-exchange CP solver."""
    build = functools.partial(_build_cp, np.random.default_rng(0), cfg,
                              n_iter)
    return _weak_scaling_sweep(build, base_shape, n_iter, repeats,
                               device_counts, device)


def _build_tgv(rng, axes, dtype, alpha1, alpha0, n_iter, mesh, shape):
    """The sharded TGV sweep's solve at one mesh: the streaming solver
    (``parallel.tgv_sharded``, ghost planes) and its input."""
    x = _uniform(rng, shape, as_dtype(dtype), mesh.device)
    solve = make_sharded_tgv_stream_solver(
        mesh, shape, axes, alpha1=alpha1, alpha0=alpha0, n_iter=n_iter,
        dtype=dtype, shard_time=False)
    return solve, (shard_volume(x, mesh, shard_time=False),)


def weak_scaling_tgv(base_shape=(8, 2, 128, 128), n_iter=20, repeats=3,
                     device_counts=None, axes="4d", dtype="float32",
                     alpha1=1.0, alpha0=2.0,
                     device=None) -> Dict[int, Dict[str, float]]:
    """Sharding sweep of the sharded streaming TGV solver
    (``parallel.make_sharded_tgv_stream_solver``)."""
    build = functools.partial(_build_tgv, np.random.default_rng(0), axes,
                              dtype, alpha1, alpha0, n_iter)
    return _weak_scaling_sweep(build, base_shape, n_iter, repeats,
                               device_counts, device)


def _normal_rate(A, A_T, x, repeats, n_scan=15):
    """Applications/s of the normal operator: ``n_scan`` steps of
    ``x <- x + 1e-6 A^T(A x)`` in one timed call (the JAX harness's
    ``lax.scan``), after one warm-up call."""
    def run():
        v = x
        for _ in range(n_scan):
            v = v + 1e-6 * A_T(A(v))
        return v

    force_read(run())
    return n_scan / _best_of(run, repeats)[0]


def bench_ct(vol_shape=(8, 2, 256, 256), n_angles=48, n_iter=30,
             repeats=3, reg=0.5,
             cfg: TVConfig = TVConfig(scheme="hybrid", reg_time=0.5),
             seed=0, method: str = "auto", device=None) -> Dict[str, float]:
    """Parallel-beam CT throughput: the forward projection, its exact
    adjoint, the normal operator and the TV-regularized ``cp_reconstruct``
    loop.  One projection is one (z, t, angle) line-integral set.
    ``method`` as in ``models.ct.make_projector``: ``'auto'`` is the
    spectral pair on a CUDA device, the gather pair on the CPU."""
    device = _device(device)
    rng = np.random.default_rng(seed)
    Nz, M = vol_shape[:2]
    vol = _uniform(rng, vol_shape, torch.float32, device)
    angles = np.linspace(0.0, np.pi, n_angles,
                         endpoint=False).astype(np.float32)
    n_proj = Nz * M * n_angles
    method = _resolve_method(method, "parallel", device)

    A, A_T = make_projector(vol_shape, angles, method=method)
    sino = A(vol)
    force_read(sino)
    t_A = _best_of(lambda: A(vol), repeats)[0]
    t_AT = _best_of(lambda: A_T(sino), repeats)[0]
    normal = _normal_rate(A, A_T, vol, repeats)

    # the operator norm is fixed once, so that the timed calls do not
    # repeat the power method
    op_norm = float(estimate_op_norm(A, A_T, vol_shape, device=device))

    def run():
        return cp_reconstruct(sino, angles, vol_shape, n_iter=n_iter,
                              reg=reg, cfg=cfg, op_norm=op_norm,
                              method=method).loss

    force_read(run())
    best, loss = _best_of(run, repeats)

    return {
        "radon_proj_per_s": n_proj / t_A,
        "radon_s": t_A,
        "adjoint_proj_per_s": n_proj / t_AT,
        "adjoint_s": t_AT,
        "normal_op_scan_it_per_s": normal,
        "recon_it_per_s": n_iter / best,
        "recon_final_loss": float(loss[-1]),
    }


def bench_ct_production(n_iter=30, repeats=3,
                        device=None) -> Dict[str, float]:
    """:func:`bench_ct` at the production dynamic-CT scale,
    (16, 4, 512, 512) x 96 angles, on the spectral projector."""
    return bench_ct(vol_shape=(16, 4, 512, 512), n_angles=96,
                    n_iter=n_iter, repeats=repeats, method="spectral",
                    device=device)


def bench_ct_cone(vol_shape=(16, 4, 512, 512), n_angles=96, n_iter=30,
                  repeats=3, reg=0.5,
                  cfg: TVConfig = TVConfig(scheme="hybrid", reg_time=0.5),
                  seed=0, source_dist_mult=2.0,
                  precision=None, device=None) -> Dict[str, float]:
    """Cone-beam CT throughput on the spectral (SSRB) projector over a full
    orbit: forward, exact adjoint (``A.apply_T``, written out), the normal
    operator, ``cp_reconstruct(geom=cone, method='spectral')``, ``fdk``
    (``cone_fdk_s``) and five epochs of spectral OS-SART
    (``cone_sart_epochs_per_s``).  One projection is one (t, angle, v)
    detector row.  A failure of any part raises."""
    device = _device(device)
    rng = np.random.default_rng(seed)
    Nz, M, N, _ = vol_shape
    geom = ConeBeamGeometry(source_dist=source_dist_mult * N,
                            det_dist=1.0 * N)
    vol = _uniform(rng, vol_shape, torch.float32, device)
    angles = np.linspace(0.0, 2 * np.pi, n_angles, endpoint=False)
    n_proj = M * n_angles * Nz

    A, A_T = make_cone_spectral_projector(vol_shape, angles, geom,
                                          precision=precision)
    sino = A(vol)
    force_read(sino)
    t_A = _best_of(lambda: A(vol), repeats)[0]
    t_AT = _best_of(lambda: A_T(sino), repeats)[0]

    consts = A.prepare()
    op_norm = float(estimate_op_norm(A, A_T, vol_shape, device=device))
    normal = _normal_rate(functools.partial(A.apply, consts),
                          functools.partial(A.apply_T, consts), vol, repeats)

    def run():
        return cp_reconstruct(sino, angles, vol_shape, n_iter=n_iter,
                              reg=reg, cfg=cfg, geom=geom, op_norm=op_norm,
                              method="spectral", precision=precision).loss

    force_read(run())
    best, loss = _best_of(run, repeats)

    # the rebinning FDK ('auto': spectral on the card) and one block of
    # spectral OS-SART epochs; unlike the JAX harness, a failure here raises
    force_read(fdk(sino, angles, geom, vol_shape))
    t_fdk = _best_of(lambda: fdk(sino, angles, geom, vol_shape),
                     repeats)[0]

    def sart_run():
        return sart(sino, angles, vol_shape, n_iter=5, n_subsets=8,
                    method="spectral", geom=geom).x

    force_read(sart_run())
    t_sart = _best_of(sart_run, 1)[0]

    return {
        "cone_fwd_proj_per_s": n_proj / t_A,
        "cone_fwd_s": t_A,
        "cone_adjoint_proj_per_s": n_proj / t_AT,
        "cone_adjoint_s": t_AT,
        "cone_normal_op_scan_it_per_s": normal,
        "cone_recon_it_per_s": n_iter / best,
        "cone_recon_final_loss": float(loss[-1]),
        "cone_fdk_s": t_fdk,
        "cone_sart_epochs_per_s": 5 / t_sart,
    }
