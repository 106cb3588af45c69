"""The port's benchmark harness (``pytv4d_tpu_torch.bench``) against the JAX
package's (``pytv4d_tpu.bench``) on the CPU: a twin of
``tests/test_sharding.py``'s ``test_weak_scaling_harness_runs``, the solve
each sweep times against the JAX harness's own on 2 virtual devices, the
keys of every dict, the traffic model behind ``est_gb_per_s``, the final CT
losses, and the failures that must raise."""

import ast
import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytv4d_tpu.bench.harness as jharness
import pytv4d_tpu.parallel as jpar
import pytv4d_tpu_torch.bench.harness as harness
from pytv4d_tpu.core.config import TVConfig as JConfig
from pytv4d_tpu.core.schemes import num_channels as j_num_channels
from pytv4d_tpu.models.ct import ConeBeamGeometry as JConeGeometry
from pytv4d_tpu.models.ct import cp_reconstruct as j_cp_reconstruct
from pytv4d_tpu.models.ct import estimate_op_norm as j_estimate_op_norm
from pytv4d_tpu.models.ct_spectral import (
    make_cone_spectral_projector as j_make_cone_spectral_projector,
)
from pytv4d_tpu.utils.profiling import cp_traffic_model as j_cp_traffic_model
from pytv4d_tpu_torch.bench import (
    bench_ct,
    bench_ct_cone,
    bench_solver,
    weak_scaling,
    weak_scaling_tgv,
)
from pytv4d_tpu_torch.parallel import gather_volume, make_mesh

SWEEP = dict(base_shape=(2, 2, 16, 16), n_iter=3, repeats=1)
SWEEP_TOL = dict(atol=1e-5, rtol=1e-4)  # tests/test_sharding.py:596
LOSS_RTOL = 1e-5
CT_ARGS = dict(vol_shape=(2, 2, 32, 32), n_angles=8, n_iter=3, repeats=1)
# the JAX harness returns all its keys here; below n_subsets = 8 angles its
# SART fails and it drops that key
CONE_ARGS = dict(vol_shape=(2, 2, 16, 16), n_angles=8, n_iter=3, repeats=1)


def test_weak_scaling_harness_runs():
    """Twin of tests/test_sharding.py:169, as shards on the CPU."""
    res = weak_scaling(device_counts=[1, 2, 4], device="cpu", **SWEEP)
    assert set(res) == {1, 2, 4}
    for n, row in res.items():
        assert row["it_per_s"] > 0 and np.isfinite(row["efficiency"])

    res = weak_scaling_tgv(device_counts=[1, 2, 4], device="cpu", **SWEEP)
    assert set(res) == {1, 2, 4}
    for n, row in res.items():
        assert row["it_per_s"] > 0 and np.isfinite(row["efficiency"])


def _captured_build(module, sweep, monkeypatch, **kw):
    """The ``build(mesh, shape)`` that ``module``'s ``sweep`` hands its
    scaffold, caught in place of running the sweep."""
    got = []
    monkeypatch.setattr(module, "_weak_scaling_sweep",
                        lambda make, *args: got.append(make) or {})
    getattr(module, sweep)(device_counts=[2], **SWEEP, **kw)
    return got[0]


@pytest.mark.parametrize("sweep", ["weak_scaling", "weak_scaling_tgv"])
def test_sweep_solve_matches_jax(sweep, monkeypatch):
    """The solve each sweep times at n = 2: the port's (2 shards on the CPU)
    against the JAX harness's (2 virtual devices), from the same seed."""
    shape = (4,) + SWEEP["base_shape"][1:]
    build = _captured_build(harness, sweep, monkeypatch, device="cpu")
    solve, args = build(make_mesh(2, device="cpu"), shape)
    out = solve(*args)
    j_build = _captured_build(jharness, sweep, monkeypatch)
    j_solve, j_args = j_build(jpar.make_mesh(z=2, t=1,
                                             devices=jax.devices()[:2]), shape)
    j_out = j_solve(*j_args)
    if sweep == "weak_scaling":
        got, want = out[0], j_out[0]
    else:
        got, want = out.x, j_out.x
    assert len(got) == 2
    np.testing.assert_allclose(gather_volume(got).numpy(), np.asarray(want),
                               **SWEEP_TOL)


def test_bench_solver_keys_and_traffic():
    shape = (2, 2, 16, 16)
    res = bench_solver(shape, n_iter=3, repeats=1, device="cpu")
    j_res = jharness.bench_solver(shape, n_iter=3, repeats=1)
    assert set(res) == set(j_res)
    cfg = JConfig(scheme="hybrid", reg_time=0.5)
    traffic = j_cp_traffic_model(shape, j_num_channels(
        cfg.scheme, shape[0], shape[1], cfg.reg_z_over_reg, cfg.reg_time))
    assert res["est_gb_per_s"] == traffic * res["it_per_s"] / 1e9
    assert all(v > 0 and np.isfinite(v) for v in res.values())


def test_bench_ct_matches_jax():
    res = bench_ct(device="cpu", **CT_ARGS)
    j_res = jharness.bench_ct(**CT_ARGS)
    assert set(res) == set(j_res)
    np.testing.assert_allclose(res["recon_final_loss"],
                               j_res["recon_final_loss"], rtol=LOSS_RTOL)
    assert all(v > 0 and np.isfinite(v) for v in res.values())


def _jax_cone_keys():
    """The keys of the JAX ``bench_ct_cone``'s dict, read from its source:
    the returned literal's and those its ``extras`` gains (a call at this
    size takes over 15 s of jit on the CPU)."""
    tree = ast.parse(inspect.getsource(jharness.bench_ct_cone).lstrip())
    keys = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Return) and isinstance(node.value, ast.Dict):
            keys |= {k.value for k in node.value.keys if k is not None}
        if isinstance(node, ast.Subscript) and isinstance(
                node.ctx, ast.Store) and node.value.id == "extras":
            keys.add(node.slice.value)
    return keys


def test_bench_ct_cone_matches_jax():
    """Both extras are present; the final loss against a direct JAX
    ``cp_reconstruct(geom=cone, method='spectral')`` of the harness's
    seeded inputs with the JAX harness's operator norm (the whole JAX
    harness call costs over 10 s of jit on the CPU)."""
    res = bench_ct_cone(device="cpu", **CONE_ARGS)
    assert set(res) == _jax_cone_keys()
    assert {"cone_fdk_s", "cone_sart_epochs_per_s"} <= set(res)
    assert all(v > 0 and np.isfinite(v) for v in res.values())

    shape, n_angles = CONE_ARGS["vol_shape"], CONE_ARGS["n_angles"]
    N = shape[-1]
    geom = JConeGeometry(source_dist=2.0 * N, det_dist=1.0 * N)
    vol = jnp.asarray(np.random.default_rng(0).random(shape), jnp.float32)
    angles = np.linspace(0.0, 2 * np.pi, n_angles, endpoint=False)
    A, A_T = j_make_cone_spectral_projector(shape, angles, geom)
    op_norm = float(j_estimate_op_norm(A, A_T, shape))
    ref = j_cp_reconstruct(A(vol), angles, shape,
                           n_iter=CONE_ARGS["n_iter"], reg=0.5,
                           cfg=JConfig(scheme="hybrid", reg_time=0.5),
                           geom=geom, op_norm=op_norm, method="spectral")
    np.testing.assert_allclose(res["cone_recon_final_loss"],
                               float(ref.loss[-1]), rtol=LOSS_RTOL)


@pytest.mark.parametrize("part", ["fdk", "sart"])
def test_bench_ct_cone_raises_on_a_failing_extra(part, monkeypatch):
    """Where the JAX harness drops the key silently, the port raises."""
    def fail(*args, **kwargs):
        raise FloatingPointError(f"{part} failed")

    monkeypatch.setattr(harness, part, fail)
    with pytest.raises(FloatingPointError, match=f"{part} failed"):
        bench_ct_cone(vol_shape=(2, 2, 16, 16), n_angles=8, n_iter=1,
                      repeats=1, device="cpu")


def test_no_device_raises_and_cpu_counts_one(monkeypatch):
    """Without a CUDA device every function asks for one; on the CPU the
    sweeps' default is one shard."""
    res = weak_scaling(device="cpu", **SWEEP)
    assert set(res) == {1} and res[1]["efficiency"] == 1.0
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = [lambda: bench_solver((2, 2, 16, 16), n_iter=1, repeats=1),
             lambda: weak_scaling(**SWEEP),
             lambda: weak_scaling_tgv(**SWEEP),
             lambda: bench_ct(**CT_ARGS),
             lambda: harness.bench_ct_production(n_iter=1, repeats=1),
             lambda: bench_ct_cone(**CONE_ARGS)]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()
