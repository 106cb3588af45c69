"""The port imports without jax, and its copies of the stencil tables and
the config equal the JAX package's."""

import dataclasses
import math
import os
import subprocess
import sys

import pytest

import pytv4d_tpu.core.config as jcfg
import pytv4d_tpu.core.schemes as jsch
import pytv4d_tpu_torch.core.config as tcfg
import pytv4d_tpu_torch.core.schemes as tsch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REG_VARIANTS = [(1.0, 0.0), (0.3, 0.7), (0.0, 0.5), (2.0, 1.0),
                (float("nan"), 0.5)]


def test_import_leaves_jax_out():
    code = ("import sys, pytv4d_tpu_torch, pytv4d_tpu_torch.kernels.fused, "
            "pytv4d_tpu_torch.kernels.tgv_stream, "
            "pytv4d_tpu_torch.kernels.tgv_resident, "
            "pytv4d_tpu_torch.kernels.resident, "
            "pytv4d_tpu_torch.kernels.zstream, "
            "pytv4d_tpu_torch.solvers.admm, pytv4d_tpu_torch.solvers.fista, "
            "pytv4d_tpu_torch.solvers.state, "
            "pytv4d_tpu_torch.models.denoise, "
            "pytv4d_tpu_torch.solvers.tgv, pytv4d_tpu_torch.solvers.inverse, "
            "pytv4d_tpu_torch.models.ct, pytv4d_tpu_torch.utils.device, "
            "pytv4d_tpu_torch.utils.profiling, "
            "pytv4d_tpu_torch.parallel.mesh, pytv4d_tpu_torch.parallel.halo, "
            "pytv4d_tpu_torch.parallel.fused_halo, "
            "pytv4d_tpu_torch.parallel.tgv_sharded, "
            "pytv4d_tpu_torch.parallel.multihost, "
            "pytv4d_tpu_torch.utils.metrics, pytv4d_tpu_torch.utils.checks, "
            "pytv4d_tpu_torch.utils.runlog, "
            "pytv4d_tpu_torch.interop, pytv4d_tpu_torch.tv_CPU, "
            "pytv4d_tpu_torch.tv_operators_CPU, pytv4d_tpu_torch.testing, "
            "pytv4d_tpu_torch.tests, pytv4d_tpu_torch.bench; "
            "print(sorted(m for m in sys.modules "
            "if m == 'jax' or m.startswith('jax.') or "
            "m.startswith('pytv4d_tpu.') or m == 'pytv4d_tpu'))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_ct_spectral_import_leaves_jax_out():
    """The spectral CT module alone, in a fresh process, loads neither jax
    nor the JAX package."""
    code = ("import sys, pytv4d_tpu_torch.models.ct_spectral; print(sorted("
            "m for m in sys.modules if m == 'jax' or m.startswith('jax.') "
            "or m.startswith('pytv4d_tpu.') or m == 'pytv4d_tpu'))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


# the operator and TV entry points both package roots take from ops.api
API_NAMES = ("D", "D_T", "compute_L21_norm", "tv_and_subgrad",
             *(f"{base}_{scheme}" for base in ("D", "D_T", "tv")
               for scheme in jsch.SCHEMES))


@pytest.mark.parametrize("name", API_NAMES)
def test_root_takes_its_entry_points_from_ops_api(name):
    """As the JAX root does: the device-native entry points, which place a
    numpy input on the device and dispatch the fused TV kernels."""
    import pytv4d_tpu
    import pytv4d_tpu.ops.api as japi
    import pytv4d_tpu_torch
    import pytv4d_tpu_torch.ops.api as tapi

    assert len(API_NAMES) == 16
    assert getattr(pytv4d_tpu, name) is getattr(japi, name)
    assert getattr(pytv4d_tpu_torch, name) is getattr(tapi, name)


def test_parallel_names_match_the_jax_package():
    """What the JAX root re-exports of mesh, halo, fused_halo, tgv_sharded
    and multihost, the port's ``parallel`` has (a spec is a tuple of mesh
    axis names there, a sharding a mesh and a spec; ``internal_d_sharding``
    has no counterpart: the port's duals shard like volumes)."""
    import pytv4d_tpu.parallel as jpar
    import pytv4d_tpu_torch
    import pytv4d_tpu_torch.parallel as tpar

    assert pytv4d_tpu_torch.parallel is tpar
    for name in ("Z_AXIS", "T_AXIS", "make_mesh", "shard_volume", "sharded_D",
                 "sharded_D_T", "sharded_tv_and_subgrad", "sharded_cp_step",
                 "make_sharded_cp_solver", "make_sharded_cp_solver_fused",
                 "make_sharded_gd_solver_fused", "tgv_denoise_sharded",
                 "make_sharded_tgv_stream_solver", "multihost", "tgv_sharded",
                 "volume_spec", "d_volume_spec", "volume_sharding",
                 "d_volume_sharding"):
        assert hasattr(jpar, name) and hasattr(tpar, name), name
    assert (tpar.Z_AXIS, tpar.T_AXIS) == (jpar.Z_AXIS, jpar.T_AXIS)
    for shard_time in (True, False):
        assert tpar.volume_spec(shard_time) == tuple(
            jpar.volume_spec(shard_time))
        assert tpar.d_volume_spec(shard_time) == tuple(
            jpar.d_volume_spec(shard_time))
    for name in ("cluster_configured", "initialize", "global_mesh",
                 "host_local_to_global", "global_to_host_local"):
        assert callable(getattr(tpar.multihost, name)), name


def _table(mod, scheme, Nz, M, rz, rt):
    chans, norm = mod.scheme_channels(scheme, Nz, M, rz, rt)
    return ([(c.axis, c.kind, c.weight, mod.channel_weight(c, rz, rt))
             for c in chans], norm, mod.num_channels(scheme, Nz, M, rz, rt),
            mod.operator_norm_bound_sq(scheme, Nz, M, rz, rt))


@pytest.mark.parametrize("scheme", jsch.SCHEMES)
def test_scheme_tables_equal(scheme):
    assert tsch.SCHEMES == jsch.SCHEMES
    for name in ("AXIS_Z", "AXIS_T", "AXIS_ROW", "AXIS_COL", "FWD", "BWD",
                 "CTR"):
        assert getattr(tsch, name) == getattr(jsch, name)
    for Nz in (1, 2, 3):
        for M in (1, 2, 3):
            for rz, rt in REG_VARIANTS:
                assert _table(tsch, scheme, Nz, M, rz, rt) == \
                    _table(jsch, scheme, Nz, M, rz, rt), (Nz, M, rz, rt)


def test_unknown_scheme_message_equal():
    with pytest.raises(ValueError) as a:
        tsch.scheme_channels("nope", 2, 2)
    with pytest.raises(ValueError) as b:
        jsch.scheme_channels("nope", 2, 2)
    assert str(a.value) == str(b.value)


def test_config_fields_and_validation_equal():
    assert [f.name for f in dataclasses.fields(tcfg.TVConfig)] == \
        [f.name for f in dataclasses.fields(jcfg.TVConfig)]
    assert dataclasses.asdict(tcfg.TVConfig()) == \
        dataclasses.asdict(jcfg.TVConfig())
    kw = dict(scheme="central", reg_z_over_reg=0.3, reg_time=0.7,
              factor_reg_static=0.2, norm="huber", huber_delta=0.4)
    assert tcfg.TVConfig(**kw).kwargs() == jcfg.TVConfig(**kw).kwargs()
    for bad in (dict(scheme="x"), dict(norm="l3"),
                dict(norm="huber", huber_delta=0.0)):
        with pytest.raises(ValueError) as a:
            tcfg.TVConfig(**bad)
        with pytest.raises(ValueError) as b:
            jcfg.TVConfig(**bad)
        assert str(a.value) == str(b.value)
    assert math.isnan(tcfg.TVConfig(reg_z_over_reg=float("nan")).reg_z_over_reg)
