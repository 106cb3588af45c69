"""The port's sharded TGV-2 (``parallel.tgv_sharded``) against the JAX
package's unsharded ``tgv_denoise`` in float64: twins of
``tests/test_sharding.py``'s ``test_tgv_sharded_2d_slot_exact``,
``test_tgv_stream_sharded`` and ``test_tgv_sharded_norm_family``.  On the
CPU the kernel wrappers take their plain versions."""

import functools
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytv4d_tpu.solvers.tgv import tgv_denoise as j_tgv_denoise
from pytv4d_tpu_torch.parallel import (
    gather_d_volume,
    gather_volume,
    make_mesh,
    make_sharded_tgv_stream_solver,
    shard_volume,
    tgv_denoise_sharded,
)

TOL = dict(rtol=1e-12, atol=1e-12)  # the JAX tests' float64 bar
KW = dict(alpha1=2.0, alpha0=4.0)


@functools.lru_cache(maxsize=None)
def _jax_ref(seed, shape, axes, n_iter, scale=1.0, alphas=(2.0, 4.0),
             norm="iso", huber_delta=1.0, coupled_kw=True):
    """The input and JAX's unsharded solve of it (the stream solver's
    reference runs with no loss and on the plain loop, as in the JAX
    test)."""
    x = np.random.default_rng(seed).random(shape) * scale
    extra = dict(compute_loss=False, fused=False) if coupled_kw else {}
    ref = j_tgv_denoise(jnp.asarray(x), n_iter=n_iter, axes=axes, norm=norm,
                        huber_delta=huber_delta, alpha1=alphas[0],
                        alpha0=alphas[1], **extra)
    return x, np.asarray(ref.x), np.asarray(ref.w), np.asarray(ref.loss)


def _cpu_mesh(z, t=1):
    return make_mesh(z, t, device="cpu")


@pytest.mark.parametrize("fused", [False, True])
def test_tgv_sharded_2d_slot_exact(fused):
    x, rx, rw, rloss = _jax_ref(41, (8, 4, 12, 16), "2d", 15,
                                coupled_kw=False)
    mesh = _cpu_mesh(4, 2)
    res = tgv_denoise_sharded(shard_volume(x, mesh), mesh, n_iter=15,
                              fused=fused, **KW)
    np.testing.assert_allclose(gather_volume(res.x).numpy(), rx, **TOL)
    np.testing.assert_allclose(gather_d_volume(res.w).numpy(), rw, **TOL)
    np.testing.assert_allclose(res.loss.numpy(), rloss, rtol=1e-12)
    assert len(res.x) == 4 and len(res.x[0]) == 2
    assert tuple(res.w[0][0].shape) == (2, 2, 2, 12, 16)


def test_tgv_sharded_2d_lean_and_pure_z_mesh():
    x, rx, _, _ = _jax_ref(41, (8, 4, 12, 16), "2d", 15, coupled_kw=False)
    mesh = _cpu_mesh(4, 2)
    lean = tgv_denoise_sharded(shard_volume(x, mesh), mesh, n_iter=15,
                               compute_loss=False, **KW)
    np.testing.assert_allclose(gather_volume(lean.x).numpy(), rx, **TOL)
    assert tuple(lean.loss.shape) == (0,)
    # a pure-z mesh turns time sharding off
    mesh_z = _cpu_mesh(4)
    res = tgv_denoise_sharded(shard_volume(x, mesh_z), mesh_z, n_iter=15,
                              **KW)
    np.testing.assert_allclose(gather_volume(res.x).numpy(), rx, **TOL)


@pytest.mark.parametrize("axes", ["3d", "4d"])
@pytest.mark.parametrize("z,overlap", [(2, False), (4, False), (8, False),
                                       (2, True)])
def test_tgv_stream_sharded(axes, z, overlap):
    """Ghost-plane halos and the global-edge corrections on 4-, 2- and
    1-plane shards, and the overlapped step (forced) on 4-plane shards."""
    x, rx, rw, _ = _jax_ref(47, (8, 2, 16, 16), axes, 12)
    mesh = _cpu_mesh(z)
    solve = make_sharded_tgv_stream_solver(mesh, x.shape, axes, n_iter=12,
                                           dtype="float64", overlap=overlap,
                                           **KW)
    assert solve.overlap is overlap
    res = solve(shard_volume(x, mesh))
    np.testing.assert_allclose(gather_volume(res.x).numpy(), rx, **TOL)
    np.testing.assert_allclose(gather_d_volume(res.w).numpy(), rw, **TOL)
    assert tuple(res.loss.shape) == (0,)


@pytest.mark.parametrize("axes", ["3d", "4d"])
def test_tgv_stream_bf16_overlap_equals_ghost(axes):
    """In bf16 the window kernels round at the same places as the extended
    kernel, so the two step structures stay bit-equal."""
    x = np.random.default_rng(47).random((8, 2, 16, 16)).astype(np.float32)
    mesh = _cpu_mesh(2)
    outs = []
    for overlap in (True, False):
        solve = make_sharded_tgv_stream_solver(
            mesh, x.shape, axes, n_iter=6, dtype="bfloat16", overlap=overlap,
            **KW)
        res = solve(shard_volume(x, mesh))
        outs.append((gather_volume(res.x), gather_d_volume(res.w)))
    assert outs[0][0].dtype == outs[1][1].dtype == torch.bfloat16
    assert bool((outs[0][0] == outs[1][0]).all())
    assert bool((outs[0][1] == outs[1][1]).all())


def test_tgv_stream_3d_shards_time_too():
    """'3d' does not couple time: a (z, t) mesh shards it as a batch axis."""
    x, rx, rw, _ = _jax_ref(47, (8, 2, 16, 16), "3d", 12)
    mesh = _cpu_mesh(4, 2)
    solve = make_sharded_tgv_stream_solver(mesh, x.shape, "3d", n_iter=12,
                                           dtype="float64", **KW)
    res = solve(shard_volume(x, mesh))
    assert len(res.x[0]) == 2
    np.testing.assert_allclose(gather_volume(res.x).numpy(), rx, **TOL)
    np.testing.assert_allclose(gather_d_volume(res.w).numpy(), rw, **TOL)


def test_tgv_stream_sharded_errors():
    shape = (8, 2, 16, 16)
    with pytest.raises(ValueError, match="3 local z"):
        make_sharded_tgv_stream_solver(_cpu_mesh(4), shape, "3d", n_iter=2,
                                       overlap=True, **KW)
    with pytest.raises(ValueError, match="z-only"):
        make_sharded_tgv_stream_solver(_cpu_mesh(4, 2), shape, "4d",
                                       n_iter=5, **KW)
    with pytest.raises(ValueError, match="axes='2d' shards with zero"):
        make_sharded_tgv_stream_solver(_cpu_mesh(4), shape, "2d", n_iter=5,
                                       **KW)
    no_z = types.SimpleNamespace(shape={"t": 2})
    with pytest.raises(ValueError, match="must have a 'z' axis"):
        make_sharded_tgv_stream_solver(no_z, shape, "3d", n_iter=5, **KW)
    with pytest.raises(ValueError, match="norm"):
        make_sharded_tgv_stream_solver(_cpu_mesh(4), shape, "3d", n_iter=2,
                                       norm="l1", **KW)
    with pytest.raises(ValueError, match="not divisible"):
        make_sharded_tgv_stream_solver(_cpu_mesh(3), shape, "3d", n_iter=2,
                                       **KW)
    with pytest.raises(ValueError, match="grid of shards"):
        make_sharded_tgv_stream_solver(_cpu_mesh(4), shape, "3d", n_iter=2,
                                       **KW)(shard_volume(
                                           np.zeros(shape), _cpu_mesh(2)))


@pytest.mark.parametrize("norm,kw", [("aniso", {}),
                                     ("huber", {"huber_delta": 0.1})])
def test_tgv_sharded_norm_family(norm, kw):
    """aniso / Huber TGV through both sharded paths: the exchange-free 2d
    solve on a (4, 2) mesh and the ghost-plane 3d stream solver on 4
    z-shards."""
    delta = kw.get("huber_delta", 1.0)
    ref_kw = dict(scale=4.0, alphas=(1.0, 2.0), norm=norm,
                  huber_delta=delta)
    x, rx2, _, _ = _jax_ref(53, (8, 2, 16, 16), "2d", 10, coupled_kw=False,
                            **ref_kw)
    _, rx3, _, _ = _jax_ref(53, (8, 2, 16, 16), "3d", 10, **ref_kw)
    mesh = _cpu_mesh(4, 2)
    res2 = tgv_denoise_sharded(shard_volume(x, mesh), mesh, n_iter=10,
                               alpha1=1.0, alpha0=2.0, norm=norm, **kw)
    np.testing.assert_allclose(gather_volume(res2.x).numpy(), rx2, **TOL)
    mesh_z = _cpu_mesh(4)
    solve = make_sharded_tgv_stream_solver(
        mesh_z, x.shape, "3d", alpha1=1.0, alpha0=2.0, n_iter=10,
        dtype="float64", norm=norm, **kw)
    res3 = solve(shard_volume(x, mesh_z, shard_time=False))
    np.testing.assert_allclose(gather_volume(res3.x).numpy(), rx3, **TOL)
