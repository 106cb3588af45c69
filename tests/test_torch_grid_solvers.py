"""The port's remaining solver entry points on a grid of shards against the
JAX package's whole-volume calls (float64, the CPU; the JAX package's
solvers take a sharded array and GSPMD partitions them, at the tolerances
of ``tests/test_sharding.py:141``): ``chambolle_pock_precond`` (each
shard's step maps from its place in the volume), ``run_until_converged``
(its test's scalars summed over shards) and ``run_checkpointed`` (a
checkpoint written from a grid holds the whole arrays, resumes on a volume
and loads with the JAX package's ``load_state``), and the five
``TVDenoiser`` methods, each on 4 z-shards and on a (2 x 2) grid."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytv4d_tpu.solvers.cp as jcp
import pytv4d_tpu.solvers.state as jstate
from pytv4d_tpu.core.config import TVConfig as JConfig
from pytv4d_tpu.models import TVDenoiser as JDenoiser
from pytv4d_tpu_torch import TVConfig
from pytv4d_tpu_torch.models import TVDenoiser
from pytv4d_tpu_torch.parallel import (
    gather_d_volume,
    gather_volume,
    is_grid,
    make_mesh,
    shard_volume,
)
from pytv4d_tpu_torch.solvers import chambolle_pock, chambolle_pock_precond
from pytv4d_tpu_torch.solvers.cp import CPPrecondState, CPState
from pytv4d_tpu_torch.solvers.state import (
    load_state,
    run_checkpointed,
    run_until_converged,
)

CFG = dict(scheme="hybrid", reg_time=0.5)
MESHES = {"z4": (4, 1), "2x2": (2, 2)}
TOL = dict(rtol=1e-10, atol=1e-12)


@pytest.fixture(autouse=True)
def _one_thread():
    """A grid is many small ops a shard: one intra-op thread does not wait
    for others under several test workers."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _noisy(shape=(8, 2, 12, 12), seed=37):
    return np.random.default_rng(seed).random(shape) + 5.0


def _grid(x, mesh):
    z, t = MESHES[mesh]
    return shard_volume(torch.as_tensor(x), make_mesh(z, t, device="cpu"),
                        t > 1)


def _np(grid, d=False):
    return (gather_d_volume(grid) if d else gather_volume(grid)).numpy()


@pytest.mark.parametrize("mesh", MESHES)
def test_chambolle_pock_precond_on_a_grid(mesh):
    """15 preconditioned iterations on the grid against the JAX package's
    whole solve (1e-10), then 5 more from the grid's state on the whole
    volume against 20 uninterrupted."""
    noisy = _noisy()
    kw = dict(reg=0.4, sigma_A=1.0)
    ref = jcp.chambolle_pock_precond(jnp.asarray(noisy), n_iter=15,
                                     cfg=JConfig(**CFG), **kw)
    got = chambolle_pock_precond(_grid(noisy, mesh), n_iter=15,
                                 cfg=TVConfig(**CFG), **kw)
    assert is_grid(got.x) and isinstance(got.state, CPPrecondState)
    np.testing.assert_allclose(got.loss.numpy(), np.asarray(ref.loss),
                               rtol=1e-10)
    np.testing.assert_allclose(_np(got.x), np.asarray(ref.x), **TOL)
    whole = CPPrecondState(_np(got.state.x), _np(got.state.x_bar),
                           _np(got.state.y_A), _np(got.state.y_D, True))
    more = chambolle_pock_precond(torch.tensor(noisy), n_iter=5,
                                  cfg=TVConfig(**CFG), state=tuple(
                                      torch.tensor(a) for a in whole), **kw)
    twenty = chambolle_pock_precond(torch.tensor(noisy), n_iter=20,
                                    cfg=TVConfig(**CFG), **kw)
    np.testing.assert_allclose(more.x.numpy(), twenty.x.numpy(), **TOL)


@pytest.mark.parametrize("criterion", ["loss", "gap"])
def test_run_until_converged_on_a_grid(criterion):
    """The grid stops after the chunk the whole volume stops after, the
    port's and the JAX package's, with their losses (1e-10); ``'gap'``
    takes ``pd_gap`` summed over shards."""
    noisy = _noisy() - 5.0
    kw = dict(tol=1e-3 if criterion == "gap" else 3e-3, chunk=10,
              max_iter=60, criterion=criterion, reg=0.1,
              cfg=TVConfig(**CFG))
    want = run_until_converged(chambolle_pock, torch.tensor(noisy), **kw)
    got = run_until_converged(chambolle_pock, _grid(noisy, "2x2"), **kw)
    assert len(got.loss) == len(want.loss) < 60
    np.testing.assert_allclose(got.loss.numpy(), want.loss.numpy(),
                               rtol=1e-10)
    np.testing.assert_allclose(_np(got.x), want.x.numpy(), **TOL)
    ref = jstate.run_until_converged(jcp.chambolle_pock, jnp.asarray(noisy),
                                     **dict(kw, cfg=JConfig(**CFG)))
    assert len(np.asarray(ref.loss)) == len(got.loss)
    np.testing.assert_allclose(got.loss.numpy(), np.asarray(ref.loss),
                               rtol=1e-10)
    np.testing.assert_allclose(_np(got.x), np.asarray(ref.x), **TOL)


def test_checkpoint_of_a_grid_resumes_on_a_volume(tmp_path):
    """A checkpoint written from a grid holds the whole arrays under a
    volume's keys: the JAX package's ``load_state`` reads it, the whole
    volume resumes from it, and a volume's checkpoint resumes on the grid;
    both equal the uninterrupted run, the port's and so the JAX package's
    (1e-10)."""
    noisy = _noisy()
    kw = dict(reg=0.4, cfg=TVConfig(**CFG))
    full = chambolle_pock(torch.tensor(noisy), n_iter=20, **kw)
    ref = jcp.chambolle_pock(jnp.asarray(noisy), n_iter=20, reg=0.4,
                             cfg=JConfig(**CFG))
    np.testing.assert_allclose(full.x.numpy(), np.asarray(ref.x), **TOL)
    path = str(tmp_path / "grid.npz")
    run_checkpointed(chambolle_pock, _grid(noisy, "z4"), 10, path, 5, **kw)
    like = CPState(torch.zeros(noisy.shape, dtype=torch.float64),
                   torch.zeros(noisy.shape, dtype=torch.float64),
                   torch.zeros((8, 7, 2, 12, 12), dtype=torch.float64))
    st = load_state(path, like)
    jst = jstate.load_state(path, jcp.CPState(*(jnp.asarray(a.numpy())
                                                for a in like)))
    for a, b in zip(st, jst):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    on_volume = run_checkpointed(chambolle_pock, torch.tensor(noisy), 20,
                                 path, 5, **kw)
    np.testing.assert_allclose(on_volume.x.numpy(), full.x.numpy(), **TOL)
    np.testing.assert_allclose(on_volume.loss.numpy(), full.loss.numpy(),
                               rtol=1e-10)
    path = str(tmp_path / "volume.npz")
    run_checkpointed(chambolle_pock, torch.tensor(noisy), 10, path, 5, **kw)
    on_grid = run_checkpointed(chambolle_pock, _grid(noisy, "2x2"), 20,
                               path, 5, **kw)
    assert is_grid(on_grid.x)
    np.testing.assert_allclose(_np(on_grid.x), full.x.numpy(), **TOL)


METHODS = {"cp": dict(n_iter=15), "gd": dict(n_iter=15, step_size=1e-2),
           "tgv": dict(n_iter=10), "admm": dict(n_iter=5),
           "fista": dict(n_iter=10)}


@pytest.mark.parametrize("method", METHODS)
@pytest.mark.parametrize("mesh", MESHES)
def test_denoiser_methods_on_a_grid(method, mesh):
    """``TVDenoiser(reg=0.4)``'s five methods on a grid of a 4D volume
    against the JAX package's whole call (1e-10; ADMM's CG 1e-8, as
    ``tests/test_sharding.py:141``): a grid back, the loss one tensor."""
    noisy = _noisy()
    kw = METHODS[method]
    ref = getattr(JDenoiser(reg=0.4, cfg=JConfig(**CFG)), method)(
        jnp.asarray(noisy), **kw)
    got = getattr(TVDenoiser(reg=0.4, cfg=TVConfig(**CFG)), method)(
        _grid(noisy, mesh), **kw)
    assert is_grid(got.x)
    rtol = 1e-8 if method == "admm" else 1e-10
    np.testing.assert_allclose(got.loss.numpy(), np.asarray(ref.loss),
                               rtol=rtol)
    np.testing.assert_allclose(_np(got.x), np.asarray(ref.x), rtol=rtol,
                               atol=1e-10)


def test_denoiser_device_and_partial_solver():
    """A ``device`` naming another than the shards' raises for a grid, and
    ``run_until_converged`` of a ``functools.partial`` solver takes one."""
    grid = _grid(_noisy(), "z4")
    with pytest.raises(ValueError, match="not moved"):
        TVDenoiser().cp(grid, n_iter=1, device="cuda")
    solver = functools.partial(chambolle_pock, reg=0.4)
    res = run_until_converged(solver, grid, chunk=5, max_iter=10)
    assert is_grid(res.x) and len(res.loss) <= 10
