"""The port's sharded CT solve: ``cp_reconstruct`` of a sinogram placed with
``sinogram_sharding`` / ``cone_sinogram_sharding`` against the JAX
package's unsharded solve (float64: the losses within the JAX tests' 1e-5)
and against the port's own unsharded solve in float32.  Twins of
``tests/test_sharding.py``'s ``test_sharded_ct_reconstruction``,
``test_sharded_cone_ct_reconstruction`` and
``test_sharded_spectral_cone_ct_reconstruction``, and of
``tests/test_ct_spectral.py``'s
``test_spectral_sharded_reconstruction_tracks_unsharded``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytv4d_tpu.models.ct as jct
from pytv4d_tpu.core.config import TVConfig as JConfig
from pytv4d_tpu_torch.core.config import TVConfig
from pytv4d_tpu_torch.models.ct import (
    ConeBeamGeometry,
    cone_sinogram_sharding,
    cp_reconstruct,
    radon,
    radon_cone,
    sinogram_sharding,
)
from pytv4d_tpu_torch.models.ct_spectral import radon_spectral
from pytv4d_tpu_torch.parallel import gather_volume, grid_mesh, make_mesh, shard
from pytv4d_tpu_torch.utils import synthetic_phantom

LOSS_RTOL = 1e-5                 # the JAX sharded tests' bar
X_TOL = dict(atol=1e-5, rtol=1e-4)
CONE = ConeBeamGeometry(source_dist=40.0, det_dist=20.0)
CONE_CFG = dict(scheme="hybrid", reg_time=0.5)


@pytest.fixture(autouse=True)
def _one_thread():
    """A sharded solve is many small ops a shard: on a loaded machine
    torch's intra-op threads spend their time waiting for each other (30x
    slower under six test workers), one thread does not."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _parallel_truth():
    truth2d = synthetic_phantom(24) / 255.0
    truth = np.stack([np.roll(truth2d, z, axis=0) for z in range(8)])[:, None]
    return np.tile(truth, (1, 2, 1, 1))  # (8, 2, 24, 24)


def _cone_truth(seed):
    rng = np.random.default_rng(seed)
    truth = np.zeros((6, 4, 16, 16))
    truth[2:5, :, 5:12, 5:12] = 1.0
    return truth + 0.05 * rng.standard_normal(truth.shape)


def _check(sharded, ref_loss, ref_x, x_tol=X_TOL):
    np.testing.assert_allclose(sharded.loss.numpy(), np.asarray(ref_loss),
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(gather_volume(sharded.x).numpy(),
                               np.asarray(ref_x), **x_tol)


def _solve_both(sino, angles, shape, sharding, **kw):
    """The port's sharded solve in float64 and float32, and its unsharded
    solve in float32."""
    out = {}
    for dt in (torch.float64, torch.float32):
        s = sino.to(dt)
        out[dt] = cp_reconstruct(shard(s, sharding), angles, shape, **kw)
    return out, cp_reconstruct(sino.float(), angles, shape, **kw)


@pytest.mark.parametrize("shard_time", [True, False])
def test_sharded_ct_reconstruction(shard_time):
    """Parallel beam, gather projector, on a (4, 2) mesh: the projector per
    shard with no exchange, the TV halos and the loss sum across shards."""
    truth = _parallel_truth()
    angles = np.linspace(0, np.pi, 16, endpoint=False)
    sino = radon(torch.tensor(truth), angles)
    kw = dict(n_iter=30, reg=0.02, op_norm=24.0)
    ref = jct.cp_reconstruct(jnp.asarray(sino.numpy()), angles, truth.shape,
                             **kw)
    mesh = make_mesh(4, 2, device="cpu")
    sharding = sinogram_sharding(mesh, shard_time)
    assert sharding.spec == ("z", "t" if shard_time else None, None, None)
    got, alone = _solve_both(sino, angles, truth.shape, sharding, **kw)
    assert len(got[torch.float64].x[0]) == (2 if shard_time else 1)
    _check(got[torch.float64], ref.loss, ref.x)
    _check(got[torch.float32], alone.loss, alone.x)


def test_sinogram_grid_gives_its_mesh():
    """``cp_reconstruct`` and ``cp_inverse_grid`` read the mesh off the
    sinogram grid (``parallel.mesh.grid_mesh``): on a (2, 2) mesh the solve
    is the gathered sinogram's (float64, 1e-10), and ``x`` comes back as a
    grid whose layout is the volume's."""
    truth = _parallel_truth()[:4]
    angles = np.linspace(0, np.pi, 8, endpoint=False)
    sino = radon(torch.tensor(truth), angles)
    kw = dict(n_iter=5, reg=0.02, op_norm=24.0)
    whole = cp_reconstruct(sino, angles, truth.shape, **kw)
    got = cp_reconstruct(shard(sino, sinogram_sharding(make_mesh(
        2, 2, device="cpu"))), angles, truth.shape, **kw)
    lay = grid_mesh(got.x)
    assert lay.mesh.shape == {"z": 2, "t": 2} and lay.shard_time
    assert lay.shape == truth.shape
    np.testing.assert_allclose(got.loss.numpy(), whole.loss.numpy(),
                               rtol=1e-10)
    np.testing.assert_allclose(gather_volume(got.x).numpy(),
                               whole.x.numpy(), rtol=1e-10, atol=1e-12)


def test_sharded_ct_estimates_the_norm_on_the_grid():
    truth = _parallel_truth()
    angles = np.linspace(0, np.pi, 16, endpoint=False)
    sino = radon(torch.tensor(truth), angles)
    kw = dict(n_iter=5, reg=0.02)
    ref = jct.cp_reconstruct(jnp.asarray(sino.numpy()), angles, truth.shape,
                             **kw)
    got = cp_reconstruct(shard(sino, sinogram_sharding(make_mesh(
        4, 2, device="cpu"))), angles, truth.shape, **kw)
    _check(got, ref.loss, ref.x)


@pytest.mark.parametrize("method", ["gather", "spectral"])
def test_sharded_cone_ct_reconstruction(method):
    """The cone couples z, so its sinogram is cut along t only (a (1, 4)
    mesh); the spectral cone (SSRB with the slope correction) batches over
    t in every stage, so it shards the same way."""
    truth = _cone_truth(51 if method == "gather" else 57)
    angles = np.linspace(0, 2 * np.pi, 12, endpoint=False)
    sino = radon_cone(torch.tensor(truth), angles, CONE, n_det_v=12)
    kw = dict(n_iter=20, reg=0.01, geom=CONE, op_norm=30.0,
              method=method)
    ref = jct.cp_reconstruct(
        jnp.asarray(sino.numpy()), angles, truth.shape,
        geom=jct.ConeBeamGeometry(source_dist=40.0, det_dist=20.0),
        cfg=JConfig(**CONE_CFG), **{k: v for k, v in kw.items()
                                    if k != "geom"})
    mesh = make_mesh(1, 4, device="cpu")
    got, alone = _solve_both(sino, angles, truth.shape,
                             cone_sinogram_sharding(mesh),
                             cfg=TVConfig(**CONE_CFG), **kw)
    assert len(got[torch.float64].x) == 1
    assert len(got[torch.float64].x[0]) == 4
    _check(got[torch.float64], ref.loss, ref.x)
    _check(got[torch.float32], alone.loss, alone.x)


def test_spectral_sharded_reconstruction_tracks_unsharded():
    rng = np.random.default_rng(2)
    vol_shape = (8, 2, 24, 24)
    truth = torch.tensor(rng.random(vol_shape))
    angles = np.linspace(0, np.pi, 12, endpoint=False)
    sino = radon_spectral(truth, angles)
    kw = dict(n_iter=25, reg=0.02, op_norm=24.0, method="spectral")
    ref = jct.cp_reconstruct(jnp.asarray(sino.numpy()), angles, vol_shape,
                             **kw)
    got, alone = _solve_both(sino, angles, vol_shape, sinogram_sharding(
        make_mesh(4, 2, device="cpu")), **kw)
    _check(got[torch.float64], ref.loss, ref.x, dict(atol=1e-6, rtol=1e-5))
    _check(got[torch.float32], alone.loss, alone.x,
           dict(atol=1e-6, rtol=1e-5))


def test_sharded_ct_errors():
    """What a sinogram grid cannot serve raises: a cone mesh without a t
    cut, a cone sinogram cut along z.  What raised before ROADMAP.md item
    A19 (``fused=True``, ``precond``, ``dual_dtype``, an array
    ``fidelity_weight``) now runs on the (4, 2) grid and holds to the same
    call on the whole f32 sinogram at the JAX bars."""
    with pytest.raises(ValueError, match="sharded 't' axis"):
        cone_sinogram_sharding(make_mesh(4, 1, device="cpu"))
    truth = _parallel_truth()
    angles = np.linspace(0, np.pi, 16, endpoint=False)
    sino = radon(torch.tensor(truth, dtype=torch.float32), angles)
    grid = shard(sino, sinogram_sharding(make_mesh(4, 2, device="cpu")))
    weight = np.random.default_rng(4).random(sino.shape) + 0.5
    for more in (dict(fused=True, op_norm=24.0), dict(precond=True),
                 dict(dual_dtype="bfloat16", op_norm=24.0),
                 dict(fidelity_weight=weight, op_norm=24.0)):
        got = cp_reconstruct(grid, angles, truth.shape, n_iter=2, **more)
        _check(got, *cp_reconstruct(sino, angles, truth.shape, n_iter=2,
                                    **more)[1::-1])
    # a cone sinogram cut along z is refused: the cone couples z
    cone = radon_cone(torch.tensor(_cone_truth(51)), np.linspace(
        0, 2 * np.pi, 12, endpoint=False), CONE, n_det_v=12)
    with pytest.raises(ValueError, match="cut along t only"):
        cp_reconstruct([[cone[:2]], [cone[2:]]], np.linspace(
            0, 2 * np.pi, 12, endpoint=False), (6, 4, 16, 16), geom=CONE,
            n_iter=2, op_norm=30.0)
