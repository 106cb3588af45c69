"""The port's normal entry points on a grid of shards against the JAX
package's on the whole volume (float64, the CPU): twins of
``tests/test_sharding.py``'s ``test_gspmd_auto_sharding_matches``,
``test_gspmd_full_solvers_sharded`` and ``test_tgv_gspmd_3d_4d``, where
the JAX entry points take a sharded array and GSPMD partitions the call,
at their shapes, meshes, seeds and tolerances.  Besides: FISTA, ``'2d'``
TGV and a CP resumed from a JAX ``CPState`` cut with ``shard_volume`` /
``shard_d_volume``; ``D``, ``D_T``, ``compute_L21_norm`` and
``tv_and_subgrad`` with plane masks; the fused kernels' plain versions
behind ``fused=True`` on float32 grids; the entry points that took a grid
last (``chambolle_pock_precond``, ``run_until_converged``,
``run_checkpointed``, the ``TVDenoiser`` methods, ``tgv_reconstruct``,
``sart``, ``fdk``, ``fbp``) against their gathered calls; and the
``ValueError`` of what a grid cannot serve."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytv4d_tpu as jptv
import pytv4d_tpu.solvers as jsolvers
from pytv4d_tpu.core.config import TVConfig as JConfig
from pytv4d_tpu.solvers.cp import CPState as JCPState
from pytv4d_tpu_torch import TVConfig
from pytv4d_tpu_torch import ops
from pytv4d_tpu_torch.models import TVDenoiser
from pytv4d_tpu_torch.models.ct import (
    ConeBeamGeometry,
    fbp,
    fdk,
    sart,
    tgv_reconstruct,
)
from pytv4d_tpu_torch.parallel import (
    gather_d_volume,
    gather_volume,
    is_grid,
    make_mesh,
    shard_d_volume,
    shard_volume,
)
from pytv4d_tpu_torch.parallel import tgv_sharded
from pytv4d_tpu_torch.solvers import (
    CPState,
    admm,
    chambolle_pock,
    chambolle_pock_precond,
    fista,
    subgradient_descent,
    tgv_denoise,
)
from pytv4d_tpu_torch.solvers.state import run_checkpointed, run_until_converged

CFG = dict(scheme="hybrid", reg_time=0.5)
TGV_KW = dict(n_iter=15, alpha1=2.0, alpha0=4.0)


@pytest.fixture(autouse=True)
def _one_thread():
    """A grid is many small ops a shard: one intra-op thread does not wait
    for others under several test workers."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _mesh(z, t=1):
    return make_mesh(z, t, device="cpu")


def _z8(x):
    return shard_volume(torch.as_tensor(x), _mesh(8), shard_time=False)


def _np(grid, d=False):
    return (gather_d_volume(grid) if d else gather_volume(grid)).numpy()


def test_tv_and_subgrad_on_a_grid():
    """``test_gspmd_auto_sharding_matches``: tv at 1e-12, G at 1e-11."""
    img = np.random.default_rng(36).random((8, 2, 16, 16))
    tv_l, G_l = jptv.tv_and_subgrad(jnp.asarray(img), "hybrid")
    tv_s, G_s = ops.api.tv_and_subgrad(_z8(img), "hybrid")
    assert is_grid(G_s) and len(G_s) == 8
    assert float(tv_s) == pytest.approx(float(tv_l), rel=1e-12)
    np.testing.assert_allclose(_np(G_s), np.asarray(G_l), rtol=1e-11)


@functools.lru_cache(maxsize=None)
def _noisy37():
    return np.random.default_rng(37).random((8, 2, 16, 16)) + 5.0


@functools.lru_cache(maxsize=None)
def _jax_solver_loss(name):
    noisy, cfg = jnp.asarray(_noisy37()), JConfig(**CFG)
    if name == "cp":
        res = jsolvers.chambolle_pock(noisy, n_iter=15, reg=0.4, cfg=cfg)
    elif name == "gd":
        res = jsolvers.subgradient_descent(noisy, n_iter=15, reg=0.4,
                                           step_size=1e-2, cfg=cfg)
    elif name == "admm":
        res = jsolvers.admm(noisy, n_iter=8, reg=0.4, cfg=cfg)
    else:
        res = jsolvers.fista(noisy, n_iter=15, reg=0.4, cfg=cfg)
    return np.asarray(res.loss), np.asarray(res.x)


@pytest.mark.parametrize("name,rtol", [("cp", 1e-10), ("gd", 1e-10),
                                       ("admm", 1e-8), ("fista", 1e-10)])
def test_full_solvers_on_a_grid(name, rtol):
    """``test_gspmd_full_solvers_sharded`` (CP, GD, ADMM at its bars) and
    FISTA at CP's: the losses of the whole solve on a z = 8 grid."""
    grid, cfg = _z8(_noisy37()), TVConfig(**CFG)
    if name == "cp":
        res = chambolle_pock(grid, n_iter=15, reg=0.4, cfg=cfg)
    elif name == "gd":
        res = subgradient_descent(grid, n_iter=15, reg=0.4, step_size=1e-2,
                                  cfg=cfg)
    elif name == "admm":
        res = admm(grid, n_iter=8, reg=0.4, cfg=cfg)
    else:
        res = fista(grid, n_iter=15, reg=0.4, cfg=cfg)
    want_loss, want_x = _jax_solver_loss(name)
    assert is_grid(res.x) and res.loss.dtype == torch.float64
    np.testing.assert_allclose(res.loss.numpy(), want_loss, rtol=rtol)
    np.testing.assert_allclose(_np(res.x), want_x, rtol=rtol, atol=1e-12)


@functools.lru_cache(maxsize=None)
def _tgv_ref(axes):
    x = np.random.default_rng(42).random((8, 4, 12, 16))
    ref = jsolvers.tgv_denoise(jnp.asarray(x), axes=axes, **TGV_KW)
    return x, np.asarray(ref.x), np.asarray(ref.w), np.asarray(ref.loss)


@pytest.mark.parametrize("axes", ["2d", "3d", "4d"])
def test_tgv_on_a_grid(axes):
    """``test_tgv_gspmd_3d_4d`` on a (4 x 2) grid (and ``'2d'``): x and the
    loss at 1e-12.  ``'4d'`` cuts time here: the plain grid loop."""
    x, rx, rw, rloss = _tgv_ref(axes)
    res = tgv_denoise(shard_volume(x, _mesh(4, 2)), axes=axes, **TGV_KW)
    np.testing.assert_allclose(_np(res.x), rx, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(_np(res.w, d=True), rw, rtol=1e-12,
                               atol=1e-12)
    np.testing.assert_allclose(res.loss.numpy(), rloss, rtol=1e-12)
    assert is_grid(res.state.p) and len(res.state.q[0]) == 2


@pytest.mark.parametrize("axes", ["3d", "4d"])
def test_tgv_stream_path_on_a_z_grid(axes):
    """On a z-only grid ``fused=True`` takes the sharded streaming solver
    (the kernels' plain versions on the CPU), sampling the loss and
    resuming from its state: the JAX package's unsharded solve."""
    x, rx, _, rloss = _tgv_ref(axes)
    grid = shard_volume(x, _mesh(4), shard_time=False)
    kw = dict(TGV_KW, axes=axes, compute_loss=False, fused=True)
    whole = tgv_denoise(grid, loss_every=5, **kw)
    np.testing.assert_allclose(_np(whole.x), rx, rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(whole.loss.numpy(), rloss[4::5], rtol=1e-12)
    first = tgv_denoise(grid, **dict(kw, n_iter=10))
    rest = tgv_denoise(grid, state=first.state, **dict(kw, n_iter=5))
    np.testing.assert_allclose(_np(rest.x), rx, rtol=1e-12, atol=1e-12)
    assert rest.loss.shape == (0,)


@pytest.mark.parametrize("axes", ["3d", "4d"])
def test_tgv_per_iteration_loss_streams_on_a_z_grid(axes, monkeypatch):
    """On a z-only grid the per-iteration loss (``compute_loss=True``,
    ``loss_every=0``) with ``fused=True`` takes the sharded streaming
    solver, sampling its objective every iteration: x and every loss the
    JAX package's unsharded solve at 1e-12."""
    made = []
    real = tgv_sharded.make_sharded_tgv_stream_solver

    def spy(*args, **kw):
        made.append(kw["loss_every"])
        return real(*args, **kw)

    monkeypatch.setattr(tgv_sharded, "make_sharded_tgv_stream_solver", spy)
    x, rx, _, rloss = _tgv_ref(axes)
    grid = shard_volume(x, _mesh(4), shard_time=False)
    res = tgv_denoise(grid, axes=axes, compute_loss=True, loss_every=0,
                      fused=True, **TGV_KW)
    assert made == [1]
    np.testing.assert_allclose(_np(res.x), rx, rtol=1e-12, atol=1e-12)
    assert res.loss.shape == (TGV_KW["n_iter"],)
    assert res.loss.dtype == torch.float64
    np.testing.assert_allclose(res.loss.numpy(), rloss, rtol=1e-12)


def test_cp_resumes_from_a_jax_state_on_a_grid():
    """A JAX ``CPState`` after 8 iterations, cut with ``shard_volume`` /
    ``shard_d_volume`` on a (4 x 2) grid, resumes for 7 more: the JAX
    package's resumed unsharded solve, losses and x at 1e-10."""
    noisy = np.random.default_rng(35).random((8, 4, 16, 16)) + 10.0
    jcfg = JConfig(**CFG)
    first = jsolvers.chambolle_pock(jnp.asarray(noisy), n_iter=8, reg=0.5,
                                    cfg=jcfg)
    want = jsolvers.chambolle_pock(jnp.asarray(noisy), n_iter=7, reg=0.5,
                                   cfg=jcfg, state=JCPState(*first.state))
    mesh = _mesh(4, 2)
    st = CPState(*(shard_volume(np.array(a), mesh)
                   for a in (first.state.x, first.state.y_A)),
                 shard_d_volume(np.array(first.state.y_D), mesh))
    got = chambolle_pock(shard_volume(noisy, mesh), n_iter=7, reg=0.5,
                         cfg=TVConfig(**CFG), state=st)
    np.testing.assert_allclose(got.loss.numpy(), np.asarray(want.loss),
                               rtol=1e-10)
    np.testing.assert_allclose(_np(got.x), np.asarray(want.x), rtol=1e-10,
                               atol=1e-12)
    np.testing.assert_allclose(_np(got.state.y_D, d=True),
                               np.asarray(want.state.y_D), rtol=1e-10,
                               atol=1e-12)


@functools.lru_cache(maxsize=None)
def _masked():
    rng = np.random.default_rng(31)
    img = rng.random((8, 4, 16, 16))
    kw = dict(reg_time=0.5, reg_z_over_reg=0.7,
              mask_static=rng.random((1, 1, 16, 16)) > 0.5,
              factor_reg_static=0.3, weight_time=rng.random((1, 1, 16, 16)))
    return img, kw


@pytest.mark.parametrize("norm", ["iso", "aniso", "huber"])
def test_operators_with_plane_masks_on_a_grid(norm):
    """``D``, ``D_T``, ``compute_L21_norm`` and ``tv_and_subgrad`` with a
    static mask and a weight plane, on a (4 x 2) grid, against the JAX
    package's on the whole volume (1e-12)."""
    img, kw = _masked()
    mesh = _mesh(4, 2)
    grid = shard_volume(img, mesh)
    d_l = np.asarray(jptv.D(jnp.asarray(img), "hybrid", **kw))
    d_s = ops.api.D(grid, "hybrid", **kw)
    np.testing.assert_allclose(_np(d_s, d=True), d_l, rtol=1e-12,
                               atol=1e-12)
    y = np.random.default_rng(32).random(d_l.shape)
    np.testing.assert_allclose(
        _np(ops.api.D_T(shard_d_volume(y, mesh), "hybrid", **kw)),
        np.asarray(jptv.D_T(jnp.asarray(y), "hybrid", **kw)), rtol=1e-12,
        atol=1e-12)
    assert float(ops.api.compute_L21_norm(d_s)) == pytest.approx(
        float(jptv.compute_L21_norm(jnp.asarray(d_l))), rel=1e-12)
    tv_l, G_l, n_l = jptv.tv_and_subgrad(jnp.asarray(img), "hybrid",
                                         norm_type=norm,
                                         return_grad_norms=True, **kw)
    tv_s, G_s, n_s = ops.api.tv_and_subgrad(grid, "hybrid", norm_type=norm,
                                            return_grad_norms=True, **kw)
    assert float(tv_s) == pytest.approx(float(tv_l), rel=1e-12)
    np.testing.assert_allclose(_np(G_s), np.asarray(G_l), rtol=1e-11,
                               atol=1e-12)
    np.testing.assert_allclose(_np(n_s), np.asarray(n_l), rtol=1e-12)


@pytest.mark.parametrize("solver", ["cp", "cp_bf16_dual", "gd", "tv"])
def test_fused_true_on_a_float32_grid(solver):
    """``fused=True`` (and a bf16 dual, which only the kernels serve) takes
    the sharded kernels' plain versions on CPU shards: the port's own
    unsharded fused call at float32 round-off; a float64 grid raises."""
    rng = np.random.default_rng(38)
    noisy = torch.as_tensor(rng.random((8, 4, 16, 16)) + 3.0,
                            dtype=torch.float32)
    grid, cfg = shard_volume(noisy, _mesh(4, 2)), TVConfig(**CFG)
    if solver == "tv":
        # what tv_and_subgrad of CUDA shards runs, on CPU shards
        from pytv4d_tpu_torch.kernels.fused import tv_and_subgrad_fused
        from pytv4d_tpu_torch.parallel.fused_halo import (
            make_sharded_tv_and_subgrad_fused,
        )

        want = tv_and_subgrad_fused(noisy, cfg, return_grad_norms=True)
        got = make_sharded_tv_and_subgrad_fused(
            _mesh(4, 2), cfg, noisy.shape, return_grad_norms=True)(grid)
        assert float(got[0]) == pytest.approx(float(want[0]), rel=1e-6)
        np.testing.assert_allclose(_np(got[1]), want[1].numpy(), atol=1e-5)
        np.testing.assert_allclose(_np(got[2]), want[2].numpy(), rtol=1e-6)
        return
    kw = dict(n_iter=10, reg=0.5, cfg=cfg)
    if solver == "gd":
        want = subgradient_descent(noisy, fused=True, **kw)
        got = subgradient_descent(grid, fused=True, **kw)
    else:
        if solver == "cp_bf16_dual":
            kw["dual_dtype"] = "bfloat16"
        else:
            kw["fused"] = True
        want = chambolle_pock(noisy, **kw)
        got = chambolle_pock(grid, **kw)
        assert got.state.y_D[0][0].dtype == torch.float32
    assert got.loss.dtype == torch.float32
    np.testing.assert_allclose(got.loss.numpy(), want.loss.numpy(),
                               rtol=1e-6)
    np.testing.assert_allclose(_np(got.x), want.x.numpy(), atol=1e-5)
    with pytest.raises(ValueError, match="fused=True"):
        chambolle_pock(shard_volume(noisy.double(), _mesh(4, 2)), n_iter=1,
                       fused=True)


@functools.lru_cache(maxsize=None)
def _jax_f32(solver):
    """The JAX package's whole-volume call on the float32 noisy volume of
    :func:`test_fused_grid_calls_match_jax`."""
    noisy = jnp.asarray(_noisy38())
    cfg = JConfig(**CFG)
    kw = dict(n_iter=10, reg=0.5, cfg=cfg)
    if solver == "tv":
        return tuple(np.asarray(a) for a in jptv.tv_and_subgrad(
            noisy, "hybrid", reg_time=0.5, return_grad_norms=True))
    if solver == "gd":
        res = jsolvers.subgradient_descent(noisy, **kw)
        return np.asarray(res.x), np.asarray(res.loss), np.asarray(res.tv)
    if solver == "cp_resume":
        first = jsolvers.chambolle_pock(noisy, **dict(kw, n_iter=6))
        res = jsolvers.chambolle_pock(noisy, state=first.state,
                                      **dict(kw, n_iter=4))
        return (np.asarray(res.x), np.asarray(res.loss),
                np.asarray(res.state.y_D),
                tuple(np.asarray(a) for a in first.state))
    if solver == "cp_bf16_dual":
        kw["dual_dtype"] = "bfloat16"
    res = jsolvers.chambolle_pock(noisy, **kw)
    return (np.asarray(res.x), np.asarray(res.loss),
            np.asarray(res.state.y_D, np.float32))


@functools.lru_cache(maxsize=None)
def _noisy38():
    rng = np.random.default_rng(38)
    return (rng.random((8, 4, 16, 16)) + 3.0).astype(np.float32)


@pytest.mark.parametrize("solver", ["cp", "cp_bf16_dual", "cp_resume", "gd",
                                    "tv"])
def test_fused_grid_calls_match_jax(solver):
    """What a CUDA grid runs, on CPU shards (the kernels' plain versions
    behind ``fused=True``, a bf16 dual, or the sharded fused TV with its
    norms), against the JAX package's whole-volume call on the same
    float32 input, at the float32 bars of ``test_torch_parallel_fused``:
    the dispatch, the state's layout conversion both ways and the
    summed histories."""
    noisy = torch.as_tensor(_noisy38())
    mesh = _mesh(4, 2)
    grid, cfg = shard_volume(noisy, mesh), TVConfig(**CFG)
    want = _jax_f32(solver)
    if solver == "tv":
        from pytv4d_tpu_torch.parallel.fused_halo import (
            make_sharded_tv_and_subgrad_fused,
        )

        tv, G, norms = make_sharded_tv_and_subgrad_fused(
            mesh, cfg, noisy.shape, return_grad_norms=True)(grid)
        assert float(tv) == pytest.approx(float(want[0]), rel=1e-5)
        np.testing.assert_allclose(_np(G), want[1], atol=1e-5, rtol=1e-4)
        np.testing.assert_allclose(_np(norms), want[2], rtol=1e-5)
        return
    kw = dict(n_iter=10, reg=0.5, cfg=cfg)
    bars = dual_bars = dict(atol=1e-5, rtol=1e-4)
    loss_rtol = 1e-5
    if solver == "gd":
        got = subgradient_descent(grid, fused=True, **kw)
        np.testing.assert_allclose(got.tv.numpy(), want[2], rtol=1e-5)
    elif solver == "cp_resume":
        st = CPState(*(shard_volume(a.copy(), mesh) for a in want[3][:2]),
                     shard_d_volume(want[3][2].copy(), mesh))
        got = chambolle_pock(grid, fused=True, state=st,
                             **dict(kw, n_iter=4))
    else:
        if solver == "cp_bf16_dual":
            # the dual is rounded to bfloat16 in both: its bars are
            # test_torch_parallel_fused's for bfloat16 storage
            kw["dual_dtype"] = "bfloat16"
            bars, loss_rtol = dict(atol=1e-3, rtol=1e-3), 1e-4
            dual_bars = dict(atol=3e-2, rtol=2e-2)
        else:
            kw["fused"] = True
        got = chambolle_pock(grid, **kw)
        assert chambolle_pock(grid, return_dual=False,
                              **dict(kw, n_iter=1)).state.y_D is None
    assert is_grid(got.x) and got.loss.dtype == torch.float32
    np.testing.assert_allclose(got.loss.numpy(), want[1], rtol=loss_rtol)
    np.testing.assert_allclose(_np(got.x), want[0], **bars)
    if solver != "gd":
        assert got.state.y_D[0][0].dtype == torch.float32
        np.testing.assert_allclose(_np(got.state.y_D, d=True), want[2],
                                   **dual_bars)


def _grid():
    return shard_volume(np.random.default_rng(0).random((4, 2, 8, 8)),
                        _mesh(2, 2))


ANGLES = np.linspace(0.0, np.pi, 4, endpoint=False)
CONE_ANGLES = np.linspace(0.0, 2 * np.pi, 4, endpoint=False)
CONE_GEOM = ConeBeamGeometry(20.0, 10.0)
SHAPE = (4, 2, 8, 8)


def _inputs(kind):
    """``(whole, grid)``: the (4, 2, 8, 8) f64 volume on a (2 x 2) mesh,
    its parallel sinogram on the same mesh, or its cone sinogram cut along
    t."""
    from pytv4d_tpu_torch.models.ct import (
        cone_sinogram_sharding,
        radon,
        radon_cone,
        sinogram_sharding,
    )
    from pytv4d_tpu_torch.parallel import shard

    vol = torch.tensor(np.random.default_rng(0).random(SHAPE))
    if kind == "volume":
        return vol, shard_volume(vol, _mesh(2, 2))
    if kind == "sinogram":
        sino = radon(vol, ANGLES)
        return sino, shard(sino, sinogram_sharding(_mesh(2, 2)))
    sino = radon_cone(vol, CONE_ANGLES, CONE_GEOM, n_det_v=6)
    return sino, shard(sino, cone_sinogram_sharding(_mesh(1, 2)))


def _whole_of(a):
    return (gather_d_volume(a) if a[0][0].ndim == 5 else gather_volume(a)) \
        if is_grid(a) else a


def _same(got, want):
    """The grid call's result equals the whole call's (f64, 1e-10): its
    fields gathered, its loss or residual history as it is."""
    if isinstance(want, tuple):
        for g, w in zip(got, want):
            if w is not None:
                _same(g, w)
        return
    np.testing.assert_allclose(_whole_of(got).numpy(), want.numpy(),
                               rtol=1e-10, atol=1e-12)


# the entry points that took no grid before ROADMAP.md item A19: each runs
# on a grid and equals the same call on the gathered input
ON_GRID = {
    "chambolle_pock_precond": (lambda g: chambolle_pock_precond(g, n_iter=3),
                               "volume"),
    "run_until_converged": (lambda g: run_until_converged(
        chambolle_pock, g, chunk=2, max_iter=4), "volume"),
    "run_checkpointed": (lambda g: run_checkpointed(chambolle_pock, g, 2),
                         "volume"),
    "TVDenoiser.cp": (lambda g: TVDenoiser().cp(g, n_iter=2), "volume"),
    "TVDenoiser.gd": (lambda g: TVDenoiser().gd(g, n_iter=2), "volume"),
    "TVDenoiser.tgv": (lambda g: TVDenoiser().tgv(g, n_iter=2), "volume"),
    "TVDenoiser.admm": (lambda g: TVDenoiser().admm(g, n_iter=2), "volume"),
    "TVDenoiser.fista": (lambda g: TVDenoiser().fista(g, n_iter=2),
                         "volume"),
    "tgv_reconstruct": (lambda g: tgv_reconstruct(g, ANGLES, SHAPE,
                                                  n_iter=2), "sinogram"),
    "sart": (lambda g: sart(g, ANGLES, SHAPE, n_iter=1, n_subsets=2),
             "sinogram"),
    "fdk": (lambda g: fdk(g, CONE_ANGLES, CONE_GEOM, SHAPE), "cone"),
    "fbp": (lambda g: fbp(g, ANGLES), "sinogram"),
}


@pytest.mark.parametrize("name", [*ON_GRID, "fused 4d on a t cut",
                                  "device", "full mask"])
def test_what_takes_no_grid_raises(name):
    """The entry points that took no grid before ROADMAP.md item A19 now
    run on one and equal the same call on the gathered input (f64,
    1e-10); what a grid still cannot serve raises ``ValueError``:
    ``fused=True`` for ``'4d'`` TGV on a grid that cuts time, a ``device``
    that is not the shards', and a full mask."""
    grid = _grid()
    if name in ON_GRID:
        call, kind = ON_GRID[name]
        whole, grid = _inputs(kind)
        got, want = call(grid), call(whole)
        if hasattr(want, "_fields"):
            got, want = tuple(got), tuple(want)
        _same(got, want)
    elif name == "device":
        with pytest.raises(ValueError, match="not moved"):
            admm(grid, n_iter=1, device="cuda")
    elif name == "full mask":
        with pytest.raises(ValueError, match="full mask"):
            ops.api.tv_and_subgrad(grid, mask=np.ones((4, 2, 8, 8), bool))
        with pytest.raises(ValueError, match="plane-shaped"):
            admm(grid, n_iter=1, weight_time=np.ones((4, 2, 8, 8)))
    else:
        with pytest.raises(ValueError, match="cuts time"):
            tgv_denoise(grid, axes="4d", n_iter=1, fused=True,
                        compute_loss=False)
