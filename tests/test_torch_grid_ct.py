"""The port's CT entry points on a grid of shards against the same calls on
the whole sinogram, and against the JAX package's whole-volume calls where
the JAX package has them: ``cp_reconstruct`` with every option (the fused
path on the kernels' plain versions, a bf16 dual, ``precond`` on the gather
pairs and on the spectral cone, a resumed ``state`` both ways, an array
``fidelity_weight``, ``x_init``, ``loss_every``), ``tgv_reconstruct``,
``fbp``, ``fdk`` and ``sart``, and every relative floor taken from the
whole grid's scale, never one shard's.  The JAX side at its GSPMD tests'
tolerances (``tests/test_sharding.py:596``: loss ``rtol=1e-5``, x
``atol=1e-5, rtol=1e-4``; ``tests/test_ct_spectral.py:249``: x
``atol=1e-6, rtol=1e-5``); the port's float64 grid against its own
gathered call at 1e-10; float32 against the port's own whole call at the
JAX bars (the fused path's f32 round-off)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytv4d_tpu.models.ct as jct
from pytv4d_tpu.core.config import TVConfig as JConfig
from pytv4d_tpu_torch.core.config import TVConfig
from pytv4d_tpu_torch.models import ct
from pytv4d_tpu_torch.models.ct import (
    ConeBeamGeometry,
    cone_sinogram_sharding,
    cp_reconstruct,
    radon,
    radon_cone,
    sinogram_sharding,
)
from pytv4d_tpu_torch.ops.space import TENSOR
from pytv4d_tpu_torch.parallel import (
    gather_d_volume,
    gather_volume,
    is_grid,
    make_mesh,
    shard,
    shard_volume,
)
from pytv4d_tpu_torch.parallel.halo import grid_space
from pytv4d_tpu_torch.solvers.inverse import InverseState, _reciprocal_rows
from pytv4d_tpu_torch.utils import profiling, synthetic_phantom

LOSS_RTOL = 1e-5
X_TOL = dict(atol=1e-5, rtol=1e-4)
F64 = dict(rtol=1e-10, atol=1e-12)
CONE = ConeBeamGeometry(source_dist=40.0, det_dist=20.0)
JCONE = jct.ConeBeamGeometry(source_dist=40.0, det_dist=20.0)
CFG = dict(scheme="hybrid", reg_time=0.5)
ANGLES = np.linspace(0, np.pi, 16, endpoint=False)
CONE_ANGLES = np.linspace(0, 2 * np.pi, 12, endpoint=False)


@pytest.fixture(autouse=True)
def _one_thread():
    """A sharded solve is many small ops a shard: one intra-op thread does
    not wait for others under several test workers."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def _truth():
    truth2d = synthetic_phantom(24) / 255.0
    truth = np.stack([np.roll(truth2d, z, axis=0) for z in range(8)])[:, None]
    return np.tile(truth, (1, 2, 1, 1))  # (8, 2, 24, 24)


def _cone_truth(seed=51):
    rng = np.random.default_rng(seed)
    truth = np.zeros((6, 4, 16, 16))
    truth[2:5, :, 5:12, 5:12] = 1.0
    return truth + 0.05 * rng.standard_normal(truth.shape)


def _np(grid, d=False):
    return (gather_d_volume(grid) if d else gather_volume(grid)).numpy()


def _close(got, want, x_tol=X_TOL, loss_rtol=LOSS_RTOL):
    np.testing.assert_allclose(np.asarray(got.loss), np.asarray(want.loss),
                               rtol=loss_rtol)
    x = _np(got.x) if is_grid(got.x) else np.asarray(got.x)
    np.testing.assert_allclose(x, np.asarray(want.x), **x_tol)


def _jax(sino, shape, angles=ANGLES, **kw):
    """The JAX package's ``cp_reconstruct`` of the whole sinogram, the
    port's keywords turned into its own (``cfg``, arrays)."""
    kw = {k: (v.numpy() if isinstance(v, torch.Tensor) else v)
          for k, v in kw.items()}
    if "cfg" in kw:
        kw["cfg"] = JConfig(**{f: getattr(kw["cfg"], f)
                               for f in JConfig.__dataclass_fields__})
    return jct.cp_reconstruct(jnp.asarray(sino.numpy()), angles, shape,
                              **kw)


def _parallel(dtype, mesh=(4, 2)):
    sino = radon(torch.tensor(_truth(), dtype=dtype), ANGLES)
    return sino, shard(sino, sinogram_sharding(make_mesh(*mesh,
                                                         device="cpu")))


# -------------------------------------------------- twins of the JAX tests


@pytest.mark.parametrize("mesh", [(4, 2), (4, 1)])
def test_fused_grid_tracks_jax(mesh):
    """``tests/test_sharding.py``'s ``test_sharded_ct_reconstruction`` on
    the fused path: the f32 grid runs B5 / B2 / B3 in their halo mode (the
    plain versions here), the JAX package its whole-volume solve; both at
    the JAX test's bars, and B5 / B2 / B3 count no launch on the CPU."""
    sino64, _ = _parallel(torch.float64)
    kw = dict(n_iter=30, reg=0.02, op_norm=24.0)
    ref = jct.cp_reconstruct(jnp.asarray(sino64.numpy()), ANGLES,
                             _truth().shape, **kw)
    sino, grid = _parallel(torch.float32, mesh)
    before = profiling.counters()
    got = cp_reconstruct(grid, ANGLES, _truth().shape, fused=True, **kw)
    assert profiling.counters() == before
    _close(got, ref)
    _close(got, cp_reconstruct(sino, ANGLES, _truth().shape, fused=True,
                               **kw))


@pytest.mark.parametrize("method", ["gather", "spectral"])
def test_cone_precond_on_a_t_grid(method):
    """The cone's ``precond=True`` on a (1 x 4) grid: the gather pair's row
    and column sums per shard, the spectral cone's surrogate sums per
    column floored at the whole grid's scale and its power method on the
    grid, against the whole sinogram's solve (f64, 1e-10) and the JAX
    package's (``tests/test_sharding.py``'s cone twins' bars)."""
    truth = _cone_truth(57)
    sino = radon_cone(torch.tensor(truth), CONE_ANGLES, CONE, n_det_v=12)
    kw = dict(n_iter=12, reg=0.01, geom=CONE, precond=True, method=method,
              cfg=TVConfig(**CFG))
    whole = cp_reconstruct(sino, CONE_ANGLES, truth.shape, **kw)
    grid = shard(sino, cone_sinogram_sharding(make_mesh(1, 4, device="cpu")))
    got = cp_reconstruct(grid, CONE_ANGLES, truth.shape, **kw)
    _close(got, whole, F64, 1e-10)
    ref = jct.cp_reconstruct(
        jnp.asarray(sino.numpy()), CONE_ANGLES, truth.shape,
        geom=JCONE, cfg=JConfig(**CFG), **{k: v for k, v in kw.items()
                               if k not in ("geom", "cfg")})
    _close(got, ref, dict(atol=1e-6, rtol=1e-5))


# ------------------------------------------------ cp_reconstruct's options


def _resumed(sino, grid, shape, **kw):
    """5 + 5 iterations: whole then grid, grid then whole, against 10."""
    ten = cp_reconstruct(sino, ANGLES, shape, n_iter=10, **kw)
    a = cp_reconstruct(sino, ANGLES, shape, n_iter=5, **kw)
    b = cp_reconstruct(grid, ANGLES, shape, n_iter=5, state=a.state, **kw)
    c = cp_reconstruct(grid, ANGLES, shape, n_iter=5, **kw)
    d = cp_reconstruct(sino, ANGLES, shape, n_iter=5, state=InverseState(
        *(None if f is None else (
            gather_d_volume(f) if i == 3 else gather_volume(f))
          for i, f in enumerate(c.state))), **kw)
    return ten, b, d


OPTIONS = {
    "precond gather": dict(precond=True, nonneg=True),
    "array fidelity_weight": dict(fidelity_weight="array", op_norm=24.0),
    "grid fidelity_weight": dict(fidelity_weight="grid", op_norm=24.0,
                                 fidelity="l1"),
    "x_init and loss_every": dict(x_init="grid", loss_every=5,
                                  op_norm=24.0),
    "norm on the grid": dict(),
}


@pytest.mark.parametrize("name", OPTIONS)
def test_options_on_a_grid(name):
    """Each option on a (4 x 2) f64 grid equals the same call on the whole
    sinogram to 1e-10, and the JAX package's whole call at the JAX bars;
    the weight and ``x_init`` come whole or as grids."""
    sino, grid = _parallel(torch.float64)
    kw = dict(OPTIONS[name], n_iter=10, reg=0.02, cfg=TVConfig(**CFG))
    whole_kw = dict(kw)
    if kw.get("fidelity_weight") in ("array", "grid"):
        w = torch.tensor(np.random.default_rng(3).random(sino.shape) + 0.5)
        whole_kw["fidelity_weight"] = w
        kw["fidelity_weight"] = (w.numpy() if kw["fidelity_weight"] ==
                                 "array" else shard(w, sinogram_sharding(
                                     make_mesh(4, 2, device="cpu"))))
    if kw.get("x_init") == "grid":
        x0 = torch.tensor(_truth()) * 0.5
        whole_kw["x_init"] = x0
        kw["x_init"] = shard_volume(x0, make_mesh(4, 2, device="cpu"))
    got = cp_reconstruct(grid, ANGLES, _truth().shape, **kw)
    want = cp_reconstruct(sino, ANGLES, _truth().shape, **whole_kw)
    _close(got, want, F64, 1e-10)
    assert is_grid(got.state.y_D) and is_grid(got.state.s_x)
    _close(got, _jax(sino, _truth().shape, **whole_kw))


@pytest.mark.parametrize("dtype", ["float64", "float32 fused",
                                   "bf16 dual"])
def test_state_resumes_both_ways(dtype):
    """A whole-volume state resumes on the grid and a grid's on the whole
    volume; both equal the port's uninterrupted solve (f64 at 1e-10; f32
    on the fused path and with a bf16 dual at the JAX bars) and the JAX
    package's (its fused path in the interpreter for the bf16 dual) at the
    JAX bars."""
    dt = torch.float64 if dtype == "float64" else torch.float32
    sino, grid = _parallel(dt)
    kw = dict(reg=0.02, op_norm=24.0, cfg=TVConfig(**CFG))
    if dtype == "bf16 dual":
        kw["dual_dtype"] = "bfloat16"
    ten, b, d = _resumed(sino, grid, _truth().shape, **kw)
    tol = F64 if dt == torch.float64 else X_TOL
    ref = _jax(sino, _truth().shape, n_iter=10, **kw)
    for got in (b, d):
        x = _np(got.x) if is_grid(got.x) else got.x.numpy()
        np.testing.assert_allclose(x, ten.x.numpy(), **tol)
        np.testing.assert_allclose(got.loss.numpy(), ten.loss[5:].numpy(),
                                   rtol=1e-10 if dt == torch.float64
                                   else LOSS_RTOL)
        np.testing.assert_allclose(got.loss.numpy(),
                                   np.asarray(ref.loss)[5:], rtol=LOSS_RTOL)
        np.testing.assert_allclose(x, np.asarray(ref.x), **X_TOL)
    assert b.state.y_D[0][0].dtype == dt


def test_fused_choice_and_errors_on_a_grid():
    """``fused=None`` chooses as for a volume (f32: the fused path, f64:
    the plain step), ``dual_dtype`` requires the fused path, and a grid
    that the kernels cannot take raises with the volume's messages."""
    sino, grid = _parallel(torch.float32)
    kw = dict(n_iter=3, reg=0.02, op_norm=24.0)
    auto = cp_reconstruct(grid, ANGLES, _truth().shape, **kw)
    forced = cp_reconstruct(grid, ANGLES, _truth().shape, fused=True, **kw)
    assert torch.equal(auto.loss, forced.loss)
    assert auto.loss.dtype == torch.float32
    _, grid64 = _parallel(torch.float64)
    with pytest.raises(ValueError, match="fused=True cannot serve"):
        cp_reconstruct(grid64, ANGLES, _truth().shape, fused=True, **kw)
    with pytest.raises(ValueError, match="dual_dtype requires"):
        cp_reconstruct(grid64, ANGLES, _truth().shape,
                       dual_dtype="bfloat16", **kw)
    with pytest.raises(ValueError, match="incompatible with precond"):
        cp_reconstruct(grid, ANGLES, _truth().shape, fused=True,
                       precond=True, n_iter=2)


# ---------------------------------------- tgv_reconstruct, fbp, fdk, sart


@pytest.mark.parametrize("case", ["2d", "3d precond"])
def test_tgv_reconstruct_on_a_grid(case):
    """``tgv_reconstruct`` of a (4 x 2) sinogram grid against the JAX
    package's whole solve (x at 1e-9 in f64) and the port's own (1e-10)."""
    sino, grid = _parallel(torch.float64)
    axes, precond = case.split()[0], "precond" in case
    kw = dict(n_iter=8, axes=axes, precond=precond, alpha1=0.02,
              alpha0=0.04)
    if not precond:
        kw["op_norm"] = 24.0
    got = ct.tgv_reconstruct(grid, ANGLES, _truth().shape, **kw)
    want = ct.tgv_reconstruct(sino, ANGLES, _truth().shape, **kw)
    _close(got, want, F64, 1e-10)
    ref = jct.tgv_reconstruct(jnp.asarray(sino.numpy()), ANGLES,
                              _truth().shape, **kw)
    _close(got, ref, dict(atol=1e-9, rtol=1e-9), 1e-9)


def test_fbp_and_fdk_on_grids():
    """``fbp`` of a (4 x 2) parallel grid and ``fdk`` of a (1 x 4) cone
    grid, shard by shard: volume grids equal to the whole calls (f64), and
    to the JAX package's whole calls at 1e-10."""
    sino, grid = _parallel(torch.float64)
    got = ct.fbp(grid, ANGLES)
    assert len(got) == 4 and len(got[0]) == 2
    want = ct.fbp(sino, ANGLES)
    np.testing.assert_allclose(_np(got), want.numpy(), **F64)
    np.testing.assert_allclose(_np(got), np.asarray(jct.fbp(
        jnp.asarray(sino.numpy()), ANGLES)), rtol=1e-10, atol=1e-10)
    truth = _cone_truth()
    cone = radon_cone(torch.tensor(truth), CONE_ANGLES, CONE, n_det_v=12)
    cgrid = shard(cone, cone_sinogram_sharding(make_mesh(1, 4,
                                                         device="cpu")))
    got = ct.fdk(cgrid, CONE_ANGLES, CONE, truth.shape)
    assert len(got) == 1 and len(got[0]) == 4
    np.testing.assert_allclose(_np(got), ct.fdk(
        cone, CONE_ANGLES, CONE, truth.shape).numpy(), **F64)
    np.testing.assert_allclose(_np(got), np.asarray(jct.fdk(
        jnp.asarray(cone.numpy()), CONE_ANGLES, JCONE, truth.shape,
        method="gather")), rtol=1e-10, atol=1e-10)


@pytest.mark.parametrize("case", ["parallel", "cone spectral",
                                  "per-frame angles"])
def test_sart_on_a_grid(case):
    """``sart`` of a sinogram grid equals the whole sinogram's (f64,
    1e-10) and the JAX package's whole call (the JAX bars): the subsets
    per column, the tolerances and the residual over the whole grid;
    per-frame angles are cut with the frames."""
    if case == "cone spectral":
        truth = _cone_truth()
        sino = radon_cone(torch.tensor(truth), CONE_ANGLES, CONE,
                          n_det_v=12)
        grid = shard(sino, cone_sinogram_sharding(make_mesh(
            1, 4, device="cpu")))
        kw = dict(geom=CONE, method="spectral", n_subsets=4, n_iter=2)
        angles = CONE_ANGLES
    else:
        truth = _truth()
        angles = ANGLES
        if case == "per-frame angles":
            angles = np.stack([ANGLES, ANGLES + 0.1])
        sino = radon(torch.tensor(truth), angles)
        grid = shard(sino, sinogram_sharding(make_mesh(4, 2, device="cpu")))
        kw = dict(n_subsets=4, n_iter=2)
    got = ct.sart(grid, angles, truth.shape, **kw)
    want = ct.sart(sino, angles, truth.shape, **kw)
    np.testing.assert_allclose(_np(got.x), want.x.numpy(), **F64)
    np.testing.assert_allclose(got.residual.numpy(), want.residual.numpy(),
                               rtol=1e-10)
    jkw = dict(kw, geom=JCONE) if "geom" in kw else dict(kw, method="gather")
    ref = jct.sart(jnp.asarray(sino.numpy()), angles, truth.shape, **jkw)
    np.testing.assert_allclose(got.residual.numpy(),
                               np.asarray(ref.residual), rtol=LOSS_RTOL)
    np.testing.assert_allclose(_np(got.x), np.asarray(ref.x), **X_TOL)


# ------------------------------------------------ the floors of the grid


def _lopsided(shape=(4, 2, 6, 6), axis=0):
    """A positive field whose first half along ``axis`` (a shard of two) is
    ~1e-9 of the other: every relative floor of the other's scale lies
    above all of it."""
    a = torch.tensor(np.random.default_rng(1).random(shape) + 0.5)
    a.narrow(axis, 0, shape[axis] // 2).mul_(1e-9)
    return a


def test_reciprocal_rows_floor_is_the_grid_s():
    """``solvers.inverse._reciprocal_rows``: a grid's floor is 1e-6 of the
    whole grid's largest row, so the small shard's rows are floored as on
    the whole field."""
    row = _lopsided()
    mesh = make_mesh(2, 1, device="cpu")
    got = _reciprocal_rows(shard_volume(row, mesh),
                           grid_space(mesh, None, row.shape))
    want = _reciprocal_rows(row, TENSOR)
    np.testing.assert_array_equal(_np(got), want.numpy())
    assert float(want[0].max()) < float(1.0 / row[0].min())  # it floored


def test_cone_precond_floor_is_the_grid_s():
    """``models.ct._cone_precond_scale``'s row floor on a grid is the whole
    grid's: with identity operators the scale on the grid equals the whole
    field's (1e-10)."""
    row = _lopsided((2, 4, 6, 6), axis=1)
    col = torch.ones_like(row)
    cfg = TVConfig(**CFG)
    mesh = make_mesh(1, 2, device="cpu")
    space = grid_space(mesh, cfg, row.shape)
    from pytv4d_tpu_torch.ops.operators import precond_maps
    from pytv4d_tpu_torch.ops.space import tensor_space
    from pytv4d_tpu_torch.parallel.halo import grid_precond_maps

    def maps(c):
        return precond_maps(row.shape, cfg.scheme, cfg.reg_z_over_reg,
                            cfg.reg_time, fidelity_colsum=c, grouped=True,
                            dtype=row.dtype, device="cpu")

    def gmaps(c):
        return grid_precond_maps(mesh, row.shape, True, scheme=cfg.scheme,
                                 reg_z_over_reg=cfg.reg_z_over_reg,
                                 reg_time=cfg.reg_time, fidelity_colsum=c,
                                 grouped=True, dtype=row.dtype)

    v = torch.tensor(np.random.default_rng(0).standard_normal(row.shape))
    ident = (lambda x: x)
    want = ct._cone_precond_scale(ident, ident, row, col, tensor_space(
        cfg, shape=row.shape), maps, v)
    cut = lambda a: shard_volume(a, mesh)  # noqa: E731
    got = ct._cone_precond_scale(ident, ident, cut(row), cut(col), space,
                                 gmaps, cut(v))
    assert got == pytest.approx(want, rel=1e-10)


def test_spectral_and_sart_floors_are_the_grid_s():
    """The surrogate sums' 1e-6 floor on a grid (``models.ct._floored``,
    ``ct_spectral.py``'s floor of a whole field) and SART's dead-row
    tolerance: a caller's projector that makes one column's rows ~1e-9 of
    the other's gives on the grid what it gives on the whole sinogram,
    where that column's rows are all dead."""
    field = _lopsided((2, 4, 6, 6), axis=1)
    mesh = make_mesh(1, 2, device="cpu")
    got = ct._floored(grid_space(mesh, None, field.shape),
                      shard_volume(field, mesh))
    want = torch.maximum(field, 1e-6 * torch.max(field))
    np.testing.assert_array_equal(_np(got), want.numpy())

    truth = _truth()[:4]
    frames = np.stack([ANGLES, ANGLES + 6.0])  # column 1's frames > 5 rad

    def project(x, a):
        scale = torch.where(a[..., :1] > 5.0, 1.0, 1e-9)[..., None]
        return radon(x, a) * scale.to(x.dtype)

    sino = project(torch.tensor(truth), torch.tensor(frames))
    grid = shard(sino, sinogram_sharding(make_mesh(2, 2, device="cpu")))
    kw = dict(n_subsets=4, n_iter=2, project_fn=project)
    got = ct.sart(grid, frames, truth.shape, **kw)
    want = ct.sart(sino, frames, truth.shape, **kw)
    np.testing.assert_allclose(_np(got.x), want.x.numpy(), **F64)
    assert float(want.x[:, 0].abs().max()) == 0.0  # column 0 all dead


def test_sart_cone_health_gate_is_the_grid_s():
    """``models.ct._sart_cone_sums``' conditioning test on a grid takes the
    whole grid's smallest and largest sums: a grid whose every shard is
    well conditioned on its own but not as a whole takes the surrogate's
    sums, as the whole field does."""
    local = (6, 1, 16, 16)
    scale = torch.ones((6, 2, 16, 16), dtype=torch.float64)
    scale[:, 0] = 1e-3
    mesh = make_mesh(1, 2, device="cpu")
    space = grid_space(mesh, None, scale.shape)

    def pair(s):
        return (lambda x: x * s), (lambda y: y * s)

    idx = np.arange(4).reshape(-1, 2).T
    whole = ct._sart_cone_sums(
        [pair(scale)] * 2, [[pair(scale)] * 2], idx, CONE_ANGLES[:4],
        scale.shape, (12, 16), torch.float64, None, CONE, "cpu", TENSOR,
        torch.ones_like(scale))
    cut = shard_volume(scale, mesh)
    gp = (lambda x: [[a * b for a, b in zip(x[0], cut[0])]])
    grid = ct._sart_cone_sums(
        [(gp, gp)] * 2, [[pair(scale[:, :1])] * 2, [pair(scale[:, 1:])] * 2],
        idx, CONE_ANGLES[:4], local, (12, 16), torch.float64, None, CONE,
        "cpu", space, shard_volume(torch.ones_like(scale), mesh))
    assert tuple(whole[0][0].shape) == (2, 2, 12, 16)  # the surrogate's
    for (wr, wc), (gr, gc) in zip(whole, grid):
        np.testing.assert_allclose(
            torch.cat([gr[0][0], gr[0][1]], dim=0).numpy(), wr.numpy(),
            rtol=1e-10)
