"""The sharded modes of the port's fused kernels: B1/B2 in ``halo_mode`` and
``interior``, B3/B4 in ``halo_mode`` and the boundary kernels B8, through
their wrappers (which take the plain PyTorch versions for CPU tensors).

Each is held (a) to the unsharded wrapper cut to the shard, slot for slot:
the plain versions round alike, so float32 and bfloat16 outputs are equal
bit for bit (the kernels store no float64), and (b) to the JAX package's
Pallas kernel in the interpreter on the same extended inputs."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pytv4d_tpu.core.config import TVConfig as JConfig
from pytv4d_tpu.kernels import fused as jfused
from pytv4d_tpu_torch.core.config import TVConfig
from pytv4d_tpu_torch.core.schemes import AXIS_T, AXIS_Z, scheme_channels
from pytv4d_tpu_torch.kernels import fused
from pytv4d_tpu_torch.parallel import fused_halo as fh
from pytv4d_tpu_torch.parallel.mesh import (
    gather_volume,
    grid_map,
    make_mesh,
    shard_volume,
)
from pytv4d_tpu_torch.solvers.cp import default_tau
from pytv4d_tpu_torch.utils import profiling

TOL = dict(atol=2e-6, rtol=1e-5)      # the JAX fused-vs-jnp bar (CP)
TOL_TV = dict(atol=3e-6, rtol=1e-5)   # its bar for the TV passes
TOL_TMUL = dict(atol=5e-6, rtol=1e-4)  # and with a tmul plane
BF16_RTOL = 2.0 ** -7                 # one bf16 ulp
BF16_MAX_FLIPPED = 0.01
REG, SIGMA_D, SIGMA_A = 0.5, 0.5, 1.0
HYB = dict(scheme="hybrid", reg_time=0.5)

# name -> (global shape, mesh (z, t)): 2 x 2-plane shards with a first, a
# middle and a last one along z; 1-plane shards along z; 1-plane shards
# along both; 1-frame shards along t
LAYOUTS = {
    "3x2": ((6, 4, 8, 16), (3, 2)),
    "z1": ((4, 2, 8, 16), (4, 1)),
    "z1t1": ((3, 2, 8, 16), (3, 2)),
    "t1": ((4, 4, 8, 16), (2, 4)),
}
OVERLAP_SHAPE, OVERLAP_MESH = (9, 3, 8, 16), (3, 1)  # 3-plane shards

# (id, config, step options, layout)
CP_CASES = [
    *[(f"{s}-time", dict(scheme=s, reg_time=0.5), {}, "3x2")
      for s in ("upwind", "downwind", "central", "hybrid")],
    ("hybrid-aniso", dict(norm="aniso", **HYB), {}, "3x2"),
    ("hybrid-huber", dict(norm="huber", huber_delta=0.3, **HYB), {}, "3x2"),
    ("hybrid-zt-tmul-l1", dict(scheme="hybrid", reg_time=0.7,
                               reg_z_over_reg=0.3),
     dict(tmul=True, fidelity="l1", fid_weight=0.7), "3x2"),
    ("central-tmul-kl-nonneg", dict(scheme="central", reg_time=0.5),
     dict(tmul=True, fidelity="kl", fid_weight=0.7, nonneg=True), "3x2"),
    ("upwind-noz", dict(scheme="upwind", reg_z_over_reg=0.0, reg_time=0.5),
     {}, "3x2"),
    ("hybrid-bf16dual", HYB, dict(dual="bfloat16"), "3x2"),
    ("hybrid-bf16", HYB, dict(dtype="bfloat16", dual="bfloat16"), "3x2"),
    ("central-z1", dict(scheme="central", reg_time=0.5), {}, "z1"),
    ("hybrid-z1t1", HYB, {}, "z1t1"),
    ("central-t1", dict(scheme="central", reg_time=0.5), {}, "t1"),
]
# the overlapped step needs z channels: without them the solver takes the
# ghost path
B8_CASES = [c[:3] for c in CP_CASES if c[3] == "3x2" and "noz" not in c[0]]
TV_CASES = [
    *[(f"{s}-time", dict(scheme=s, reg_time=0.5), {}, "3x2")
      for s in ("upwind", "downwind", "central", "hybrid")],
    ("hybrid-aniso", dict(norm="aniso", **HYB), {}, "3x2"),
    ("hybrid-huber", dict(norm="huber", huber_delta=0.3, **HYB), {}, "3x2"),
    ("hybrid-tmul", HYB, dict(tmul=True), "3x2"),
    ("central-huber-tmul", dict(scheme="central", reg_time=0.5, norm="huber",
                                huber_delta=0.3), dict(tmul=True), "3x2"),
    ("hybrid-bf16", HYB, dict(dtype="bfloat16"), "3x2"),
    ("central-z1", dict(scheme="central", reg_time=0.5), {}, "z1"),
    ("upwind-z1t1", dict(scheme="upwind", reg_time=0.5), {}, "z1t1"),
    ("central-t1", dict(scheme="central", reg_time=0.5), {}, "t1"),
]


def _ids(cases):
    return [c[0] for c in cases]


def _close(got, ref, bf16, tol):
    """Within the f32 bar; bf16 storage: plus one bf16 ulp, and at most 1%
    of the elements beyond the f32 bar (a rounding flipped near a bf16
    midpoint)."""
    got = got.float().numpy()
    ref = np.asarray(ref.astype(jnp.float32))
    if not bf16:
        np.testing.assert_allclose(got, ref, **tol)
        return
    err = np.abs(got - ref)
    f32_bar = tol["atol"] + tol["rtol"] * np.abs(ref)
    assert (err <= f32_bar + BF16_RTOL * (np.abs(ref) + REG)).all()
    assert (err > f32_bar).mean() <= BF16_MAX_FLIPPED


def _close_x(got, ref, bf16):
    """x' after pass B.  With bf16 storage the TPU kernel takes most of
    D^T y_D' from the unrounded y_D' it still holds from pass A, the port
    from the stored one: x' moves by at most tau (1 + sum |w|) 2^-9 < 3e-3
    (tests/test_torch_cp_kernels.py states the same bar); a bf16 x' may
    then round one bf16 ulp apart."""
    if not bf16:
        return _close(got, ref, False, TOL)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=BF16_RTOL, atol=3e-3)


def _j(t):
    """A torch tensor as a jax array of the same dtype."""
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)
    return jnp.asarray(t.numpy())


class _Problem:
    """A CP state of the whole volume that keeps the solver's invariant
    (zero duals at globally invalid slots: one plain step from zero duals),
    the step's options, and the same state cut into the mesh's shards."""

    def __init__(self, cfg_kw, opts, shape, mesh_zt, seed=5):
        rng = np.random.default_rng(seed)
        self.shape, self.cfg_kw = shape, dict(cfg_kw)
        self.cfg = TVConfig(**cfg_kw)
        self.dtype = getattr(torch, opts.get("dtype", "float32"))
        self.dual = getattr(torch, opts.get("dual", "float32"))
        self.bf16 = torch.bfloat16 in (self.dtype, self.dual)
        self.fid = dict(fidelity=opts.get("fidelity", "l2"),
                        fid_weight=opts.get("fid_weight", 1.0))
        self.nonneg = opts.get("nonneg", False)
        self.tm = (torch.tensor(rng.random(shape[2:]) + 0.5,
                                dtype=torch.float32)
                   if opts.get("tmul") else None)
        self.chans, _ = scheme_channels(
            self.cfg.scheme, shape[0], shape[1], self.cfg.reg_z_over_reg,
            self.cfg.reg_time)
        self.table_dims = shape[:2]
        self.tau = default_tau(self.cfg, shape[0], shape[1], SIGMA_A)
        x0 = torch.tensor(rng.random(shape) + 0.5, dtype=torch.float32)
        x = x0 + 0.1 * torch.tensor(rng.random(shape), dtype=torch.float32)
        y_A = torch.zeros(shape)
        y_D = torch.zeros((shape[0], shape[1], len(self.chans)) + shape[2:])
        fused.cp_dual(x, x0, y_A, y_D, self.tm, **self.dual_kw())
        x = x + 0.05 * torch.tensor(rng.random(shape), dtype=torch.float32)
        self.state = (x.to(self.dtype), x0.to(self.dtype),
                      y_A.to(self.dtype), y_D.to(self.dual))
        self.mesh = make_mesh(*mesh_zt, device="cpu")
        self.st = mesh_zt[1] > 1

    def dual_kw(self, sharded=False):
        kw = dict(cfg=self.cfg, sigma_D=SIGMA_D, sigma_A=SIGMA_A, reg=REG,
                  **self.fid)
        return dict(kw, table_dims=self.table_dims) if sharded else kw

    def primal_kw(self, sharded=False):
        kw = dict(cfg=self.cfg, tau=self.tau, nonneg=self.nonneg, **self.fid)
        return dict(kw, table_dims=self.table_dims) if sharded else kw

    def whole(self):
        """The unsharded step on a copy: ``(x', y_A', y_D', tv, fid)``."""
        x, x0, y_A, y_D = (t.clone() for t in self.state)
        _, _, tv = fused.cp_dual(x, x0, y_A, y_D, self.tm, **self.dual_kw())
        _, fid = fused.cp_primal(x, x0, y_A, y_D, self.tm, **self.primal_kw())
        return x, y_A, y_D, float(tv.sum()), float(fid.sum())

    def shards(self):
        return tuple(shard_volume(t.clone(), self.mesh, self.st)
                     for t in self.state)

    def ghosts(self):
        return (fh._axis_ghost_kind(self.chans, AXIS_Z),
                fh._axis_ghost_kind(self.chans, AXIS_T))

    def jax_kw(self, local_shape):
        """Arguments of the JAX kernel factories for one shard."""
        jdt = "bfloat16" if self.dtype == torch.bfloat16 else "float32"
        kw = dict(dual_dtype_name=("bfloat16" if self.dual == torch.bfloat16
                                   else "float32"),
                  table_dims=self.table_dims, t_plane=self.tm is not None,
                  **self.fid)
        return JConfig(**self.cfg_kw), tuple(local_shape), jdt, kw

    def jtm(self):
        return None if self.tm is None else jnp.asarray(self.tm.numpy())


def _picked(grid):
    """(iz, it) of a first, a middle and a last shard along z, on
    alternating columns."""
    nz, nt = len(grid), len(grid[0])
    return sorted({(0, 0), (nz // 2, nt - 1), (nz - 1, (nt - 1) // 2)})


@pytest.mark.parametrize("case", CP_CASES, ids=_ids(CP_CASES))
def test_cp_halo_mode_matches_unsharded_and_jax(case):
    _, cfg_kw, opts, layout = case
    p = _Problem(cfg_kw, opts, *LAYOUTS[layout])
    x_w, yA_w, yD_w, tv_w, fid_w = p.whole()

    x, x0, y_A, y_D = p.shards()
    gz, gt = p.ghosts()
    x_ext = fh._extend_axis(fh._extend_axis(x, 0, gz), 1, gt)
    before = (grid_map(torch.clone, y_A), grid_map(torch.clone, y_D))
    mode = dict(halo_mode=True, t_sharded=p.st)
    tv = grid_map(lambda xe, b, ya, yd: fused.cp_dual(
        xe, b, ya, yd, p.tm, **mode, **p.dual_kw(True))[2],
        x_ext, x0, y_A, y_D)
    y_ext = fh._extend_dual(y_D, p.chans)
    x_old = grid_map(torch.clone, x)
    fid = grid_map(lambda xs, b, ya, yd, ye: fused.cp_primal(
        xs, b, ya, yd, p.tm, y_ext=ye, **mode, **p.primal_kw(True))[1],
        x, x0, y_A, y_D, y_ext)

    # (a) the unsharded step cut to the shards, bit for bit
    assert torch.equal(gather_volume(y_A), yA_w)
    assert torch.equal(gather_volume(y_D), yD_w)
    assert torch.equal(gather_volume(x), x_w)
    tol = 1e-3 if p.bf16 else 1e-6
    assert sum(float(t.sum()) for r in tv for t in r) == pytest.approx(
        tv_w, rel=tol)
    assert sum(float(t.sum()) for r in fid for t in r) == pytest.approx(
        fid_w, rel=tol)

    # (b) the JAX kernels on the same extended inputs
    jcfg, local, jdt, jkw = p.jax_kw(x0[0][0].shape)
    dual = jfused.make_cp_dual_kernel(
        jcfg, local, jdt, SIGMA_D, SIGMA_A, REG, True, halo_mode=True,
        t_sharded=p.st, **jkw)
    primal = jfused.make_cp_primal_kernel(
        jcfg, local, jdt, p.tau, True, halo_mode=True, t_sharded=p.st,
        nonneg=p.nonneg, **jkw)
    for iz, it in _picked(x):
        jyA, jyD, jdt_local, jtv = dual(
            _j(x_ext[iz][it]), _j(x0[iz][it]), _j(before[0][iz][it]),
            _j(before[1][iz][it]), p.jtm())
        _close(y_A[iz][it], jyA, p.bf16, TOL)
        _close(y_D[iz][it], jyD, p.bf16, TOL)
        assert float(tv[iz][it].sum()) == pytest.approx(
            float(jfused._sum_parts(jtv)), rel=1e-5)
        jx, jfid = primal(_j(x_old[iz][it]), _j(x0[iz][it]), jyA, jyD,
                          _j(y_ext[iz][it]).astype(jyD.dtype), jdt_local,
                          p.jtm())
        _close_x(x[iz][it], jx, p.bf16)
        assert float(fid[iz][it].sum()) == pytest.approx(
            float(jfused._sum_parts(jfid)), rel=1e-3 if p.bf16 else 1e-5)


@pytest.mark.parametrize("case", B8_CASES, ids=_ids(B8_CASES))
def test_interior_and_boundary_match_unsharded_and_jax(case):
    """The overlapped step's four launches (B1 and B2 with ``interior``,
    then the two B8 kernels on the edge planes) against one unsharded step
    and against the JAX package's four kernels."""
    _, cfg_kw, opts = case
    p = _Problem(cfg_kw, opts, OVERLAP_SHAPE, OVERLAP_MESH)
    x_w, yA_w, yD_w, tv_w, fid_w = p.whole()

    x, x0, y_A, y_D = p.shards()
    gz, _ = p.ghosts()
    before = (grid_map(torch.clone, y_A), grid_map(torch.clone, y_D),
              grid_map(torch.clone, x))
    x_halo = fh._halo_planes(x, 0, gz)
    tv = grid_map(lambda xs, b, ya, yd: fused.cp_dual(
        xs, b, ya, yd, p.tm, interior=True, **p.dual_kw(True))[2],
        x, x0, y_A, y_D)
    for iz in range(3):  # the interior pass leaves the edge planes alone
        for z in (0, -1):
            assert torch.equal(y_A[iz][0][z], before[0][iz][0][z])
            assert torch.equal(y_D[iz][0][z], before[1][iz][0][z])
    grid_map(lambda xs, xh, b, ya, yd, pt: fused.cp_dual_boundary(
        xs, xh, b, ya, yd, pt, p.tm, **p.dual_kw(True)),
        x, x_halo, x0, y_A, y_D, tv)
    assert torch.equal(gather_volume(y_A), yA_w)
    assert torch.equal(gather_volume(y_D), yD_w)

    y_halo = fh._sparse_channel_halo(y_D, 0, p.chans, AXIS_Z)
    fid = grid_map(lambda xs, b, ya, yd: fused.cp_primal(
        xs, b, ya, yd, p.tm, interior=True, **p.primal_kw(True))[1],
        x, x0, y_A, y_D)
    for iz in range(3):
        for z in (0, -1):
            assert torch.equal(x[iz][0][z], before[2][iz][0][z])
    grid_map(lambda xs, b, ya, yd, yh, pt: fused.cp_primal_boundary(
        xs, b, ya, yd, yh, pt, p.tm, **p.primal_kw(True)),
        x, x0, y_A, y_D, y_halo, fid)
    assert torch.equal(gather_volume(x), x_w)
    tol = 1e-3 if p.bf16 else 1e-6
    assert sum(float(t.sum()) for r in tv for t in r) == pytest.approx(
        tv_w, rel=tol)
    assert sum(float(t.sum()) for r in fid for t in r) == pytest.approx(
        fid_w, rel=tol)

    jcfg, local, jdt, jkw = p.jax_kw(x0[0][0].shape)
    dual_int = jfused.make_cp_dual_kernel(
        jcfg, local, jdt, SIGMA_D, SIGMA_A, REG, True, interior=True, **jkw)
    dual_bnd = jfused.make_cp_dual_boundary_kernel(
        jcfg, local, jdt, SIGMA_D, SIGMA_A, REG, True, **jkw)
    primal_int = jfused.make_cp_primal_kernel(
        jcfg, local, jdt, p.tau, True, interior=True, nonneg=p.nonneg, **jkw)
    primal_bnd = jfused.make_cp_primal_boundary_kernel(
        jcfg, local, jdt, p.tau, True, nonneg=p.nonneg, **jkw)
    for iz in range(3):  # the first, the middle and the last shard
        jx, jx0 = _j(before[2][iz][0]), _j(x0[iz][0])
        out = dual_int(jx, jx0, _j(before[0][iz][0]), _j(before[1][iz][0]),
                       p.jtm())
        jyA, jyD, jdt_l, jtv = dual_bnd(jx, _j(x_halo[iz][0]), jx0, *out,
                                        p.jtm())
        _close(y_A[iz][0], jyA, p.bf16, TOL)
        _close(y_D[iz][0], jyD, p.bf16, TOL)
        assert float(tv[iz][0].sum()) == pytest.approx(
            float(jfused._sum_parts(jtv)), rel=1e-5)
        jx1, jfid = primal_int(jx, jx0, jyA, jyD, jdt_l, p.jtm())
        jx1, jfid = primal_bnd(jx1, jx0, jyA, jyD,
                               _j(y_halo[iz][0]).astype(jyD.dtype), jdt_l,
                               jfid, p.jtm())
        _close_x(x[iz][0], jx1, p.bf16)
        assert float(fid[iz][0].sum()) == pytest.approx(
            float(jfused._sum_parts(jfid)), rel=1e-3 if p.bf16 else 1e-5)


@pytest.mark.parametrize("case", TV_CASES, ids=_ids(TV_CASES))
def test_tv_halo_mode_matches_unsharded_and_jax(case):
    _, cfg_kw, opts, layout = case
    shape, mesh_zt = LAYOUTS[layout]
    rng = np.random.default_rng(6)
    cfg = TVConfig(**cfg_kw)
    dtype = getattr(torch, opts.get("dtype", "float32"))
    bf16 = dtype == torch.bfloat16
    xw = torch.tensor(rng.random(shape), dtype=torch.float32)
    xw[:, :, 2:4, 3:9] = 0.25  # a flat patch: zero norms, the +inf rule
    xw = xw.to(dtype)
    tm = (torch.tensor(rng.random(shape[2:]) + 0.5, dtype=torch.float32)
          if opts.get("tmul") else None)
    norms_w, parts_w = fused.tv_norms(xw, tm, cfg=cfg)
    G_w = fused.tv_subgrad(xw, norms_w, tm, cfg=cfg)

    mesh = make_mesh(*mesh_zt, device="cpu")
    st = mesh_zt[1] > 1
    chans, _ = scheme_channels(cfg.scheme, shape[0], shape[1],
                               cfg.reg_z_over_reg, cfg.reg_time)
    gz = fh._axis_ghost_kind(chans, AXIS_Z)
    gt = fh._axis_ghost_kind(chans, AXIS_T)
    x = shard_volume(xw, mesh, st)
    mode = dict(cfg=cfg, halo_mode=True, table_dims=shape[:2])
    x1 = fh._extend_axis(fh._extend_axis(x, 0, gz), 1, gt)
    passed = grid_map(lambda xe: fused.tv_norms(xe, tm, **mode), x1)
    norms = grid_map(lambda np_: np_[0], passed)
    x2 = fh._extend_axis2(fh._extend_axis2(x, 0, gz), 1, gt)
    aniso = cfg.norm == "aniso"
    n1 = None if aniso else fh._extend_norms(norms)
    if aniso:
        G = grid_map(lambda xe: fused.tv_subgrad(xe, None, tm, **mode), x2)
    else:
        G = grid_map(lambda xe, ne: fused.tv_subgrad(xe, ne, tm, **mode),
                     x2, n1)

    # (a) the unsharded passes cut to the shards, bit for bit
    assert torch.equal(gather_volume(norms), norms_w)
    assert torch.equal(gather_volume(G), G_w)
    assert G[0][0].dtype == dtype
    assert sum(float(np_[1].sum()) for r in passed for np_ in r) == \
        pytest.approx(float(parts_w.sum()), rel=1e-6)

    # (b) the JAX kernels on the same extended inputs
    local = tuple(x[0][0].shape)
    jdt = "bfloat16" if bf16 else "float32"
    jkw = dict(halo_mode=True, table_dims=shape[:2], t_plane=tm is not None)
    norms_k = jfused.make_tv_norms_kernel(JConfig(**cfg_kw), local, jdt, True,
                                          **jkw)
    sub_k = jfused.make_tv_subgrad_kernel(JConfig(**cfg_kw), local, jdt,
                                          True, **jkw)
    jtm = None if tm is None else jnp.asarray(tm.numpy())
    tol = TOL_TMUL if tm is not None else TOL_TV
    for iz, it in _picked(x):
        jn, jparts = norms_k(_j(x1[iz][it]), jtm)
        got = norms[iz][it].numpy()
        np.testing.assert_array_equal(np.isinf(got), np.isinf(jn))
        finite = np.isfinite(got)
        np.testing.assert_allclose(got[finite], np.asarray(jn)[finite], **tol)
        assert float(passed[iz][it][1].sum()) == pytest.approx(
            float(jfused._sum_parts(jparts)), rel=1e-5)
        jG = sub_k(_j(x2[iz][it]), None if aniso else _j(n1[iz][it]), jtm)
        _close(G[iz][it], jG, bf16, tol)


def test_mode_checks():
    cfg = TVConfig(**HYB)
    x = torch.zeros(3, 2, 4, 8)
    y_D = torch.zeros(3, 2, 8, 4, 8)
    kw = dict(cfg=cfg, sigma_D=0.5, sigma_A=1.0, reg=1.0, table_dims=(6, 2))
    with pytest.raises(ValueError, match="extended by 1 plane"):
        fused.cp_dual(x, x, x.clone(), y_D, halo_mode=True, **kw)
    with pytest.raises(ValueError, match="exclude each other"):
        fused.cp_dual(torch.zeros(5, 4, 4, 8), x, x.clone(), y_D,
                      halo_mode=True, interior=True, **kw)
    with pytest.raises(ValueError, match="3 local z"):
        fused.cp_dual(x[:2].contiguous(), x[:2].contiguous(),
                      x[:2].clone(), y_D[:2].contiguous(), interior=True,
                      **kw)
    pk = dict(cfg=cfg, tau=0.1, table_dims=(6, 2))
    with pytest.raises(ValueError, match="y_ext goes with halo_mode"):
        fused.cp_primal(x, x, x.clone(), y_D, halo_mode=True, **pk)
    with pytest.raises(ValueError, match="y_ext must be"):
        fused.cp_primal(x, x, x.clone(), y_D, halo_mode=True, y_ext=y_D, **pk)
    parts = torch.zeros(3, 1)
    with pytest.raises(ValueError, match="x_halo must be"):
        fused.cp_dual_boundary(x, x[:1].contiguous(), x, x.clone(), y_D,
                               parts, **kw)
    with pytest.raises(ValueError, match="y_halo must be"):
        fused.cp_primal_boundary(x, x, x.clone(), y_D, x[:2].contiguous(),
                                 parts, **pk)
    with pytest.raises(ValueError, match="parts must be"):
        fused.cp_primal_boundary(x, x, x.clone(), y_D, y_D[:2].contiguous(),
                                 torch.zeros(3), **pk)
    with pytest.raises(ValueError, match="norms must be float32"):
        fused.tv_subgrad(torch.zeros(7, 6, 4, 8), torch.zeros(3, 2, 4, 8),
                         cfg=cfg, halo_mode=True, table_dims=(6, 2))


def test_launch_counters_stay_on_cpu():
    before = profiling.counters()
    p = _Problem(HYB, {}, OVERLAP_SHAPE, OVERLAP_MESH)
    x, x0, y_A, y_D = (g[1][0] for g in p.shards())
    _, _, tv = fused.cp_dual(x, x0, y_A, y_D, interior=True,
                             **p.dual_kw(True))
    fused.cp_dual_boundary(x, torch.zeros((2,) + x.shape[1:]), x0, y_A, y_D,
                           tv, **p.dual_kw(True))
    assert tv.shape == (3, 1)
    assert profiling.counters() == before


# B5 in its halo mode: (global shape, mesh (z, t)) by name
B5_LAYOUTS = {"z4": ((8, 4, 12, 20), (4, 1)), "2x2": ((8, 4, 12, 20), (2, 2))}


@pytest.mark.parametrize("dual", ["float32", "bfloat16"])
@pytest.mark.parametrize("scheme", ["hybrid", "central"])
@pytest.mark.parametrize("layout", B5_LAYOUTS)
def test_tv_dual_halo_mode_matches_unsharded_and_jax(layout, scheme, dual):
    """B5's halo mode (its plain version here): each shard's x_bar with its
    ghost planes, the TV dual prox of the shard, equal bit for bit to the
    unsharded ``tv_dual`` on the gathered volume cut to the shard (f32 and
    a bf16 dual), its TV partials summing to the whole's, and both within
    the CP bar of the JAX package's unsharded ``make_tv_dual_kernel`` in the
    interpreter (bf16: plus one ulp on at most 1%)."""
    shape, mesh_zt = B5_LAYOUTS[layout]
    cfg_kw = dict(scheme=scheme, reg_time=0.5)
    cfg = TVConfig(**cfg_kw)
    chans, _ = scheme_channels(scheme, shape[0], shape[1], 1.0, 0.5)
    rng = np.random.default_rng(9)
    x_bar = torch.tensor(rng.standard_normal(shape), dtype=torch.float32)
    ddt = getattr(torch, dual)
    y_D = torch.tensor(rng.uniform(-1, 1, (shape[0], shape[1], len(chans))
                                   + shape[2:]), dtype=torch.float32).to(ddt)
    whole, parts = fused.tv_dual(x_bar, y_D.clone(), cfg=cfg,
                                 sigma_D=SIGMA_D, reg=REG)
    mesh = make_mesh(*mesh_zt, device="cpu")
    st = mesh_zt[1] > 1
    ghost_z = fh._axis_ghost_kind(chans, AXIS_Z)
    ghost_t = fh._axis_ghost_kind(chans, AXIS_T)
    ext = fh._extend_axis(fh._extend_axis(shard_volume(x_bar, mesh, st), 0,
                                          ghost_z), 1, ghost_t)
    before = profiling.counters()
    out = grid_map(lambda xe, yd: fused.tv_dual(
        xe, yd, cfg=cfg, sigma_D=SIGMA_D, reg=REG, halo_mode=True,
        table_dims=shape[:2]),
        ext, shard_volume(y_D.clone(), mesh, st))
    assert profiling.counters() == before  # no kernel on the CPU
    got = gather_volume(grid_map(lambda o: o[0], out))
    assert got.dtype == ddt and torch.equal(got, whole)
    tv = sum(float(o[1].sum()) for row in out for o in row)
    assert tv == pytest.approx(float(parts.sum()), rel=1e-6)
    kernel = jfused.make_tv_dual_kernel(
        JConfig(**cfg_kw), shape, "float32", SIGMA_D, REG, True,
        dual_dtype_name=dual)
    j_yD = kernel(_j(x_bar), _j(y_D))[0]
    _close(got, j_yD, dual == "bfloat16", TOL)


def test_tv_dual_halo_mode_checks():
    """The halo mode's operands: x_bar extended by a plane per side in z
    and t, y_D of the shard's shape."""
    cfg = TVConfig(**HYB)
    x_ext = torch.zeros((4, 4, 8, 8))
    y_D = torch.zeros((2, 2, 8, 8, 8))
    kw = dict(cfg=cfg, sigma_D=SIGMA_D, reg=REG, table_dims=(8, 4))
    fused.tv_dual(x_ext, y_D, halo_mode=True, **kw)
    with pytest.raises(ValueError, match="y_D must be"):
        fused.tv_dual(x_ext, torch.zeros((4, 4, 8, 8, 8)), halo_mode=True,
                      **kw)
    with pytest.raises(ValueError, match="extended by 1"):
        fused.tv_dual(torch.zeros((2, 2, 8, 8)), y_D, halo_mode=True, **kw)
