"""The port's inverse solver (``solvers/inverse.py``) against the JAX
package's on the same seeded numpy inputs: ``cp_inverse`` on the fused path
(the JAX Pallas kernels run in the interpreter, the port's wrappers take
their plain versions on the CPU) and on the plain path, resume, the
preconditioned steps, the guards, and the helpers around the solver."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytv4d_tpu.ops.operators as jops
import pytv4d_tpu.solvers.inverse as jinv
from pytv4d_tpu.core.config import TVConfig as JConfig
from pytv4d_tpu_torch import interop
from pytv4d_tpu_torch.core.config import TVConfig
from pytv4d_tpu_torch.kernels import fused
from pytv4d_tpu_torch.ops import operators
from pytv4d_tpu_torch.solvers import inverse

SHAPE = (4, 3, 16, 128)
# the JAX package's own fused-vs-jnp bar for 8 iterations in float32
# (tests/test_inverse_fused.py): per-step f32 round-off, accumulated
F32 = dict(rtol=2e-5, atol=3e-6)
STATE_FIELDS = ("x", "x_bar", "y_A", "y_D", "s_x", "s_x_bar")


def jblur(x):
    """A 3-tap periodic row blur (the JAX fused-inverse test operator)."""
    return (x + jnp.roll(x, 1, axis=-1) + jnp.roll(x, -1, axis=-1)) / 3.0


def tblur(x):
    return (x + torch.roll(x, 1, -1) + torch.roll(x, -1, -1)) / 3.0


def _data(dtype=np.float32):
    rng = np.random.default_rng(0)
    truth = rng.random(SHAPE)
    blurred = (truth + np.roll(truth, 1, -1) + np.roll(truth, -1, -1)) / 3.0
    return (blurred + 0.05 * rng.standard_normal(SHAPE)).astype(dtype)


B = _data()


def _both(b, cfg_kw=None, n_iter=8, **kw):
    cfg_kw = cfg_kw or {}
    kw = dict(dict(reg=0.05, op_norm=1.0), **kw)
    jres = jinv.cp_inverse(jblur, jnp.asarray(b), SHAPE, n_iter=n_iter,
                           cfg=JConfig(**cfg_kw), **{
                               k: jnp.asarray(v) if isinstance(v, np.ndarray)
                               else v for k, v in kw.items()})
    tres = inverse.cp_inverse(tblur, torch.tensor(b), SHAPE, n_iter=n_iter,
                              cfg=TVConfig(**cfg_kw), **{
                                  k: torch.tensor(v)
                                  if isinstance(v, np.ndarray) else v
                                  for k, v in kw.items()})
    return jres, tres


def _assert_same(jres, tres, rtol, atol):
    for name in STATE_FIELDS:
        np.testing.assert_allclose(
            getattr(tres.state, name).numpy(),
            np.asarray(getattr(jres.state, name)), rtol=rtol, atol=atol,
            err_msg=name)
    assert tres.x is tres.state.x
    np.testing.assert_allclose(tres.loss.numpy(), np.asarray(jres.loss),
                               rtol=rtol)


@pytest.mark.parametrize("fused_path", (True, False))
@pytest.mark.parametrize("scheme", ("upwind", "downwind", "central",
                                    "hybrid"))
def test_cp_inverse_matches_jax_schemes(scheme, fused_path):
    _assert_same(*_both(B, dict(scheme=scheme, reg_time=0.5),
                        fused=fused_path), **F32)


@pytest.mark.parametrize("fused_path", (True, False))
@pytest.mark.parametrize("norm", ("aniso", "huber"))
def test_cp_inverse_matches_jax_norms(norm, fused_path):
    _assert_same(*_both(B, dict(scheme="hybrid", reg_time=0.5, norm=norm),
                        fused=fused_path), **F32)


@pytest.mark.parametrize("fused_path", (True, False))
@pytest.mark.parametrize("fidelity", ("l1", "kl"))
def test_cp_inverse_matches_jax_fidelities(fidelity, fused_path):
    b = np.abs(B) if fidelity == "kl" else B
    _assert_same(*_both(b, fidelity=fidelity, nonneg=(fidelity == "kl"),
                        fused=fused_path), **F32)


@pytest.mark.parametrize("fused_path", (True, False))
def test_cp_inverse_nonneg_and_measurement_weight(fused_path):
    w = np.random.default_rng(3).uniform(0.5, 1.5, SHAPE).astype(np.float32)
    _assert_same(*_both(B, dict(reg_time=0.5), nonneg=True,
                        fidelity_weight=w, fused=fused_path), **F32)


def test_auto_selection_takes_the_fused_path_and_estimates_the_norm(
        monkeypatch):
    """No ``fused=`` and no ``op_norm``: float32 takes the fused step (one
    pass A, one pass B, one TV-norms call per iteration) and the power
    method gives the JAX package's step."""
    calls = dict(tv_dual=0, cp_primal=0, tv_norms=0)

    def counted(name):
        plain = getattr(fused, name + "_plain")

        def call(*a, **kw):
            calls[name] += 1
            return plain(*a, **kw)

        return call

    for name in calls:
        monkeypatch.setattr(fused, name + "_plain", counted(name))
    jres, tres = _both(B, dict(reg_time=0.5), n_iter=4, op_norm=None,
                       x_init=np.full(SHAPE, 0.5, np.float32))
    assert calls == dict(tv_dual=4, cp_primal=4, tv_norms=4)
    _assert_same(jres, tres, **F32)


def test_resume_equals_one_shot_bit_for_bit():
    """The carried projections keep a resumed run on the uninterrupted
    one's path: on the CPU, where every op is deterministic, bit for bit,
    on the fused and the plain path."""
    b = torch.tensor(B)
    for fused_path in (True, False):
        kw = dict(reg=0.05, op_norm=1.0, cfg=TVConfig(reg_time=0.5),
                  fused=fused_path)
        one = inverse.cp_inverse(tblur, b, SHAPE, n_iter=8, **kw)
        first = inverse.cp_inverse(tblur, b, SHAPE, n_iter=4, **kw)
        kept = [t.clone() for t in first.state]
        second = inverse.cp_inverse(tblur, b, SHAPE, n_iter=4,
                                    state=first.state, **kw)
        for name in STATE_FIELDS:
            assert torch.equal(getattr(second.state, name),
                               getattr(one.state, name)), name
        assert torch.equal(second.loss, one.loss[4:])
        for before, after in zip(kept, first.state):  # the state is not touched
            assert torch.equal(before, after)


@pytest.mark.parametrize("fused_path", (True, False))
def test_resume_across_packages(fused_path):
    """A JAX state (public layout, numpy) resumes in the port and lands
    where the JAX package's own resumed run lands; without the carried
    projections it is recomputed once and still agrees to round-off."""
    kw = dict(reg=0.05, op_norm=1.0, fused=fused_path)
    first = jinv.cp_inverse(jblur, jnp.asarray(B), SHAPE, n_iter=4,
                            cfg=JConfig(), **kw)
    ref = jinv.cp_inverse(jblur, jnp.asarray(B), SHAPE, n_iter=4,
                          cfg=JConfig(), state=first.state, **kw)
    state = interop.inverse_state_from_numpy(
        [np.asarray(a) for a in first.state], device="cpu")
    assert isinstance(state, inverse.InverseState)
    got = inverse.cp_inverse(tblur, torch.tensor(B), SHAPE, n_iter=4,
                             cfg=TVConfig(), state=state, **kw)
    _assert_same(ref, got, **F32)
    bare = interop.inverse_state_from_numpy(
        [np.asarray(a) for a in first.state[:4]], device="cpu")
    assert bare.s_x is None and bare.s_x_bar is None
    got = inverse.cp_inverse(tblur, torch.tensor(B), SHAPE, n_iter=4,
                             cfg=TVConfig(), state=bare, **kw)
    _assert_same(ref, got, **F32)
    back = interop.state_to_numpy(got.state)
    assert len(back) == 6 and back[3].shape == (4, 6, 3, 16, 128)


def test_bf16_dual():
    """bf16 dual storage rounds y_D at every iteration in both packages, at
    different places: the iterates agree to the JAX package's own bf16 bar
    (5e-2), and the returned state's y_D keeps the volume dtype."""
    jres, tres = _both(B, dict(reg_time=0.5), dual_dtype="bfloat16")
    assert tres.state.y_D.dtype == torch.float32
    np.testing.assert_allclose(tres.x.numpy(), np.asarray(jres.x),
                               atol=5e-2, rtol=5e-2)
    # every stored value is a bf16 number
    y = tres.state.y_D
    assert torch.equal(y, y.bfloat16().float())
    np.testing.assert_allclose(tres.loss.numpy(), np.asarray(jres.loss),
                               rtol=1e-3)


@pytest.mark.parametrize("fused_path", (True, False))
def test_loss_every_samples_chunk_ends(fused_path):
    cfg_kw = dict(reg_time=0.5)
    _, full = _both(B, cfg_kw, fused=fused_path)
    jres, sampled = _both(B, cfg_kw, fused=fused_path, loss_every=4)
    assert sampled.loss.shape == (2,)
    assert torch.equal(sampled.x, full.x)
    assert torch.equal(sampled.loss, full.loss[3::4])
    _assert_same(jres, sampled, **F32)


@pytest.mark.parametrize("cfg_kw", (dict(reg_time=0.5),
                                    dict(reg_time=0.5, norm="aniso")),
                         ids=("grouped", "per-channel"))
def test_precond_f64_matches_jax(cfg_kw):
    """``precond=True`` in float64: the same maps and the same iteration,
    to f64 round-off (1e-9)."""
    jres, tres = _both(_data(np.float64), cfg_kw, op_norm=None, precond=True,
                       nonneg=True)
    assert tres.x.dtype == torch.float64
    _assert_same(jres, tres, rtol=1e-9, atol=1e-12)


def test_precond_sums_and_scale_match_jax():
    b = _data(np.float64)
    row = np.asarray(jblur(jnp.ones(SHAPE))) * 1.3
    col = np.full(SHAPE, 1.2)
    jres = jinv.cp_inverse(jblur, jnp.asarray(b), SHAPE, n_iter=6, reg=0.05,
                           precond=True, precond_scale=1.5,
                           precond_sums=(jnp.asarray(row), jnp.asarray(col)))
    tres = inverse.cp_inverse(tblur, torch.tensor(b), SHAPE, n_iter=6,
                              reg=0.05, precond=True, precond_scale=1.5,
                              precond_sums=(row, col))
    _assert_same(jres, tres, rtol=1e-9, atol=1e-12)


def test_f64_stays_on_the_plain_path():
    res = inverse.cp_inverse(tblur, torch.tensor(_data(np.float64)), SHAPE,
                             n_iter=3, reg=0.05, op_norm=1.0)
    assert res.x.dtype == torch.float64 and res.loss.dtype == torch.float64


GUARDS = {
    "fused+precond": (dict(fused=True, precond=True), "precond"),
    "dual_dtype-unfused": (dict(op_norm=1.0, fused=False,
                                dual_dtype="bfloat16"), "dual_dtype"),
    "op_norm+precond": (dict(op_norm=1.0, precond=True), "mutually"),
    "loss_every": (dict(op_norm=1.0, n_iter=8, loss_every=3), "loss_every"),
    "loss_every-zero": (dict(op_norm=1.0, loss_every=0), "loss_every"),
    "precond_sums": (dict(op_norm=1.0, precond_sums=(B, B)),
                     "precond_sums requires"),
    "precond_scale": (dict(op_norm=1.0, precond_scale=1.5),
                      "precond_scale requires"),
    "fidelity": (dict(op_norm=1.0, fidelity="huber"), "fidelity must be"),
    "weight": (dict(op_norm=1.0, fidelity_weight=0.0), "must be positive"),
}


@pytest.mark.parametrize("name", list(GUARDS))
def test_guards_raise_as_in_jax(name):
    kw, match = GUARDS[name]
    kw = dict(dict(n_iter=2), **kw)
    with pytest.raises(ValueError, match=match):
        jinv.cp_inverse(jblur, jnp.asarray(B), SHAPE, **{
            k: tuple(map(jnp.asarray, v)) if k == "precond_sums" else v
            for k, v in kw.items()})
    with pytest.raises(ValueError, match=match):
        inverse.cp_inverse(tblur, torch.tensor(B), SHAPE, **kw)


def test_shape_dtype_and_operator_guards():
    b64 = torch.zeros(SHAPE, dtype=torch.float64)
    with pytest.raises(ValueError, match="can_fuse"):
        inverse.cp_inverse(tblur, b64, SHAPE, n_iter=1, op_norm=1.0,
                           fused=True)
    with pytest.raises(ValueError, match="can_fuse"):
        inverse.cp_inverse(lambda x: x, torch.zeros(SHAPE[1:]), SHAPE[1:],
                           n_iter=1, op_norm=1.0, fused=True)
    with pytest.raises(ValueError, match="kl"):
        inverse.cp_inverse(tblur, -torch.ones(SHAPE), SHAPE, n_iter=1,
                           op_norm=1.0, fidelity="kl")
    with pytest.raises(ValueError, match="nonnegative coefficients"):
        inverse.cp_inverse(lambda x: x - 2.0 * torch.roll(x, 1, -1),
                           torch.zeros(SHAPE), SHAPE, n_iter=1, precond=True)
    with pytest.raises(ValueError, match="nonnegative coefficients"):
        jinv.cp_inverse(lambda x: x - 2.0 * jnp.roll(x, 1, -1),
                        jnp.zeros(SHAPE),
                        SHAPE, n_iter=1, precond=True)


def test_numpy_data_needs_a_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: a numpy input runs there")
    with pytest.raises(RuntimeError, match="CUDA device"):
        inverse.cp_inverse(tblur, B, SHAPE, n_iter=1, op_norm=1.0)
    with pytest.raises(RuntimeError, match="CUDA device"):
        inverse.power_iteration(tblur, tblur, SHAPE)
    res = inverse.cp_inverse(tblur, B, SHAPE, n_iter=2, op_norm=1.0,
                             device="cpu")
    ref = inverse.cp_inverse(tblur, torch.tensor(B), SHAPE, n_iter=2,
                             op_norm=1.0)
    assert res.x.device.type == "cpu" and torch.equal(res.x, ref.x)


@pytest.mark.parametrize("dtype", (np.float32, np.float64))
def test_exact_transpose_and_power_iteration(dtype):
    """The vjp passes the dot-product test to round-off, serves repeated
    calls from one recorded graph, and the seeded power method gives the JAX
    package's estimate (1e-5 in f32: 12 normalised products; 1e-12 in f64)."""
    tdt = torch.tensor(np.zeros(1, dtype)).dtype
    A_T = inverse.exact_transpose(tblur, SHAPE, tdt)
    rng = np.random.default_rng(1)
    x = torch.tensor(rng.standard_normal(SHAPE).astype(dtype))
    for seed in (2, 3):
        y = torch.tensor(np.random.default_rng(seed).standard_normal(
            SHAPE).astype(dtype))
        lhs, rhs = float(torch.sum(y * tblur(x))), float(torch.sum(A_T(y) * x))
        assert lhs == pytest.approx(rhs, rel=1e-5 if dtype == np.float32
                                    else 1e-12)
    assert inverse.cached_transpose(tblur, SHAPE, tdt) is \
        inverse.cached_transpose(tblur, SHAPE, tdt)
    jn = jinv.power_iteration(jblur, jinv.exact_transpose(jblur, SHAPE, dtype),
                              SHAPE, dtype=dtype)
    tn = inverse.power_iteration(tblur, A_T, SHAPE, dtype=tdt, device="cpu")
    assert tn.ndim == 0 and tn.dtype == tdt
    assert float(tn) == pytest.approx(float(jn), rel=1e-5 if dtype ==
                                      np.float32 else 1e-12)


def test_operator_protocol_prepares_once():
    """An operator with ``prepare()/apply`` has its tables built once per
    solve, and its transpose taken of the bound map."""
    class Blur:
        prepared = 0

        def prepare(self):
            Blur.prepared += 1
            return (torch.tensor(3.0),)

        def apply(self, consts, x):
            return (x + torch.roll(x, 1, -1) + torch.roll(x, -1, -1)) \
                / consts[0]

        def __call__(self, x):
            return self.apply(self.prepare(), x)

    b = torch.tensor(B)
    kw = dict(n_iter=4, reg=0.05, op_norm=1.0, cfg=TVConfig(reg_time=0.5))
    Blur.prepared = 0
    got = inverse.cp_inverse(Blur(), b, SHAPE, **kw)
    assert Blur.prepared == 1
    ref = inverse.cp_inverse(tblur, b, SHAPE, **kw)
    np.testing.assert_allclose(got.x.numpy(), ref.x.numpy(), **F32)
    assert inverse._operator_proto(tblur) is None


@pytest.mark.parametrize("norm", ("iso", "huber"))
def test_pd_gap_inverse_matches_jax(norm):
    """The certificate on a 30-iteration f64 state: each of the box and the
    ball bound, and their minimum, to 1e-9; it is nonnegative."""
    b = _data(np.float64)
    cfg_kw = dict(reg_time=0.5, norm=norm, huber_delta=0.3)
    jres, tres = _both(b, cfg_kw, n_iter=30, nonneg=True)
    for bounds in (dict(x_box=2.0), dict(norm_bound=200.0),
                   dict(x_box=2.0, norm_bound=200.0)):
        jg = jinv.pd_gap_inverse(jres.state, jblur, jnp.asarray(b), reg=0.05,
                                 cfg=JConfig(**cfg_kw), **bounds)
        tg = inverse.pd_gap_inverse(tres.state, tblur, torch.tensor(b),
                                    reg=0.05, cfg=TVConfig(**cfg_kw),
                                    **bounds)
        assert float(tg) == pytest.approx(float(jg), rel=1e-9)
        assert float(tg) >= 0.0
    with pytest.raises(ValueError, match="compact prior set"):
        inverse.pd_gap_inverse(tres.state, tblur, torch.tensor(b))


def test_reg_discrepancy_matches_jax():
    """Morozov's principle on the blur in f64: the same bracket and
    bisection, so the same reg (1e-9) and solution."""
    rng = np.random.default_rng(4)
    truth = np.zeros(SHAPE)
    truth[:, :, 4:12, 32:96] = 1.0
    sigma = 0.1
    b = np.asarray(jblur(jnp.asarray(truth))) + sigma * rng.standard_normal(
        SHAPE)
    target = sigma * np.sqrt(b.size)
    kw = dict(n_iter=40, reg0=1e-2, n_bisect=4)
    jreg, jres = jinv.reg_discrepancy(jblur, jnp.asarray(b), SHAPE, target,
                                      **kw)
    treg, tres = inverse.reg_discrepancy(tblur, torch.tensor(b), SHAPE,
                                         target, **kw)
    assert treg == pytest.approx(jreg, rel=1e-9)
    np.testing.assert_allclose(tres.x.numpy(), np.asarray(jres.x), rtol=1e-7,
                               atol=1e-9)
    resid = float(torch.linalg.norm(tblur(tres.x) - torch.tensor(b)))
    assert abs(resid - target) <= 0.25 * target


@pytest.mark.parametrize("dtype", (np.float32, np.float64))
def test_gaussian_blur_operator_matches_jax(dtype):
    shape = (2, 2, 12, 20)
    x = np.random.default_rng(5).random(shape).astype(dtype)
    jb = jinv.gaussian_blur_operator(shape, sigma_px=1.5, radius=3,
                                     dtype=dtype)
    tb = inverse.gaussian_blur_operator(shape, sigma_px=1.5, radius=3)
    got = tb(torch.tensor(x))
    assert got.dtype == torch.tensor(x).dtype
    # 7 taps a side summed in the same order
    np.testing.assert_allclose(got.numpy(), np.asarray(jb(jnp.asarray(x))),
                               rtol=1e-6 if dtype == np.float32 else 1e-14)


@pytest.mark.parametrize("grouped", (False, True))
@pytest.mark.parametrize("scheme", ("upwind", "downwind", "central",
                                    "hybrid"))
def test_precond_maps_match_jax(scheme, grouped):
    """The diagonal preconditioners, with and without a fidelity column sum,
    in f64 to 1e-12; ``abs_d_channel`` / ``abs_dt_channel`` through them."""
    shape = (3, 2, 5, 6)
    col = np.random.default_rng(6).uniform(0.5, 2.0, shape)
    for kw in (dict(), dict(reg_z_over_reg=0.3, reg_time=0.7)):
        for colsum in (None, col):
            js, jt = jops.precond_maps(
                shape, scheme, fidelity_colsum=None if colsum is None
                else jnp.asarray(colsum), grouped=grouped, **kw)
            ts, tt = operators.precond_maps(
                shape, scheme, fidelity_colsum=None if colsum is None
                else torch.tensor(colsum), grouped=grouped,
                dtype=torch.float64, device="cpu", **kw)
            assert tuple(ts.shape) == tuple(js.shape)
            np.testing.assert_allclose(ts.numpy(), np.asarray(js),
                                       rtol=1e-12, atol=0)
            np.testing.assert_allclose(tt.numpy(), np.asarray(jt),
                                       rtol=1e-12, atol=0)
