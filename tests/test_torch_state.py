"""The port's checkpointing and tolerance-based stopping
(``solvers/state.py``) against the JAX package's: an npz either package
wrote loads in the other, a checkpointed run resumes to the uninterrupted
one, and ``run_until_converged`` stops where the JAX package's stops, with
its error messages."""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pytv4d_tpu.solvers.cp as jcp
import pytv4d_tpu.solvers.state as jstate
from pytv4d_tpu.core.config import TVConfig as JConfig
from pytv4d_tpu.solvers import admm_mod as jadmm
from pytv4d_tpu.solvers.gd import subgradient_descent as jgd
from pytv4d_tpu.solvers.inverse import InverseState as JInverseState
from pytv4d_tpu.solvers.inverse import cp_inverse as jcp_inverse
from pytv4d_tpu_torch.core.config import TVConfig
from pytv4d_tpu_torch.solvers import admm_mod as admm
from pytv4d_tpu_torch.solvers import cp, state
from pytv4d_tpu_torch.solvers.gd import subgradient_descent
from pytv4d_tpu_torch.solvers.inverse import InverseState, cp_inverse
from pytv4d_tpu_torch.solvers.tgv import tgv_denoise, tgv_inverse

SHAPE = (2, 2, 12, 16)
RTOL = 1e-9  # float64, the same operations in the same order
CFG_KW = dict(scheme="hybrid", reg_time=0.5)


def _noisy(seed=0):
    return np.random.default_rng(seed).random(SHAPE)


def _blur(x):
    return 0.5 * x + 0.25 * (torch.roll(x, 1, -1) + torch.roll(x, -1, -1))


def _jblur(x):
    return 0.5 * x + 0.25 * (jnp.roll(x, 1, -1) + jnp.roll(x, -1, -1))


# ------------------------------------------------------------ save / load
@pytest.mark.parametrize("kind", ("cp", "precond", "admm"))
def test_jax_checkpoint_loads_in_the_port_and_resumes(tmp_path, kind):
    x0 = _noisy()
    jsolver, solver = {
        "cp": (jcp.chambolle_pock, cp.chambolle_pock),
        "precond": (jcp.chambolle_pock_precond, cp.chambolle_pock_precond),
        "admm": (jadmm.admm, admm.admm)}[kind]
    jres = jsolver(jnp.asarray(x0), n_iter=6, reg=0.3, cfg=JConfig(**CFG_KW))
    path = str(tmp_path / "jax.npz")
    jstate.save_state(path, jres.state)
    like = solver(torch.tensor(x0), n_iter=0, reg=0.3,
                  cfg=TVConfig(**CFG_KW)).state
    st = state.load_state(path, like)
    assert type(st) is type(like)
    for leaf, ref in zip(st, jres.state):
        assert isinstance(leaf, torch.Tensor) and leaf.dtype == torch.float64
        np.testing.assert_array_equal(leaf.numpy(), np.asarray(ref))
    rest = solver(torch.tensor(x0), n_iter=5, reg=0.3, cfg=TVConfig(**CFG_KW),
                  state=st)
    jrest = jsolver(jnp.asarray(x0), n_iter=5, reg=0.3,
                    cfg=JConfig(**CFG_KW), state=jres.state)
    np.testing.assert_allclose(rest.loss.numpy(), np.asarray(jrest.loss),
                               rtol=RTOL)


@pytest.mark.parametrize("kind", ("cp", "precond", "admm"))
def test_port_checkpoint_loads_in_jax_and_resumes(tmp_path, kind):
    x0 = _noisy(1)
    jsolver, solver = {
        "cp": (jcp.chambolle_pock, cp.chambolle_pock),
        "precond": (jcp.chambolle_pock_precond, cp.chambolle_pock_precond),
        "admm": (jadmm.admm, admm.admm)}[kind]
    res = solver(torch.tensor(x0), n_iter=6, reg=0.3, cfg=TVConfig(**CFG_KW))
    path = str(tmp_path / "port.npz")
    state.save_state(path, res.state)
    with np.load(path) as data:  # the JAX package's keys
        assert sorted(data.files) == sorted(
            [f"leaf_{i}" for i in range(len(res.state))] + ["__treedef__"])
    like = jsolver(jnp.asarray(x0), n_iter=0, reg=0.3,
                   cfg=JConfig(**CFG_KW)).state
    jst = jstate.load_state(path, like)
    assert type(jst) is type(like)
    jrest = jsolver(jnp.asarray(x0), n_iter=5, reg=0.3,
                    cfg=JConfig(**CFG_KW), state=jst)
    rest = solver(torch.tensor(x0), n_iter=5, reg=0.3,
                  cfg=TVConfig(**CFG_KW), state=res.state)
    np.testing.assert_allclose(np.asarray(jrest.loss), rest.loss.numpy(),
                               rtol=RTOL)


def test_save_state_trees_dtypes_and_atomic_rename(tmp_path):
    tree = {"b": torch.arange(3.0), "a": (torch.ones(2, dtype=torch.bfloat16),
                                          None, [np.arange(4)])}
    path = str(tmp_path / "tree.npz")
    state.save_state(path, tree)
    assert not (tmp_path / "tree.npz.tmp").exists()
    with np.load(path) as data:
        # dict values by sorted key, None holds no leaf: a's leaves lead
        assert data["leaf_0"].dtype == np.float32  # bf16 widens
        np.testing.assert_array_equal(data["leaf_1"], np.arange(4))
        np.testing.assert_array_equal(data["leaf_2"], [0.0, 1.0, 2.0])
    back = state.load_state(path, tree)
    assert list(back) == ["b", "a"] and back["a"][1] is None
    assert back["a"][0].dtype == torch.bfloat16
    assert isinstance(back["a"][2][0], np.ndarray)
    assert torch.equal(back["b"], tree["b"])
    # the JAX package flattens the same tree in the same order
    jstate.save_state(str(tmp_path / "j.npz"),
                      {"b": np.arange(3.0), "a": (np.ones(2), None,
                                                  [np.arange(4)])})
    with np.load(str(tmp_path / "j.npz")) as data:
        np.testing.assert_array_equal(data["leaf_1"], np.arange(4))
        np.testing.assert_array_equal(data["leaf_2"], [0.0, 1.0, 2.0])


def test_grown_state_rule_and_its_error(tmp_path):
    """A checkpoint from before InverseState grew s_x / s_x_bar loads with
    those fields None, in both packages alike; any other mismatch raises
    the JAX package's message."""
    rng = np.random.default_rng(2)
    old = tuple(rng.random(SHAPE) for _ in range(4))
    path = str(tmp_path / "old.npz")
    jstate.save_state(path, old)
    like = InverseState(*(torch.zeros(SHAPE, dtype=torch.float64)
                          for _ in range(6)))
    st = state.load_state(path, like)
    assert isinstance(st, InverseState) and st.s_x is None \
        and st.s_x_bar is None
    np.testing.assert_array_equal(st.y_D.numpy(), old[3])
    jst = jstate.load_state(path, JInverseState(*(jnp.zeros(SHAPE)
                                                  for _ in range(6))))
    assert jst.s_x is None and jst.s_x_bar is None
    # the solver accepts the reduced state and recomputes the projections
    A = _blur
    b = A(torch.tensor(_noisy()))
    res = cp_inverse(A, b, SHAPE, n_iter=3, reg=0.1)
    state.save_state(path, res.state[:4])
    reduced = state.load_state(path, res.state)
    again = cp_inverse(A, b, SHAPE, n_iter=2, reg=0.1, state=reduced)
    cont = cp_inverse(A, b, SHAPE, n_iter=2, reg=0.1, state=res.state)
    np.testing.assert_allclose(again.loss.numpy(), cont.loss.numpy(),
                               rtol=1e-12)

    # fewer arrays than fields: trailing fields None, in both packages
    state.save_state(path, tuple(torch.zeros(3) for _ in range(3)))
    short = state.load_state(path, cp.CPPrecondState(*(torch.zeros(3),) * 4))
    assert short.y_D is None and short.y_A is not None
    # more arrays than fields cannot be matched
    state.save_state(path, tuple(torch.zeros(3) for _ in range(5)))
    with pytest.raises(ValueError) as got:
        state.load_state(path, cp.CPPrecondState(*(torch.zeros(3),) * 4))
    with pytest.raises(ValueError) as want:
        jstate.load_state(path, jcp.CPPrecondState(*(jnp.zeros(3),) * 4))
    assert str(got.value) == str(want.value)
    assert "holds 5 arrays" in str(got.value)


def test_torch_checkpoint_pair_keeps_every_dtype(tmp_path):
    x0 = torch.tensor(_noisy(), dtype=torch.float32)
    res = cp.chambolle_pock(x0, n_iter=3, reg=0.3, cfg=TVConfig(**CFG_KW))
    st = res.state._replace(y_D=res.state.y_D.bfloat16())
    path = str(tmp_path / "state.pt")
    state.save_state_torch(path, st)
    assert not (tmp_path / "state.pt.tmp").exists()
    back = state.load_state_torch(path, st)
    assert isinstance(back, cp.CPState) and back.y_D.dtype == torch.bfloat16
    for a, b in zip(back, st):
        assert torch.equal(a, b)
    assert state.save_state_orbax is state.save_state_torch
    assert state.load_state_orbax is state.load_state_torch
    with pytest.raises(ValueError, match="holds 3 tensors"):
        state.load_state_torch(path, cp.CPPrecondState(*(x0,) * 4))


# ------------------------------------------------------- run_checkpointed
@pytest.mark.parametrize("kind", ("cp", "admm"))
def test_run_checkpointed_resumes_to_the_uninterrupted_run(tmp_path, kind):
    x0 = torch.tensor(_noisy(3))
    solver = cp.chambolle_pock if kind == "cp" else admm.admm
    kw = dict(reg=0.3, cfg=TVConfig(**CFG_KW))
    full = solver(x0, n_iter=14, **kw)
    path = str(tmp_path / "run.npz")
    # interrupted after 8 of 14 iterations (two chunks of 4)
    part = state.run_checkpointed(solver, x0, 8, checkpoint_path=path,
                                  checkpoint_every=4, **kw)
    assert tuple(part.loss.shape) == (8,)
    with np.load(path + ".meta.npz") as meta:
        assert int(meta["done"]) == 8 and meta["losses"].shape == (8,)
    res = state.run_checkpointed(solver, x0, 14, checkpoint_path=path,
                                 checkpoint_every=4, **kw)
    assert isinstance(res.loss, torch.Tensor)
    assert res.loss.dtype == torch.float64 and tuple(res.loss.shape) == (14,)
    assert torch.equal(res.loss, full.loss)
    assert torch.equal(res.x, full.x)
    for a, b in zip(res.state, full.state):
        assert torch.equal(a, b)
    # nothing left to do: the stored run comes back whole
    again = state.run_checkpointed(solver, x0, 14, checkpoint_path=path,
                                   checkpoint_every=4, **kw)
    assert torch.equal(again.loss, full.loss) and torch.equal(again.x, full.x)
    # no cadence or no path: one plain solver call
    plain = state.run_checkpointed(solver, x0, 14, **kw)
    assert torch.equal(plain.loss, full.loss)


def test_run_checkpointed_continues_a_jax_run(tmp_path):
    """The JAX package's checkpoint and meta files resume in the port."""
    x0 = _noisy(4)
    path = str(tmp_path / "run.npz")
    jstate.run_checkpointed(jcp.chambolle_pock, jnp.asarray(x0), 6,
                            checkpoint_path=path, checkpoint_every=3,
                            reg=0.3, cfg=JConfig(**CFG_KW))
    res = state.run_checkpointed(cp.chambolle_pock, torch.tensor(x0), 10,
                                 checkpoint_path=path, checkpoint_every=3,
                                 reg=0.3, cfg=TVConfig(**CFG_KW))
    want = jcp.chambolle_pock(jnp.asarray(x0), n_iter=10, reg=0.3,
                              cfg=JConfig(**CFG_KW))
    np.testing.assert_allclose(res.loss.numpy(), np.asarray(want.loss),
                               rtol=RTOL)
    np.testing.assert_allclose(res.x.numpy(), np.asarray(want.x), rtol=RTOL,
                               atol=1e-12)


# ---------------------------------------------------- run_until_converged
def test_run_until_converged_loss_stops_where_jax_stops():
    x0 = _noisy(5)
    kw = dict(tol=1e-4, chunk=10, max_iter=400, reg=0.3)
    want = jstate.run_until_converged(jcp.chambolle_pock, jnp.asarray(x0),
                                      cfg=JConfig(**CFG_KW), **kw)
    got = state.run_until_converged(cp.chambolle_pock, torch.tensor(x0),
                                    cfg=TVConfig(**CFG_KW), **kw)
    assert isinstance(got.loss, torch.Tensor)
    n = len(got.loss)
    assert n == len(want.loss) and n < 400 and n % 10 == 0
    np.testing.assert_allclose(got.loss.numpy(), want.loss, rtol=RTOL)
    cont = cp.chambolle_pock(torch.tensor(x0), n_iter=n, reg=0.3,
                             cfg=TVConfig(**CFG_KW))
    assert torch.equal(got.loss, cont.loss) and torch.equal(got.x, cont.x)


def test_run_until_converged_gd_resumes_by_x_init():
    x0 = _noisy(5)
    kw = dict(tol=1e-3, chunk=10, max_iter=120, reg=0.3, step_size=1e-2)
    want = jstate.run_until_converged(jgd, jnp.asarray(x0), **kw)
    got = state.run_until_converged(subgradient_descent, torch.tensor(x0),
                                    **kw)
    assert len(got.loss) == len(want.loss)
    # subgradient descent in f64: the JAX bar of the port's GD tests
    np.testing.assert_allclose(got.loss.numpy(), want.loss, rtol=1e-5)


@pytest.mark.parametrize("solver", ("cp", "precond"))
def test_run_until_converged_gap_stops_where_jax_stops(solver):
    x0 = _noisy(6)
    jsolve, solve = {
        "cp": (jcp.chambolle_pock, cp.chambolle_pock),
        "precond": (jcp.chambolle_pock_precond, cp.chambolle_pock_precond),
    }[solver]
    kw = dict(tol=1e-3, chunk=20, max_iter=2000, criterion="gap")
    want = jstate.run_until_converged(
        functools.partial(jsolve, reg=0.3, cfg=JConfig(**CFG_KW)),
        jnp.asarray(x0), **kw)
    got = state.run_until_converged(
        functools.partial(solve, reg=0.3, cfg=TVConfig(**CFG_KW)),
        torch.tensor(x0), **kw)
    assert len(got.loss) == len(want.loss) < 2000
    np.testing.assert_allclose(got.loss.numpy(), want.loss, rtol=RTOL)
    gap = cp.pd_gap(got.state, torch.tensor(x0), reg=0.3,
                    cfg=TVConfig(**CFG_KW))
    assert float(gap) <= 1e-3 * abs(float(got.loss[-1]))
    # reg as a call-site keyword gives the same run
    same = state.run_until_converged(solve, torch.tensor(x0), reg=0.3,
                                     cfg=TVConfig(**CFG_KW), **kw)
    assert torch.equal(same.loss, got.loss)


def test_run_until_converged_gap_on_an_inverse_state():
    x0 = _noisy(7)
    b = _blur(torch.tensor(x0))
    kw = dict(tol=5e-2, chunk=20, max_iter=600, criterion="gap",
              gap_x_box=2.0)
    want = jstate.run_until_converged(
        functools.partial(jcp_inverse, _jblur, vol_shape=SHAPE, reg=0.05),
        jnp.asarray(b.numpy()), **kw)
    got = state.run_until_converged(
        functools.partial(cp_inverse, _blur, vol_shape=SHAPE, reg=0.05),
        b, **kw)
    assert len(got.loss) == len(want.loss) < 600
    np.testing.assert_allclose(got.loss.numpy(), want.loss, rtol=1e-8)
    # the operator passed explicitly, the solver not a partial of it
    def solver(b, n_iter, state=None, reg=0.05):
        return cp_inverse(_blur, b, SHAPE, n_iter=n_iter, reg=reg,
                          state=state)

    with pytest.raises(ValueError, match="needs the forward operator"):
        state.run_until_converged(solver, b, reg=0.05, **kw)
    explicit = state.run_until_converged(solver, b, reg=0.05,
                                         gap_operator=_blur, **kw)
    assert torch.equal(explicit.loss, got.loss)


def test_run_until_converged_gap_on_a_tgv_inverse_state():
    x0 = _noisy(8)[:1, :1]
    shape = tuple(x0.shape)
    b = _blur(torch.tensor(x0))
    solve = functools.partial(tgv_inverse, _blur, vol_shape=shape)
    with pytest.raises(ValueError, match="SAME alphas"):
        state.run_until_converged(solve, b, criterion="gap", gap_x_box=2.0)
    res = state.run_until_converged(solve, b, tol=0.5, chunk=20, max_iter=60,
                                    criterion="gap", gap_x_box=2.0,
                                    alpha1=0.05, alpha0=0.1)
    assert len(res.loss) % 20 == 0 and bool(torch.isfinite(res.loss).all())


def test_run_until_converged_chunk_of_one_and_max_iter():
    x0 = torch.tensor(_noisy(5))
    res = state.run_until_converged(cp.chambolle_pock, x0, tol=1e-5, chunk=1,
                                    max_iter=8, reg=0.3)
    assert len(res.loss) > 1  # loss[0] == loss[-1] does not stop a chunk of 1
    capped = state.run_until_converged(cp.chambolle_pock, x0, tol=0.0,
                                       chunk=5, max_iter=12, reg=0.3)
    assert len(capped.loss) == 12  # 5 + 5 + the remainder of 2


ERRORS = {
    "criterion": (lambda s, j: (s.chambolle_pock, j.chambolle_pock),
                  dict(criterion="dx"), "'loss' or 'gap'"),
    "no-reg": (lambda s, j: (s.chambolle_pock, j.chambolle_pock),
               dict(criterion="gap"), "SAME reg"),
    "no-state": (lambda s, j: (subgradient_descent, jgd),
                 dict(criterion="gap", reg=0.3), "primal-dual state"),
    "l1-gap": (lambda s, j: (s.chambolle_pock, j.chambolle_pock),
               dict(criterion="gap", reg=0.3, fidelity="l1"),
               "l2-fidelity denoising"),
    "no-dual": (lambda s, j: (s.chambolle_pock, j.chambolle_pock),
                dict(criterion="gap", reg=0.3, return_dual=False, chunk=2,
                     max_iter=2, fused=True), "return_dual=False"),
    "admm-gap": (lambda s, j: (admm.admm, jadmm.admm),
                 dict(criterion="gap", reg=0.3, chunk=2, max_iter=2),
                 "got ADMMState"),
}


@pytest.mark.parametrize("name", list(ERRORS))
def test_run_until_converged_errors_speak_as_jax(name):
    pick, kw, match = ERRORS[name]
    solver, jsolver = pick(cp, jcp)
    x0 = _noisy().astype(np.float32)
    with pytest.raises(ValueError, match=match) as got:
        state.run_until_converged(solver, torch.tensor(x0), **kw)
    with pytest.raises(ValueError) as want:
        jstate.run_until_converged(jsolver, jnp.asarray(x0), **kw)
    assert str(got.value) == str(want.value)


def test_run_until_converged_tgv_denoise_gap_is_refused():
    x0 = torch.tensor(_noisy()[:1, :1])
    with pytest.raises(ValueError, match="got TGVState"):
        state.run_until_converged(tgv_denoise, x0, criterion="gap", chunk=2,
                                  max_iter=2, alpha1=0.1, alpha0=0.2)
