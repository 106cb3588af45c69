"""The port's D / D_T / TV norms against the JAX package's operators and
the reference's golden fixtures, in float64 on the CPU."""

import os

import numpy as np
import pytest
import torch

import pytv4d_tpu.ops.operators as jops
import pytv4d_tpu_torch.ops.operators as tops

SCHEMES = ("upwind", "downwind", "central", "hybrid")
GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
CASES = {
    "base": dict(),
    "time": dict(reg_time=0.6, reg_z_over_reg=0.4),
    "mask": dict(reg_time=0.5, factor_reg_static=0.25),
    "noz": dict(reg_z_over_reg=0.0, reg_time=1.0),
}
TOL = dict(rtol=1e-12, atol=1e-12)


def _t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


@pytest.fixture(scope="module")
def golden():
    return np.load(os.path.join(GOLDEN, "golden_small.npz"))


@pytest.fixture(scope="module")
def golden_boundary():
    return np.load(os.path.join(GOLDEN, "golden_boundary.npz"))


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("case", ["base", "time", "mask", "wt", "noz"])
def test_operators_match_jax(scheme, case):
    rng = np.random.default_rng(3)
    img = rng.random((4, 3, 8, 9))  # non-square plane
    kw = dict(CASES.get(case, dict(reg_time=0.8)))
    if case == "mask":
        kw["mask_static"] = rng.random((1, 1, 8, 9)) < 0.5
    if case == "wt":
        kw["weight_time"] = rng.random((1, 1, 8, 9)) + 0.5
    tkw = {k: (torch.as_tensor(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    Dj = np.asarray(jops.D(img, scheme, xp=np, **kw))
    Dt = tops.D(_t(img), scheme, **tkw)
    np.testing.assert_allclose(Dt.numpy(), Dj, **TOL)
    y = rng.standard_normal(Dj.shape)
    np.testing.assert_allclose(tops.D_T(_t(y), scheme, **tkw).numpy(),
                               np.asarray(jops.D_T(y, scheme, xp=np, **kw)),
                               **TOL)
    for norm in ("iso", "aniso", "huber"):
        vt, at = tops.tv_norm(Dt, norm, return_array=True, huber_delta=0.3)
        vj, aj = jops.tv_norm(Dj, norm, return_array=True, huber_delta=0.3,
                              xp=np)
        np.testing.assert_allclose(float(vt), float(vj), rtol=1e-12)
        np.testing.assert_allclose(at.numpy(), np.asarray(aj), **TOL)


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("case", list(CASES))
def test_golden_small(golden, scheme, case):
    kw = dict(CASES[case])
    if case == "mask":
        kw["mask_static"] = torch.as_tensor(golden["mask"])
    key = f"{scheme}_{case}"
    D = tops.D(_t(golden["img4d"]), scheme, **kw)
    np.testing.assert_allclose(D.numpy(), golden[f"{key}_D"], **TOL)
    DT = tops.D_T(_t(golden[f"{key}_D"]), scheme, **kw)
    np.testing.assert_allclose(DT.numpy(), golden[f"{key}_DT"], **TOL)
    np.testing.assert_allclose(float(tops.compute_L21_norm(D)),
                               float(golden[f"{key}_tv"]), rtol=1e-12)


BOUNDARY_CASES = {
    "nz2": dict(reg_time=0.7),
    "m2": dict(reg_time=0.7, reg_z_over_reg=0.6),
    "odd": dict(reg_time=0.5),
}


@pytest.mark.parametrize("scheme,case", [
    (s, c) for s in SCHEMES for c in BOUNDARY_CASES
    if (s, c) != ("central", "nz2")])  # not in the fixture
def test_golden_boundary(golden_boundary, scheme, case):
    """Nz == 2 / M == 2 (the central scheme's fwd fallback) and odd sizes."""
    kw = BOUNDARY_CASES[case]
    key = f"{scheme}_{case}"
    D = tops.D(_t(golden_boundary[f"img_{case}"]), scheme, **kw)
    np.testing.assert_allclose(D.numpy(), golden_boundary[f"{key}_D"], **TOL)
    DT = tops.D_T(_t(golden_boundary[f"{key}_D"]), scheme, **kw)
    np.testing.assert_allclose(DT.numpy(), golden_boundary[f"{key}_DT"], **TOL)
    np.testing.assert_allclose(float(tops.compute_L21_norm(D)),
                               float(golden_boundary[f"{key}_tv"]),
                               rtol=1e-12)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_adjointness(scheme):
    """<D x, y> = <x, D^T y>, with a weight_time field and on the small-axis
    shapes where the central scheme falls back to fwd differences."""
    rng = np.random.default_rng(5)
    for shape in ((3, 4, 7, 6), (2, 2, 5, 5), (1, 1, 6, 4)):
        kw = dict(reg_time=0.7, reg_z_over_reg=0.4,
                  weight_time=torch.as_tensor(rng.random(shape[2:]) + 0.5))
        x = _t(rng.standard_normal(shape))
        Dx = tops.D(x, scheme, **kw)
        y = _t(rng.standard_normal(tuple(Dx.shape)))
        lhs = float(torch.sum(Dx * y))
        rhs = float(torch.sum(x * tops.D_T(y, scheme, **kw)))
        assert lhs == pytest.approx(rhs, rel=1e-12, abs=1e-12)


def test_readme_headline_value():
    """README.md:91: tv_hybrid(rand(20,4,100,100)) after np.random.seed(0)."""
    np.random.seed(0)
    img = _t(np.random.rand(20, 4, 100, 100))
    val = float(tops.compute_L21_norm(tops.D_hybrid(img)))
    assert val == pytest.approx(532166.8251801673, rel=1e-13)
    np.random.seed(0)
    jval = float(jops.compute_L21_norm(
        jops.D_hybrid(np.random.rand(20, 4, 100, 100), xp=np), xp=np))
    assert val == pytest.approx(jval, rel=1e-13)


def test_error_messages_match_jax():
    for args in ((np.zeros((3, 4)),), ):
        with pytest.raises(ValueError) as a:
            tops.D(_t(*args))
        with pytest.raises(ValueError) as b:
            jops.D(*args, xp=np)
        assert str(a.value) == str(b.value)
    y = np.zeros((2, 3, 2, 4, 4))
    with pytest.raises(ValueError) as a:
        tops.D_T(_t(y), "hybrid", reg_time=0.5)
    with pytest.raises(ValueError) as b:
        jops.D_T(y, "hybrid", reg_time=0.5, xp=np)
    assert str(a.value) == str(b.value)
    assert [tops.mask_enabled(m) for m in (None, False, [], np.ones(2))] == \
        [jops.mask_enabled(m) for m in (None, False, [], np.ones(2))]
