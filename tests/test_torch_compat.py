"""The reference-layout compat surface of the port (``pytv/__init__.py:43-63``,
SURVEY.md section 2.2): ``tv_CPU`` / ``tv_operators_CPU`` against the
recorded reference outputs and the README value, the package-level test
battery, the module layout and return conventions a reference user relies
on, and the public API surface the JAX package's ``test_api_surface.py``
guards, less its TPU names and the items still queued."""

import os

import numpy as np
import pytest
import torch

import pytv4d_tpu_torch as pytv
from pytv4d_tpu_torch import testing, tv_CPU, tv_operators_CPU

GOLDEN = os.path.join(os.path.dirname(__file__), "golden")
SCHEMES = ("upwind", "downwind", "central", "hybrid")
# tests/test_golden.py's cases
CASES = {
    "base": dict(),
    "time": dict(reg_time=0.6, reg_z_over_reg=0.4),
    "mask": dict(reg_time=0.5, factor_reg_static=0.25),
    "noz": dict(reg_z_over_reg=0.0, reg_time=1.0),
}
BOUNDARY_CASES = {
    "nz2": dict(reg_time=0.7),
    "m2": dict(reg_time=0.7, reg_z_over_reg=0.6),
    "odd": dict(reg_time=0.5),
}
TOL = dict(rtol=1e-12, atol=1e-12)


@pytest.fixture(scope="module")
def golden():
    return np.load(os.path.join(GOLDEN, "golden_small.npz"))


@pytest.fixture(scope="module")
def golden_boundary():
    return np.load(os.path.join(GOLDEN, "golden_boundary.npz"))


def _check(fixture, key, img, kw):
    D = getattr(tv_operators_CPU, f"D_{key.split('_')[0]}")(img, **kw)
    assert isinstance(D, np.ndarray) and D.dtype == np.float64
    np.testing.assert_allclose(D, fixture[f"{key}_D"], **TOL)
    DT = getattr(tv_operators_CPU, f"D_T_{key.split('_')[0]}")(
        fixture[f"{key}_D"], **kw)
    np.testing.assert_allclose(DT, fixture[f"{key}_DT"], **TOL)
    tv, G = getattr(tv_CPU, f"tv_{key.split('_')[0]}")(img, **kw)
    assert isinstance(tv, np.float64) and isinstance(G, np.ndarray)
    np.testing.assert_allclose(tv, float(fixture[f"{key}_tv"]), rtol=1e-12)
    np.testing.assert_allclose(G, fixture[f"{key}_G"], **TOL)


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("case", list(CASES))
def test_golden_small(golden, scheme, case):
    kw = dict(CASES[case])
    if case == "mask":
        kw["mask_static"] = golden["mask"]
    _check(golden, f"{scheme}_{case}", golden["img4d"], kw)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_golden_2d(golden, scheme):
    img = golden["img2d"]
    key = f"{scheme}_2d"
    D = getattr(tv_operators_CPU, f"D_{scheme}")(img)
    np.testing.assert_allclose(D, golden[f"{key}_D"], rtol=1e-14,
                               atol=1e-14)
    tv, G = getattr(tv_CPU, f"tv_{scheme}")(img)
    np.testing.assert_allclose(tv, float(golden[f"{key}_tv"]), rtol=1e-14)
    np.testing.assert_allclose(G, golden[f"{key}_G"], rtol=1e-14, atol=1e-14)


@pytest.mark.parametrize("scheme", SCHEMES)
@pytest.mark.parametrize("case", list(BOUNDARY_CASES))
def test_golden_boundary(golden_boundary, scheme, case):
    """central x Nz == 2 has no recorded output (the reference crashes
    there, SURVEY.md section 2.4.1): the other 11 pairs."""
    if scheme == "central" and case == "nz2":
        assert f"{scheme}_{case}_D" not in golden_boundary
        return
    _check(golden_boundary, f"{scheme}_{case}",
           golden_boundary[f"img_{case}"], dict(BOUNDARY_CASES[case]))


def test_readme_headline_values():
    """``README.md:91``'s seeded value and BASELINE.md's siblings, in float64
    on the CPU."""
    np.random.seed(0)
    img = np.random.rand(20, 4, 100, 100)
    want = {
        "hybrid": 532166.8251801673,
        "upwind": 516111.71829010965,
        "downwind": 516100.5170811774,
        "central": 256841.60927402685,
    }
    for scheme, value in want.items():
        tv, _ = getattr(tv_CPU, f"tv_{scheme}")(img)
        assert tv == pytest.approx(value, rel=1e-12), scheme
    tv, _ = pytv.tv_CPU.tv_hybrid(img, reg_time=1.0)
    assert tv == pytest.approx(599262.1919748212, rel=1e-12)


@pytest.mark.parametrize("scheme", SCHEMES)
def test_cpu_modules_match_jax(scheme):
    """The same seeded input through the JAX package's numpy modules and the
    port's, with a static mask, time coupling and the grad norms: 1e-12."""
    import pytv4d_tpu.tv_CPU as jtv
    import pytv4d_tpu.tv_operators_CPU as jops

    rng = np.random.default_rng(11)
    img = rng.random((3, 4, 9, 10))
    kw = dict(reg_time=0.4, reg_z_over_reg=0.7,
              mask_static=rng.random((1, 1, 9, 10)) > 0.5,
              factor_reg_static=0.3)
    want = getattr(jtv, f"tv_{scheme}")(img, return_grad_norms=True, **kw)
    got = getattr(tv_CPU, f"tv_{scheme}")(img, return_grad_norms=True, **kw)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, np.asarray(b), **TOL)
    D = getattr(tv_operators_CPU, f"D_{scheme}")(img, **kw)
    np.testing.assert_allclose(D, getattr(jops, f"D_{scheme}")(img, **kw),
                               **TOL)
    np.testing.assert_allclose(
        getattr(tv_operators_CPU, f"D_T_{scheme}")(D, **kw),
        getattr(jops, f"D_T_{scheme}")(D, **kw), **TOL)
    assert tv_operators_CPU.compute_L21_norm(D) == pytest.approx(
        float(jops.compute_L21_norm(D)), rel=1e-12)


def test_cpu_modules_mask_l21_and_grad_norms():
    """The reference's ``mask`` (fixed: applied as ``where(mask, img, 0)``),
    ``return_grad_norms`` (zeros as +inf) and ``compute_L21_norm``, numpy
    in and out."""
    rng = np.random.default_rng(3)
    img = rng.random((3, 2, 8, 8))
    mask = rng.random((3, 2, 8, 8)) > 0.3
    tv, G = tv_CPU.tv_hybrid(img, mask=mask, reg_time=0.5)
    tv_ref, G_ref = tv_CPU.tv_hybrid(np.where(mask, img, 0.0), reg_time=0.5)
    assert tv == tv_ref and np.array_equal(G, G_ref)
    flat = np.zeros((1, 1, 4, 4))
    tv, G, norms = tv_CPU.tv_upwind(flat, return_grad_norms=True)
    assert tv == 0.0 and np.isinf(norms).all() and not G.any()
    D = tv_operators_CPU.D_hybrid(img, reg_time=0.5)
    l21, arr = tv_operators_CPU.compute_L21_norm(D, return_array=True)
    assert isinstance(l21, np.float64) and arr.shape == img.shape
    assert l21 == tv_operators_CPU.compute_L21_norm(D)
    assert l21 == pytest.approx(tv_CPU.tv_hybrid(img, reg_time=0.5)[0],
                                rel=1e-14)
    # a float32 array computes in float32, as the reference's numpy does
    assert tv_operators_CPU.D_hybrid(img.astype(np.float32)).dtype == \
        np.float32


def test_run_cpu_tests_passes(capsys):
    assert pytv.run_CPU_tests() is True
    out = capsys.readouterr().out
    assert out.count("[PASS]") == 8 and "All CPU tests passed." in out


def test_run_gpu_tests_needs_the_card():
    """The GPU battery runs on the CUDA device; without one it raises and
    never falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: chip_smoke.py runs the "
                    "battery there")
    with pytest.raises(RuntimeError, match="CUDA device"):
        pytv.run_GPU_tests()
    with pytest.raises(RuntimeError, match="CUDA device"):
        pytv.tests.run_GPU_tests()


def test_oracles_catch_a_wrong_operator():
    """The battery's oracles fail where they should: a D_T that is not D's
    transpose, and two arrays apart by more than the tolerance."""
    with pytest.raises(AssertionError, match="adjointness"):
        testing.test_transpose(
            lambda x: tv_operators_CPU.D_upwind(x),
            lambda y: 2.0 * tv_operators_CPU.D_T_upwind(y), (2, 1, 6, 6), 3,
            n=1)
    with pytest.raises(AssertionError, match="relative error"):
        testing.test_equal(np.ones(4), np.ones(4) * 1.1, 1e-3, "ones")
    assert testing.test_equal(np.zeros(3), np.zeros(3)) == 0.0


def test_reference_module_layout():
    """Every name a reference user touches exists (tests/test_compat.py's
    list less the TPU modules)."""
    for mod in ("tv_CPU", "tv_GPU", "tv_operators_CPU", "tv_operators_GPU",
                "utils", "tests"):
        assert hasattr(pytv, mod), mod
    for scheme in SCHEMES:
        assert hasattr(pytv.tv_CPU, f"tv_{scheme}")
        assert hasattr(pytv.tv_GPU, f"tv_{scheme}")
        assert hasattr(pytv.tv_operators_CPU, f"D_{scheme}")
        assert hasattr(pytv.tv_operators_CPU, f"D_T_{scheme}")
        assert hasattr(pytv.tv_operators_GPU, f"D_{scheme}")
    assert callable(pytv.utils.cameraman) and callable(pytv.cameraman)
    assert pytv.cameraman is pytv.utils.cameraman
    assert callable(pytv.run_CPU_tests) and callable(pytv.run_GPU_tests)
    assert pytv.tests.run_CPU_tests is pytv.run_CPU_tests
    assert callable(pytv.tests.test_equal)
    assert callable(pytv.tv_operators_GPU.compute_L21_norm)
    assert isinstance(pytv.__version__, str)
    for name in ("tv_TPU", "tv_operators_TPU", "run_TPU_tests"):
        assert not hasattr(pytv, name), name


def _has(mod, names):
    missing = [n for n in names.split() if not hasattr(mod, n)]
    assert not missing, f"{mod.__name__} missing {missing}"


def test_package_level_surface():
    _has(pytv, "tv_CPU tv_GPU tv_operators_CPU tv_operators_GPU "
               "run_CPU_tests run_GPU_tests tests "
               "tv_hybrid tv_upwind tv_downwind tv_central "
               "D_hybrid D_T_hybrid compute_L21_norm tv_and_subgrad "
               "cameraman models solvers parallel utils ops core kernels "
               "TVConfig SCHEMES __version__")


def test_solver_surface():
    _has(pytv.solvers,
         "chambolle_pock chambolle_pock_precond subgradient_descent admm "
         "fista tgv_denoise cp_inverse tgv_inverse reg_discrepancy pd_gap "
         "run_until_converged run_checkpointed save_state load_state "
         "save_state_orbax load_state_orbax exact_transpose power_iteration "
         "gaussian_blur_operator fidelity_dual_prox fidelity_loss "
         "pd_gap_inverse tgv_gap_inverse fidelity_conjugate "
         "CPState CPPrecondState CPResult InverseState InverseResult "
         "TGVResult TGVInverseState ADMMState FISTAResult GDResult "
         "cp_step default_tau")


def test_models_surface():
    """The spectral projectors (queue A item 15) are in, as the module
    ``models.ct_spectral`` and its eight names, and so are the sinogram
    shardings (16b) and the ``bench`` harness's six functions (17)."""
    names = ("radon radon_fan radon_cone make_projector make_fan_projector "
             "make_cone_projector cp_reconstruct tgv_reconstruct fbp fdk "
             "sart estimate_op_norm FanBeamGeometry ConeBeamGeometry "
             "SARTResult CPReconResult clear_projector_cache")
    spectral = ("radon_spectral make_spectral_projector radon_fan_spectral "
                "make_fan_spectral_projector radon_cone_spectral "
                "make_cone_spectral_projector fdk_spectral "
                "cone_spectral_precond_sums")
    _has(pytv.models, "TVDenoiser denoise_tv_chambolle add_noise ct_spectral "
         + names + " " + spectral)
    _has(pytv.models.ct, names)
    _has(pytv.models.ct_spectral, spectral)
    import pytv4d_tpu.models as jmodels

    for name in spectral.split():
        assert hasattr(jmodels, name), name
    _has(pytv.models.ct, "sinogram_sharding cone_sinogram_sharding")
    # the root does not import the harness, as the JAX package's does not
    import pytv4d_tpu_torch.bench  # noqa: F401

    _has(pytv.bench, "bench_ct bench_ct_cone bench_ct_production "
                     "bench_solver weak_scaling weak_scaling_tgv")


def test_parallel_and_utils_surface():
    """``tgv_sharded`` and ``multihost`` (16b) and the timer, tracing,
    checks, run log and metrics (7, 17) are still queued; the sharding
    specs and the compile cache are not to port."""
    _has(pytv.parallel,
         "make_mesh shard_volume sharded_D sharded_D_T "
         "sharded_tv_and_subgrad make_sharded_cp_solver "
         "make_sharded_cp_solver_fused make_sharded_gd_solver_fused")
    _has(pytv.utils,
         "cameraman synthetic_phantom as_volume has_real_cameraman "
         "cp_traffic_model tgv_traffic_model roofline_fraction")
