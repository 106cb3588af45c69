"""The port's library utilities against the JAX package's: the image
metrics on ``tests/test_metrics.py``'s cases, ``assert_finite``,
``log_run``, ``force_read`` and ``IterationTimer`` (twins of
``tests/test_utils.py``'s), and the torch-only ``trace`` and
``device_kind`` on the CPU."""

import json

import numpy as np
import pytest
import torch

import pytv4d_tpu.utils as jutils
import pytv4d_tpu_torch.utils as tutils
from pytv4d_tpu_torch.core.config import TVConfig
from pytv4d_tpu_torch.solvers.tgv import TGVResult

CPU = dict(device="cpu")


@pytest.fixture
def pair():
    rng = np.random.default_rng(7)
    truth = rng.random((48, 64)) * 200.0
    noisy = truth + rng.normal(0, 12.0, truth.shape)
    return truth, noisy


@pytest.mark.parametrize("name,kw", [
    ("mse", {}), ("psnr", {}), ("psnr", {"data_range": 255.0}),
    ("nrmse", {}), ("nrmse", {"normalization": "min-max"}),
    ("nrmse", {"normalization": "mean"}), ("ssim", {}),
    ("ssim", {"win_size": 5}), ("ssim", {"k1": 0.02, "k2": 0.05})])
def test_metrics_match_jax(pair, name, kw):
    truth, noisy = pair
    want = getattr(jutils.metrics, name)(truth, noisy, **kw)
    got = getattr(tutils.metrics, name)(truth, noisy, **kw, **CPU)
    assert got == pytest.approx(want, rel=1e-12)
    # a CPU tensor computes where it lies, in its own precision
    got32 = getattr(tutils, name)(torch.tensor(truth, dtype=torch.float32),
                                  torch.tensor(noisy, dtype=torch.float32),
                                  **kw)
    assert got32 == pytest.approx(want, rel=1e-5)


def test_psnr_integer_dtype_range():
    rng = np.random.default_rng(0)
    a = rng.integers(0, 255, (32, 32), dtype=np.uint8)
    b = np.clip(a.astype(np.int32) + rng.integers(-5, 5, a.shape), 0,
                255).astype(np.uint8)
    assert tutils.psnr(a, b, **CPU) == pytest.approx(
        jutils.psnr(a, b), rel=1e-12)


def test_ssim_volume_and_map(pair):
    truth, noisy = pair
    vol_t = np.stack([truth, truth * 0.5 + 10]).reshape(2, 1, 48, 64)
    vol_n = np.stack([noisy, noisy * 0.5 + 10]).reshape(2, 1, 48, 64)
    dr = float(vol_t.max() - vol_t.min())
    assert tutils.ssim(vol_t, vol_n, data_range=dr, **CPU) == pytest.approx(
        jutils.ssim(vol_t, vol_n, data_range=dr), rel=1e-12)
    m = tutils.ssim(vol_t, vol_n, data_range=dr, return_map=True, **CPU)
    assert tuple(m.shape) == (2, 1, 48 - 6, 64 - 6)
    np.testing.assert_allclose(m.numpy(), np.asarray(jutils.ssim(
        vol_t, vol_n, data_range=dr, return_map=True)), rtol=1e-12,
        atol=1e-14)
    assert tutils.ssim(truth, truth.copy(), **CPU) == pytest.approx(1.0)


def test_metric_errors_match_jax(pair):
    truth, noisy = pair
    cases = [("mse", (truth, noisy[:-1]), {}),
             ("ssim", (truth, noisy), {"win_size": 4}),
             ("ssim", (np.ones((3, 3)), np.ones((3, 3))), {}),
             ("psnr", (np.ones((8, 8)), np.ones((8, 8)) * 2), {}),
             ("nrmse", (truth, noisy), {"normalization": "bogus"})]
    for name, args, kw in cases:
        with pytest.raises(ValueError) as want:
            getattr(jutils, name)(*args, **kw)
        with pytest.raises(ValueError) as got:
            getattr(tutils, name)(*args, **kw, **CPU)
        if name != "mse":  # the shape's spelling differs (tuple vs Size)
            assert str(got.value) == str(want.value)


def test_metrics_follow_the_device_rule(pair):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: numpy inputs go there")
    with pytest.raises(RuntimeError, match="CUDA device"):
        tutils.mse(*pair)


def test_assert_finite():
    tree = {"a": torch.ones(3), "b": [np.ones(2), (1.0, None)]}
    tutils.assert_finite(tree, "state")
    for bad, path in (({"a": torch.tensor([1.0, float("inf")])}, "['a']"),
                      ({"b": [np.ones(2), (np.nan,)]}, "['b'][1][0]")):
        with pytest.raises(FloatingPointError) as err:
            tutils.assert_finite(bad, "state")
        assert str(err.value) == (f"non-finite values in state{path}: 1 bad "
                                  f"elements")
    with pytest.raises(FloatingPointError) as want:
        jutils.assert_finite({"a": np.array([1.0, np.inf])}, "state")
    with pytest.raises(FloatingPointError) as got:
        tutils.assert_finite({"a": np.array([1.0, np.inf])}, "state")
    assert str(got.value) == str(want.value)
    # a NamedTuple's leaves are named by field
    with pytest.raises(FloatingPointError, match=r"state\.loss"):
        tutils.assert_finite(TGVResult(torch.ones(1), torch.ones(1),
                                       torch.tensor([torch.nan])), "state")


def test_log_run_matches_jax(tmp_path):
    cfg = TVConfig(scheme="central", reg_time=0.5)
    losses = torch.tensor([3.0, 2.0, 2.5], dtype=torch.float64)
    got = tutils.log_run(str(tmp_path / "t.jsonl"), "cp", cfg, losses,
                         wall_s=1.5, keep_series=True, note="x")
    from pytv4d_tpu.core.config import TVConfig as JConfig
    want = jutils.log_run(str(tmp_path / "j.jsonl"), "cp",
                          JConfig(scheme="central", reg_time=0.5),
                          np.array([3.0, 2.0, 2.5]), wall_s=1.5,
                          keep_series=True, note="x")
    for rec in (got, want):
        rec.pop("ts")
    assert got == want
    lines = (tmp_path / "t.jsonl").read_text().splitlines()
    assert len(lines) == 1 and json.loads(lines[0])["loss_min"] == 2.0
    empty = tutils.log_run(str(tmp_path / "t.jsonl"), "gd", {}, [])
    assert empty["n_iter"] == 0 and empty["loss_last"] is None


def test_iteration_timer_and_force_read():
    def run_n(n):
        return torch.arange(n, dtype=torch.float32) if n else torch.zeros(1)

    assert tutils.IterationTimer(run_n, warmup_iters=1).measure(
        4, repeats=1) > 0
    assert tutils.force_read({"a": torch.arange(10.0)}, [torch.ones(3)]) \
        == pytest.approx(28.0 + 3.0)
    assert tutils.force_read() == 0.0


def test_trace_writes_a_chrome_trace(tmp_path):
    with tutils.trace(str(tmp_path / "tr")) as prof:
        torch.ones(64).sum()
    assert prof.key_averages() is not None
    events = json.loads((tmp_path / "tr" / "trace.json").read_text())
    assert "traceEvents" in events


def test_device_kind():
    want = (torch.cuda.get_device_name(0) if torch.cuda.is_available()
            else "cpu")
    assert tutils.device_kind() == want


def test_utils_exports_the_jax_names():
    """What the JAX package's ``utils`` exports, the port's has, apart from
    what wraps JAX itself (``checkified``, the compile cache)."""
    jax_only = {"checkified", "enable_compile_cache", "warm_compile",
                "compile_cache"}
    names = {n for n in dir(jutils) if not n.startswith("_")} - jax_only
    missing = sorted(n for n in names if not hasattr(tutils, n))
    assert missing == []
