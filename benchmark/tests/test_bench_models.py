"""The yardstick's frozen arithmetic, pinned to what it counts from shapes,
and each metric reader on a synthetic trace."""

import pytest

from benchmark import trace as tracing
from benchmark import yardstick
from benchmark.harness import RunView
from benchmark.spec import Spec

VOL = (96, 16, 512, 512)
N = 96 * 16 * 512 * 512


def test_cp_step_bytes_per_voxel():
    # hybrid with z and t channels: Nd 8; f32 128 B a voxel, bf16 dual 80
    assert sum(yardstick.cp_step_parts(VOL, 8)) == 128 * N
    assert yardstick.cp_step_parts(VOL, 8, 4, 2) == (48 * N, 32 * N)
    assert sum(yardstick.cp_step_parts(VOL, 4, 2, 2)) == 40 * N


def test_tv_bytes_per_voxel():
    assert yardstick.tv_bytes(VOL) == (8 * N, 12 * N)
    assert yardstick.tv_bytes(VOL, 2) == (6 * N, 8 * N)


def test_ct_tv_bytes_per_voxel():
    ct = (16, 4, 512, 512)
    n = 16 * 4 * 512 * 512
    assert yardstick.ct_tv_bytes(ct, 8) == (68 * n, 44 * n, 8 * n)


def test_peaks_of_the_card():
    p = yardstick.peaks("NVIDIA H100 80GB HBM3")
    assert p["hbm_bytes_per_s"] == 3.35e12
    assert yardstick.peaks("some other card") == p


def _op(name, start, end):
    return tracing.Op(name, float(start), float(end))


def _run(view, n_iter=2, shape=(2, 2, 4, 4), latencies=(0.5, 1.5),
         window=2.5, peak=3 * 2 ** 30):
    facts = {"shape": shape, "n_iter": n_iter, "Nd": 8, "bpe": 4,
             "dual_bpe": 4}
    return RunView(facts, n_iter * 64, list(latencies), window, 7.0,
                   peak, view, yardstick.peaks("NVIDIA H100 80GB HBM3"))


def _view():
    # two solves of two iterations: B1 then B2, 10 us each; a memset before
    # each solve's loop and a copy after it; a host operation in each gap
    dev, host = [], []
    spans = [_op(tracing.SOLVE_SPAN, 0, 100), _op(tracing.SOLVE_SPAN, 100,
                                                   200)]
    for s0 in (0, 100):
        dev.append(_op("Memset (Device)", s0 + 5, s0 + 10))
        t = s0 + 20
        for _ in range(2):
            dev.append(_op("void cp_dual_spec_kernel<(Table)7, float>", t,
                           t + 10))
            dev.append(_op("void cp_primal_spec_kernel<(Table)7>", t + 10,
                           t + 20))
            t += 25
        dev.append(_op("Memcpy DtoD (Device -> Device)", s0 + 80, s0 + 90))
        host.append(_op("aten::zeros", s0, s0 + 12))
        host.append(_op("aten::item", s0 + 65, s0 + 100))
    return tracing.TraceView(sorted(dev, key=lambda o: o.start), spans,
                             host)


def _read(name, run):
    return Spec().reader(name).read(run)


def test_end_to_end_readers():
    run = _run(None)
    assert _read("denoise_gvox_per_s", run) == pytest.approx(
        2 * 128 / 2.5 / 1e9)
    assert _read("peak_mem_gib", run) == 3.0
    assert _read("setup_s", run) == 7.0
    lat = [0.001 * i for i in range(1, 201)]      # 1 .. 200 ms
    assert _read("recon_solve_ms_p95", _run(None, latencies=lat)) == \
        pytest.approx(190.0)


def test_per_layer_readers_on_a_synthetic_trace():
    run = _run(_view())
    # 12 device operations over 2 solves x 2 iterations
    assert _read("launches_per_it.denoise", run) == 3.0
    # busy: per solve 5 (memset) + 2 x 20 (kernels) + 10 (copy) = 55 of 100
    assert _read("idle_pct.denoise", run) == pytest.approx(45.0)
    # the loop runs 20 .. 65 in each solve: 100 - 45 us outside it
    assert _read("solve_overhead_ms.denoise", run) == pytest.approx(0.055)
    # 4 B1 and 4 B2 launches, 40 us each in all, at (2, 2, 4, 4)
    b1, b2 = yardstick.cp_step_parts((2, 2, 4, 4), 8)
    want = 100 * (4 * b1 + 4 * b2) / 80e-6 / 3.35e12
    assert _read("cp_kernels_roofline_pct", run) == pytest.approx(want)
    # of the CT's TV half only B2 ran: its bytes over its time
    b2ct = yardstick.ct_tv_bytes((2, 2, 4, 4), 8)[1]
    assert _read("ct_tv_kernels_roofline_pct", run) == pytest.approx(
        100 * 4 * b2ct / 40e-6 / 3.35e12)
    # nothing of B3 / B4 or of the projector: nothing to read
    for name in ("tv_kernels_roofline_pct", "projector_ms_per_it"):
        assert _read(name, run) is None
    bd = tracing.breakdown(run.trace)
    assert bd["device_ops"][0] == ["void cp_dual_spec_kernel<(Table)7, "
                                   "float>", pytest.approx(40e-6)]
    gaps = dict(bd["idle_gaps"])
    # 65 .. 80 and 90 .. 105 (one gap across the solves' border, its middle
    # in the first's read), then 165 .. 180 and 190 .. 200
    assert gaps["aten::item"] == pytest.approx(55e-6)
    assert gaps[tracing.BETWEEN_OPS] == pytest.approx(2 * (10e-6 + 5e-6))


def test_readers_without_a_trace_give_nothing():
    run = _run(None)
    for m in Spec().bench["per_layer"]:
        assert _read(m["name"], run) is None
