"""The control of the cells ``tgv4d_f32`` and ``cp4d_bf16`` on the card at
the cells' own size, as ``test_bench_control_card.py`` holds the first
three (its ``readings()``): every program reading within its limit, and
the control (``limits/<cell>.json``: the program on a bfloat16 volume for
TGV, the reference's CP loop through float8 for bfloat16 CP) failing one of
the cell's numbers on every seed.  Also the TGV objective kernel against
its plain version on the first 4 z-planes of the TGV cell's volume, in
float32 and bfloat16 storage.  Needs a CUDA device and ``nvcc``, and skips
without them.

The readings the limits were set from came from this module run as a
script on the card, one cell a process:

    python3 -m benchmark.tests.test_bench_control_card_new <cell> \\
        --seeds 1 2 ... --control-seeds 101 102 103

which prints one JSON line per seed."""

import argparse
import json
import sys

import pytest
import torch

from benchmark import compare, inputs
from benchmark.spec import Spec
from benchmark.tests.test_bench_control_card import readings

CELLS = ("tgv4d_f32", "cp4d_bf16")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the cells run on the card")


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes(card, cell):
    limits = Spec().limits(cell)["limits"]
    for seed in (7, 2 ** 31 + 11):
        r = readings(cell, seed, control=False)
        assert compare.judge(r, limits)[0], (seed, r)
    for seed in (101, 102, 103):
        r = readings(cell, seed, control=True)
        assert not compare.judge(r, limits)[0], (seed, r)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_objective_kernel_at_the_cell_width(card, dtype):
    """The objective kernel against ``tgv_objective`` in float64 on the
    same stored values: the noisy volume's first 4 z-planes as x0, x a
    step away and a w of the size of its gradient."""
    from pytv4d_tpu_torch.kernels.tgv_stream import tgv_stream_objective
    from pytv4d_tpu_torch.solvers.tgv import tgv_objective

    spec = Spec()
    cfg = spec.config("tgv4d")
    shape = (4,) + tuple(cfg["shape"][1:])
    x0 = inputs.noisy_volume(shape, 3, cfg, "cuda")
    g = inputs.generator(4, "cuda")
    x = x0 + 5.0 * torch.randn(shape, generator=g, device="cuda")
    w = 3.0 * torch.randn((4, 4) + shape[1:], generator=g, device="cuda")
    x, w, x0 = (t.to(dtype) for t in (x, w, x0))
    got = tgv_stream_objective(x, w, x0, "4d", cfg["alpha1"], cfg["alpha0"],
                               cfg["norm"])
    want = tgv_objective(x.double(), w.double(), x0.double(), "4d",
                         cfg["alpha1"], cfg["alpha0"], cfg["norm"])
    rel = abs(float(got) - float(want)) / abs(float(want))
    assert rel <= 1e-5, rel


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("cell", choices=CELLS)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    a = ap.parse_args(argv)
    spec = Spec()
    for control, seeds in ((False, a.seeds), (True, a.control_seeds)):
        for seed in seeds:
            r = readings(a.cell, seed, control, spec)
            print(json.dumps({"cell": a.cell, "seed": seed,
                              "control": control, **r}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
