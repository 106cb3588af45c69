"""The control of each cell, on the card at the cell's own size: the
program's readings against the reference on several seeds, then the
control's (``limits/<cell>.json``: the program with its own lower-precision
path switched on), in one process.  Every program reading must sit within
its limit, and the control must fail one of the cell's numbers on every
seed.  Needs a CUDA device and ``nvcc``, and skips without them.

The readings the limits were set from came from this module run as a
script on the card, one cell a process:

    python3 -m benchmark.tests.test_bench_control_card <cell> \\
        --seeds 1 2 ... --control-seeds 101 102 103

which prints one JSON line per seed."""

import argparse
import gc
import json
import sys

import pytest
import torch

from benchmark import compare
from benchmark.spec import Spec, entry

CELLS = ("cp4d_f32", "ct_par_tv", "gd4d_f32")


def readings(cell: str, seed: int, control: bool, spec: Spec = None):
    """The cell's numbers for one solve on ``seed``, with the program as the
    traffic states it or with the cell's control switched on."""
    spec = spec or Spec()
    w = spec.cell(cell)
    traffic = dict(spec.traffic(w["traffic"]))
    if control:
        traffic.update(spec.limits(cell)["control"])
    runner = entry(traffic["entry"]).prepare(
        spec.config(w["config"]), traffic, seed, "cuda")
    x, loss = runner.solve()
    runner.release()
    gc.collect()
    torch.cuda.empty_cache()
    x_ref, ref_losses, x_start = runner.reference()
    out = compare.numbers(x, [loss], x_ref, ref_losses, x_start)
    del x, x_ref, x_start
    gc.collect()
    torch.cuda.empty_cache()
    return out


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
