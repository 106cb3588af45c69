"""The example twins (``examples/torch_*.py``) run end to end on the CPU,
each in its own process with ``--device cpu``: exit 0 and the final "OK"
line.  ``torch_d_ct_reconstruction.py``, the longest, has
``tests/test_torch_examples_ct.py`` to itself, so that the two files run on
two workers."""

import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def run_example(name, device="cpu", timeout=600):
    """Run ``examples/<name>.py --device <device>`` on one CPU thread (the
    test workers hold the other cores; a process with a thread per core
    beside them spins its thread pool for minutes): the completed
    process."""
    env = dict(os.environ, OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    return subprocess.run(
        [sys.executable, os.path.join(ROOT, "examples", f"{name}.py"),
         "--device", device], capture_output=True, text=True,
        timeout=timeout, cwd=ROOT, stdin=subprocess.DEVNULL, env=env)


@pytest.mark.parametrize("name", (
    "torch_a_getting_started", "torch_b_schemes_math", "torch_c_4d_sharded",
    "torch_e_tgv", "torch_f_inverse_problems"))
def test_example_twin_runs_on_the_cpu(name):
    done = run_example(name)
    assert done.returncode == 0, done.stderr[-3000:]
    assert done.stdout.strip().splitlines()[-1] == "OK", done.stdout[-3000:]


@pytest.mark.skipif(torch.cuda.is_available(),
                    reason="the machine has a CUDA device")
def test_an_example_twin_does_not_fall_back_to_the_cpu():
    """Asked for the card where there is none, a twin raises."""
    done = run_example("torch_b_schemes_math", device="cuda")
    assert done.returncode != 0
    assert "no CUDA device" in done.stderr
    assert "OK" not in done.stdout
