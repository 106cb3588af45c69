"""The port's norms are right on the first call in a fresh process.

torch's CPU sqrt kernel was seen to return values off by up to 3e-4
relative (float32) on its first call in a process when that call ran on
several threads (torch 2.13.0+cpu, 8-core AVX-512 CPU, about one process
in five); the CP dual prox and the TV norms went wrong with it.  Each case
starts fresh processes that take the port's L2,1 norm as their first sqrt
and checks it against numpy."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_PROCESSES = 8
CODE = """
import numpy as np, torch
from pytv4d_tpu_torch.ops.operators import compute_L21_norm
a = np.random.default_rng(0).random((4, 6, 3, 16, 128)).astype("{dtype}")
_, norms = compute_L21_norm(torch.tensor(a), return_array=True)
ref = np.sqrt(np.sum(np.square(a), axis=1))
print(float(np.max(np.abs(norms.numpy() - ref) / ref)))
"""


@pytest.mark.parametrize("dtype,rtol", [("float32", 2.4e-7),
                                        ("float64", 4.5e-16)])
def test_first_sqrt_in_a_process(dtype, rtol):
    env = dict(os.environ, OMP_NUM_THREADS="8")
    procs = [subprocess.Popen([sys.executable, "-c", CODE.format(dtype=dtype)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True)
             for _ in range(N_PROCESSES)]
    errs = []
    for p in procs:
        out, err = p.communicate(timeout=120)
        assert p.returncode == 0, err
        errs.append(float(out))
    assert max(errs) <= rtol, errs
