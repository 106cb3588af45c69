"""``examples/torch_d_ct_reconstruction.py`` runs end to end on the CPU
with ``--device cpu``: exit 0 and the final "OK" line (the other twins:
``tests/test_torch_examples.py``)."""

from test_torch_examples import run_example


def test_ct_example_twin_runs_on_the_cpu():
    done = run_example("torch_d_ct_reconstruction")
    assert done.returncode == 0, done.stderr[-3000:]
    assert done.stdout.strip().splitlines()[-1] == "OK", done.stdout[-3000:]
