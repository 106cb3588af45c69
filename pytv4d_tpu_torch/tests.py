"""The reference exposes its battery as the ``pytv.tests`` module
(``pytv/tests.py``, re-exported by ``pytv/__init__.py:57``); the
implementation lives in :mod:`pytv4d_tpu_torch.testing`."""

from .testing import (  # noqa: F401
    run_CPU_tests,
    run_GPU_tests,
    test_2D_to_3D,
    test_cross_implementation,
    test_equal,
    test_operator_transpose,
    test_transpose,
)
