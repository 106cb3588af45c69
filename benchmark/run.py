"""The benchmark of ``pytv4d_tpu_torch``: one run of one cell.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout (``python3 -m benchmark.run`` works too).  It
needs the CUDA devices the cell asks for, and exits non-zero without a
result where they are missing.  The last line of its standard output is
the result as one JSON object; its standard error ends with each number
compared for ``correct`` beside its limit."""

import time

T0 = time.perf_counter()

import os  # noqa: E402
import sys  # noqa: E402

if __name__ == "__main__":
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from benchmark.harness import main

    sys.exit(main(t0=T0))
