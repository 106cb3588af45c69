"""The benchmark harness (the port of ``pytv4d_tpu/bench``): solver and CT
throughput and the sharding sweeps, as dicts of rates with the JAX
package's keys."""

from . import harness
from .harness import (
    bench_ct,
    bench_ct_cone,
    bench_ct_production,
    bench_solver,
    weak_scaling,
    weak_scaling_tgv,
)
