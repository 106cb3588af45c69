"""One run of one cell: set-up, a warm solve, the measured window (or, with
``--trace 1``, the traced solves), the reference and the result line.

The window is a closed loop: one client sends its solves back to back,
each timed on the host clock from the call to the host read of its last
loss.  It closes at the end of the first solve that ends ``--seconds``
after it opened, so every solve in it is whole and every second of it is
counted.  The readers of ``metrics/`` turn what the run saw into the
metrics the cell reports."""

from __future__ import annotations

import contextlib
import gc
import json
import statistics
import sys
import time
from typing import NamedTuple, Optional

import torch

from . import compare, inputs, trace as tracing, yardstick
from .spec import Spec, entry

# modules that may not be loaded by the time a result is printed, compared
# by their top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "pytv4d_tpu")


class RunView(NamedTuple):
    """What a metric's reader reads."""
    facts: dict                 # shape, n_iter, Nd, bytes per element
    work_per_solve: int         # voxel-iterations of one solve
    latencies_s: list           # each solve's time
    window_s: float
    setup_s: float
    peak_bytes: int             # the window's peak of allocated memory
    trace: Optional[tracing.TraceView]
    peaks: dict                 # the data sheet's, for the card


def forbidden_modules():
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def log(*parts):
    print(*parts, file=sys.stderr, flush=True)


def _window(runner, seconds, trace, n_traced, keep, cuda):
    """The measured window, or with ``trace`` the traced solves: each
    solve's time and loss history, the output of solve ``keep``, the
    window's length and the trace's view."""
    prof = contextlib.nullcontext()
    if trace:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CPU] + (
            [ProfilerActivity.CUDA] if cuda else []))
    latencies, losses, kept = [], [], None
    with prof:
        w0 = time.perf_counter()
        while True:
            span = (torch.profiler.record_function(tracing.SOLVE_SPAN)
                    if trace else contextlib.nullcontext())
            with span:
                s = time.perf_counter()
                x, loss = runner.solve()
                e = time.perf_counter()
            latencies.append(e - s)
            losses.append(loss)
            if len(latencies) == keep + 1:
                kept = x
            del x
            if trace and len(latencies) >= n_traced:
                break
            if not trace and e - w0 >= seconds and kept is not None:
                break
        window_s = time.perf_counter() - w0
    view = tracing.from_profiler(prof) if trace else None
    return latencies, losses, kept, window_s, view


def run_cell(spec: Spec, name: str, seed: int, seconds: float, trace: bool,
             device, t0: float, config_override: Optional[dict] = None):
    """Run cell ``name`` on ``device`` and return its result dict, logging
    to stderr; ``t0`` is the process's start on ``time.perf_counter``."""
    cell = spec.cell(name)
    config = dict(spec.config(cell["config"]), **(config_override or {}))
    traffic = spec.traffic(cell["traffic"])
    cuda = torch.device(device).type == "cuda"

    runner = entry(traffic["entry"]).prepare(config, traffic, seed, device)
    runner.solve()                                   # the warm solve
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    setup_peak = torch.cuda.max_memory_allocated() if cuda else 0
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    keep = inputs.seed_of(seed) % int(traffic["keep_of_first"])
    latencies, losses, kept, window_s, view = _window(
        runner, seconds, trace, int(traffic["trace_solves"]), keep, cuda)
    peak = torch.cuda.max_memory_allocated() if cuda else 0

    run = RunView(runner.facts, runner.work_per_solve, latencies,
                  window_s, setup_s, peak, view,
                  yardstick.peaks(torch.cuda.get_device_name() if cuda
                                  else "cpu"))
    metrics = {}
    for m in spec.metrics(name, trace):
        value = spec.reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    lat = sorted(latencies)
    log(f"solves {len(lat)} window_s {window_s} setup_s {setup_s} "
        f"solve_s min {lat[0]} median {statistics.median(lat)} "
        f"max {lat[-1]}")

    # the program's state goes before the reference runs
    runner.release()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    x_ref, ref_losses, x_start = runner.reference()
    readings = compare.numbers(kept, losses, x_ref, ref_losses, x_start)
    del x_ref, x_start, kept
    failed = sum(1 for lo in losses if not bool(torch.isfinite(lo).all()))
    ok, checks = compare.judge(readings, spec.limits(name)["limits"])
    for k, v in readings.items():
        log(f"reading {k} {v}")

    result = {
        "correct": bool(ok and failed == 0),
        "attempted": len(latencies),
        "failed": failed,
        "metrics": metrics,
        "device": {
            "platform": "gpu" if cuda else "cpu",
            "kind": torch.cuda.get_device_name() if cuda else "cpu",
            "count": int(cell["chips"]),
            "memory_peak_bytes": int(max(setup_peak, peak)),
        },
    }
    if view is not None and view.device_ops:
        lo, hi = view.window
        result["device"]["busy_s"] = tracing.busy_us(view) / 1e6
        result["device"]["window_s"] = (hi - lo) / 1e6
        result["breakdown"] = tracing.breakdown(view)
    result["checks"] = checks
    for k, c in checks.items():
        log(f"check {k} {c['value']} limit {c['limit']}")
    return result


def main(argv=None, t0: Optional[float] = None) -> int:
    import argparse

    t0 = time.perf_counter() if t0 is None else t0
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    spec = Spec()
    chips = int(spec.cell(args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"needs {chips} CUDA device(s); found "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 2
    result = run_cell(spec, args.workload, args.seed, args.seconds,
                      bool(args.trace), "cuda", t0)
    found = forbidden_modules()
    if found:
        log("modules that may not be loaded:", " ".join(found))
        return 3
    print(json.dumps(result, allow_nan=False), flush=True)
    return 0
