"""Structured run logging: one JSON line per finished solve, with its
config, a summary of the loss series and its timing.  The port of
``pytv4d_tpu/utils/runlog.py``."""

from __future__ import annotations

import dataclasses
import json
import time
from typing import Optional

import numpy as np
import torch


def log_run(path: str, solver: str, cfg, losses, wall_s: Optional[float] = None,
            keep_series: bool = False, **extra) -> dict:
    """Append one JSON line describing a finished solve to ``path``; returns
    the record.  ``cfg`` may be a TVConfig or any dataclass / dict;
    ``losses`` a tensor on any device, a numpy array or a list."""
    if dataclasses.is_dataclass(cfg):
        cfg = dataclasses.asdict(cfg)
    if isinstance(losses, torch.Tensor):
        losses = losses.detach().to("cpu", torch.float64).numpy()
    losses = np.asarray(losses, dtype=np.float64)
    record = {
        "ts": time.time(),
        "solver": solver,
        "config": cfg,
        "n_iter": int(losses.size),
        "loss_first": float(losses[0]) if losses.size else None,
        "loss_last": float(losses[-1]) if losses.size else None,
        "loss_min": float(losses.min()) if losses.size else None,
        **({"wall_s": wall_s} if wall_s is not None else {}),
        **extra,
    }
    if keep_series:
        record["loss_series"] = losses.tolist()
    with open(path, "a") as f:
        f.write(json.dumps(record) + "\n")
    return record
