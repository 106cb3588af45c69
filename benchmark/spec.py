"""``BENCHMARK.json`` and the files it names, found by name: a
configuration's sizes (``configs/<config>.json``), a traffic mix's
parameters (``traffic/<traffic>.json``), a cell's comparison limits
(``limits/<cell>.json``), a module per kind of entry point
(``entries/<entry>.py``) and a reader per metric
(``metrics/<metric>.py``).  A cell, a configuration or a metric is added
by adding files and entries; nothing here changes."""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
import re

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")


def _load_json(path):
    with open(path) as f:
        return json.load(f)


class Spec:
    """The benchmark as ``BENCHMARK.json`` states it, rooted at ``root``
    (the checkout)."""

    def __init__(self, root: str = ROOT):
        self.root = root
        self.bench = _load_json(os.path.join(root, "BENCHMARK.json"))
        self.here = os.path.join(root, "benchmark")

    def cell(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.bench["configs"]:
            if c["name"] == name:
                return _load_json(os.path.join(self.root, c["file"]))
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        return _load_json(os.path.join(self.here, "traffic", f"{name}.json"))

    def limits(self, cell: str) -> dict:
        """``limits/<cell>.json``: the limits, the control and the readings
        they were set from."""
        return _load_json(os.path.join(self.here, "limits", f"{cell}.json"))

    def metrics(self, cell: str, trace: bool):
        """The cell's end-to-end metrics (``trace`` false) or per-layer
        ones: each entry whose ``workloads`` lists the cell, or that has
        no such list."""
        group = self.bench["per_layer" if trace else "end_to_end"]
        return [m for m in group if cell in m.get("workloads", [cell])]

    def reader(self, metric: str):
        """The module ``metrics/<metric>.py``."""
        path = os.path.join(self.here, "metrics", f"{metric}.py")
        modname = "benchmark.metrics._" + re.sub(r"\W", "_", metric)
        spec = importlib.util.spec_from_file_location(modname, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod


def entry(name: str):
    """The module ``entries/<name>.py``."""
    if not NAME.match(name):
        raise ValueError(f"bad entry name {name!r}")
    return importlib.import_module(f"benchmark.entries.{name}")
