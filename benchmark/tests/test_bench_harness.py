"""The harness on the CPU: ``BENCHMARK.json`` against the contract's
limits, every file it names, a cell added by files alone, what a run
imports and writes, and ``correct`` coming out false under each fault a
cell can have.  The runs here skip the look for a card and take the
program's plain CPU path at a tiny size."""

import ast
import json
import math
import os
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark import compare
from benchmark.harness import FORBIDDEN, forbidden_modules, run_cell
from benchmark.spec import NAME, ROOT, UNIT, Spec

BENCH = os.path.join(ROOT, "benchmark")
TINY = {"cp4d_f32": {"shape": [6, 3, 16, 16]},
        "gd4d_f32": {"shape": [6, 3, 16, 16]},
        # on the CPU 'auto' is the gather pair; the card's is the spectral
        "ct_par_tv": {"shape": [2, 2, 16, 16], "n_angles": 8, "n_det": 16,
                      "method": "spectral"}}


@pytest.fixture(scope="module")
def spec():
    return Spec()


def _line(s, lo=1, hi=200):
    return isinstance(s, str) and lo <= len(s) <= hi and "\n" not in s \
        and "\t" not in s


def test_benchmark_json_keeps_to_the_contract(spec):
    b = spec.bench
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["command"] == ["python3", "benchmark/run.py"]
    assert b["paths"] == ["benchmark"]
    assert isinstance(b["run_seconds"], int) and 1 <= b["run_seconds"] <= 51
    n = len(b["workloads"])
    # a full check with 24 cells fits its 43200 s
    assert (2 + 14 * 24) * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    configs = {c["name"]: c for c in b["configs"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("benchmark/configs/")
        assert len(c["reduced"]) <= 16
    assert len({c["file"] for c in b["configs"]}) == len(configs)
    pairs = set()
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in configs and w["chips"] == 1 and _line(w["why"])
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == n == len({w["name"] for w in b["workloads"]})
    assert {w["config"] for w in b["workloads"]} == set(configs)
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    for m in b["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert next(m for m in b["end_to_end"]
                if m["name"] == "setup_s")["bound"] == 0.25
    for m in b["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"])
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        for w in m.get("workloads", []):
            assert w in {x["name"] for x in b["workloads"]}
    assert len(json.dumps(b)) <= 64 * 1024


def test_every_cell_reports_what_it_must(spec):
    layers = {}
    for w in spec.bench["workloads"]:
        e2e = {m["name"] for m in spec.metrics(w["name"], False)}
        assert "setup_s" in e2e and len(e2e) >= 2
        per = spec.metrics(w["name"], True)
        assert per
        for m in per:
            # the metric it moves is one this cell reports
            assert m["moves"] in e2e, (w["name"], m["name"])
            layers.setdefault(m["layer"], set()).add(m["name"])
    # a layer's name is the same string wherever it appears
    assert len(layers) == len({ly.split(":")[0] for ly in layers})


def test_every_named_file_loads(spec):
    e2e = {m["name"] for m in spec.bench["end_to_end"]}
    for m in spec.bench["end_to_end"] + spec.bench["per_layer"]:
        r = spec.reader(m["name"])
        assert r.SOURCE == m["source"] and r.MOVES == m.get("moves",
                                                            m["name"])
        assert r.LAYER == m.get("layer")
        assert r.MOVES in e2e and callable(r.read)
    for w in spec.bench["workloads"]:
        cfg = spec.config(w["config"])
        assert cfg["name"] == w["config"] and cfg["reduced"] == []
        traffic = spec.traffic(w["traffic"])
        lim = spec.limits(w["name"])
        assert set(lim["limits"]) <= {"loss_rel", "x_rel_l2", "x_max_rel"}
        assert lim["control"] and lim["control_is"]
        from benchmark.spec import entry
        assert callable(entry(traffic["entry"]).prepare)


def test_forbidden_modules_compare_whole_names(monkeypatch):
    assert "pytv4d_tpu" in FORBIDDEN
    monkeypatch.setitem(sys.modules, "pytv4d_tpu_torch_extra", sys)
    assert forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "pytv4d_tpu.bench", sys)
    assert forbidden_modules() == ["pytv4d_tpu"]


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def _sources():
    for d, _, files in os.walk(BENCH):
        if os.sep + "tests" in d or "__pycache__" in d:
            continue
        yield from (os.path.join(d, f) for f in files if f.endswith(".py"))


def test_sources_import_neither_jax_nor_the_jax_package():
    for path in _sources():
        for mod in _imports(path):
            top = mod.split(".")[0]
            assert top not in FORBIDDEN, (path, mod)
            if os.sep + "reference" + os.sep in path:
                assert top in ("torch", "numpy", "math", "__future__"), \
                    (path, mod)


def test_sources_name_no_fixed_path():
    for path in _sources():
        text = open(path).read()
        for bad in ("/tmp", "/dev/shm", "tempfile", "expanduser"):
            assert bad not in text, (path, bad)


def _run_script(code, cwd, env_root):
    env = dict(os.environ)
    for k in ("HOME", "XDG_CACHE_HOME", "TMPDIR"):
        env[k] = os.path.join(env_root, k.lower())
        os.makedirs(env[k], exist_ok=True)
    env["PYTHONPATH"] = os.pathsep.join([cwd, ROOT])
    out = subprocess.run([sys.executable, "-c", code], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout.strip().splitlines()[-1]


RUN_AND_LIST = """
import json, sys
from benchmark.harness import run_cell, forbidden_modules
from benchmark.spec import Spec
r = run_cell(Spec(), {cell!r}, 5, 0.0, False, "cpu", 0.0, {tiny!r})
tops = sorted({{m.split(".")[0] for m in sys.modules}})
print(json.dumps([r, forbidden_modules(), tops]))
"""


def test_a_cell_added_as_files_runs_with_no_code_edited(tmp_path):
    """A copy of the benchmark with one more cell, made of a traffic file, a
    limits file and an entry: the harness finds and runs it by name, loads
    nothing forbidden, and writes nothing in its checkout but bytecode."""
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    b["workloads"].append({"name": "cp_short", "config": "denoise4d",
                           "traffic": "cp_f32_7", "chips": 1,
                           "why": "a cell added by files"})
    for m in b["end_to_end"] + b["per_layer"]:
        if "cp4d_f32" in m.get("workloads", []):
            m["workloads"].append("cp_short")
    (root / "BENCHMARK.json").write_text(json.dumps(b))
    t = json.load(open(os.path.join(BENCH, "traffic", "cp_f32_100.json")))
    (root / "benchmark" / "traffic" / "cp_f32_7.json").write_text(
        json.dumps(dict(t, n_iter=7)))
    shutil.copy(os.path.join(BENCH, "limits", "cp4d_f32.json"),
                root / "benchmark" / "limits" / "cp_short.json")
    before = sorted(p.relative_to(root) for p in root.rglob("*"))
    r, forbidden, tops = json.loads(_run_script(
        RUN_AND_LIST.format(cell="cp_short", tiny=TINY["cp4d_f32"]),
        str(root), str(tmp_path)))
    assert r["correct"] and r["attempted"] >= 1 and r["failed"] == 0
    # peak_mem_gib reads the card's allocator: nothing to read on the CPU
    assert set(r["metrics"]) == {"denoise_gvox_per_s", "setup_s"}
    assert forbidden == [] and "pytv4d_tpu_torch" in tops
    after = sorted(p.relative_to(root) for p in root.rglob("*")
                   if "__pycache__" not in p.parts)
    assert after == [p for p in before if "__pycache__" not in p.parts]


def test_the_reference_loads_nothing_of_the_program(tmp_path):
    code = ("import sys, json\n"
            "import benchmark.reference.tv, benchmark.reference.ct\n"
            "import benchmark.inputs, benchmark.compare\n"
            "print(json.dumps(sorted({m.split('.')[0] "
            "for m in sys.modules})))")
    tops = json.loads(_run_script(code, ROOT, str(tmp_path)))
    assert "torch" in tops
    assert not {"pytv4d_tpu_torch", *FORBIDDEN} & set(tops)


# --------------------------------------------------------------- the faults
def _half(t):
    return slice(t.shape[0] // 2, None)


def _fault_cp_step(monkeypatch, kind):
    from pytv4d_tpu_torch.kernels import fused

    orig = fused.cp_step_fused_internal

    def step(x, y_A, y_D, x0, **kw):
        old = (x.clone(), y_A.clone(), y_D.clone())
        new = orig(x, y_A, y_D, x0, **kw)
        for a, b in zip(new[:3], old):
            if kind == "unchanged":
                a.copy_(b)
            else:
                a[_half(a)] = b[_half(b)]
        return new

    monkeypatch.setattr(fused, "cp_step_fused_internal", step)


def _fault_gd_step(monkeypatch, kind):
    from pytv4d_tpu_torch.solvers import gd

    orig = gd._update

    def update(space, tv_and_G, x, x0, reg, step_size):
        x_new, loss, tv = orig(space, tv_and_G, x, x0, reg, step_size)
        if kind == "unchanged":
            return x, loss, tv
        x_new = x_new.clone()
        x_new[_half(x)] = x[_half(x)]
        return x_new, loss, tv

    monkeypatch.setattr(gd, "_update", update)


def _fault_ct_step(monkeypatch, kind):
    from pytv4d_tpu_torch.solvers import inverse

    orig = inverse._tensor_tv_half

    def tv_half(*args):
        half = orig(*args)

        def primal(x, at, y, out):
            new = half.primal(x, at, y, out)
            if kind == "unchanged":
                new.copy_(x)
            else:
                new[_half(new)] = x[_half(x)]
            return new

        return half._replace(primal=primal)

    monkeypatch.setattr(inverse, "_tensor_tv_half", tv_half)


def _fault_answer(monkeypatch, module, name):
    """The solver's answer altered where it is produced: one voxel moved by
    a tenth of the volume's range."""
    mod = __import__(module, fromlist=[name])
    orig = getattr(mod, name)

    def solver(*args, **kw):
        res = orig(*args, **kw)
        x = res.x.clone()
        x.view(-1)[x.numel() // 2] += 0.1 * float(x.max() - x.min())
        return res._replace(x=x)

    monkeypatch.setattr(mod, name, solver)


STEP_FAULTS = {"cp4d_f32": _fault_cp_step, "gd4d_f32": _fault_gd_step,
               "ct_par_tv": _fault_ct_step}
ANSWERS = {"cp4d_f32": ("pytv4d_tpu_torch.models.denoise", "chambolle_pock"),
           "gd4d_f32": ("pytv4d_tpu_torch.models.denoise",
                        "subgradient_descent"),
           "ct_par_tv": ("pytv4d_tpu_torch.models.ct", "cp_inverse")}


@pytest.mark.parametrize("cell", list(TINY))
@pytest.mark.parametrize("fault", [None, "unchanged", "half", "answer"])
def test_correct_is_false_under_each_fault(spec, monkeypatch, cell, fault):
    if fault in ("unchanged", "half"):
        STEP_FAULTS[cell](monkeypatch, fault)
    elif fault == "answer":
        _fault_answer(monkeypatch, *ANSWERS[cell])
    torch.manual_seed(0)
    r = run_cell(spec, cell, 2 ** 31 + 3, 0.0, False, "cpu", 0.0, TINY[cell])
    assert r["correct"] == (fault is None), r["checks"]
    values = [c["value"] for c in r["checks"].values()]
    if fault is None:
        assert all(v is not None and math.isfinite(v) for v in values)


def test_judge_fails_a_missing_or_large_reading():
    assert compare.judge({"a": 1e-7}, {"a": 1e-6})[0]
    assert not compare.judge({"a": None}, {"a": 1e-6})[0]
    assert not compare.judge({"a": 2e-6}, {"a": 1e-6})[0]
