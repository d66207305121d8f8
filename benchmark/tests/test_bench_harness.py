"""The harness: finding cells, configurations, traffic and metrics by name,
BENCHMARK.json against the contract's shape, a CPU rehearsal of each
traffic that reports no device metric, the refusal without a card, and
the import checks (no JAX in a run; the reference imports nothing of the
program)."""

import ast
import glob
import json
import os
import re
import shutil
import subprocess
import sys
import time

import pytest
import torch

from benchmark import harness

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in harness.load_json(ROOT, "BENCHMARK.json")["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_is_found_by_name(bench, name):
    wl, config, traffic = harness.find_cell(bench, name)
    assert config["name"] == wl["config"]
    assert hasattr(harness.entry_module(traffic), "Cell")
    assert os.path.exists(os.path.join(harness.HERE, "limits", name + ".json"))
    metrics = harness.cell_metrics(bench, name, "per_layer", set(traffic["report"]))
    assert metrics
    for m in metrics:
        assert callable(harness.metric_reader(m["name"]).read)


def test_unknown_names_are_refused(bench):
    with pytest.raises(KeyError):
        harness.find_cell(bench, "no_such_cell")
    with pytest.raises(FileNotFoundError):
        harness.metric_reader("no_such_metric.grid")


def test_a_dotted_metric_falls_back_to_its_family_reader():
    assert harness.metric_reader("idle_share.anything").__name__.endswith("idle_share")


def test_benchmark_json_keeps_the_contracts_shape(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51
    # a full check of 24 cells fits its 43,200 s
    assert (2 + 14 * 24) * (bench["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    for p in bench["paths"]:
        assert os.path.isdir(os.path.join(ROOT, p))
    names = [c["name"] for c in bench["configs"]]
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and os.path.exists(os.path.join(ROOT, c["file"]))
        assert c["file"].startswith(tuple(p + "/" for p in bench["paths"]))
        assert any(w["config"] == c["name"] for w in bench["workloads"])
    e2e = {m["name"] for m in bench["end_to_end"]}
    assert "setup_s" in e2e
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and w["config"] in names and w["chips"] in (1, 4)
        assert len(w["why"]) <= 200
        traffic = harness.load_json(harness.HERE, "traffic", w["traffic"] + ".json")
        reported = set(traffic["report"]) | {"setup_s"}
        assert len(reported) >= 2
        assert {m["name"] for m in harness.cell_metrics(bench, w["name"], "end_to_end",
                                                        set())} == reported
        assert harness.cell_metrics(bench, w["name"], "per_layer", reported)
    layers = {}
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in bench["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        assert m["source"] in ("device_trace", "program_span", "program_counter",
                               "host_clock")
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def _last_json(text: str) -> dict:
    return json.loads(text.strip().splitlines()[-1])


@pytest.mark.parametrize("trace", [0, 1])
@pytest.mark.parametrize("name", CELLS)
def test_cpu_rehearsal_reports_no_device_metric(bench, tiny_cell, capsys, name, trace):
    wl, config, traffic = tiny_cell(name)
    rc = harness.run_cell(bench, wl, config, traffic, 2**31 + 11, 2.0, bool(trace),
                          time.time(), device="cpu")
    assert rc == 0
    line = _last_json(capsys.readouterr().out)
    assert line["correct"] is True and line["metrics"] == {}
    assert line["device"]["platform"] == "cpu" and line["attempted"] > 0
    assert list(line)[-1] == "checks" and line["checks"]


def test_the_cli_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "align_grid",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and '"correct"' not in out.stdout


def test_a_tree_of_the_benchmark_alone_gives_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(ROOT, "benchmark"), tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "align_grid",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and '"correct"' not in out.stdout


def test_a_run_loads_no_jax():
    """One tiny CPU pass of each cell's harness path in a fresh process;
    no module of JAX or the JAX package is loaded by the end."""
    code = f"""
import json, sys, time
sys.path.insert(0, {ROOT!r})
sys.path.insert(0, {os.path.join(ROOT, "benchmark", "tests")!r})
import torch
torch.set_num_threads(2)
from benchmark import harness
from conftest import tiny
bench = harness.load_json(harness.ROOT, "BENCHMARK.json")
for w in bench["workloads"]:
    wl, config, traffic = harness.find_cell(bench, w["name"])
    harness.run_cell(bench, wl, tiny(config), traffic, 3, 0.2, False, time.time(),
                     device="cpu")
print(json.dumps(harness.forbidden_modules()))
"""
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_the_reference_imports_nothing_of_the_program():
    banned = {"roman_tpu_torch", "roman_tpu", "jax", "jaxlib", "flax"}
    for path in glob.glob(os.path.join(harness.HERE, "reference", "*.py")):
        with open(path) as f:
            tree = ast.parse(f.read())
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                tops = {a.name.split(".")[0] for a in node.names}
            elif isinstance(node, ast.ImportFrom):
                tops = {(node.module or "").split(".")[0]}
            else:
                continue
            assert not tops & banned, f"{path} imports {tops & banned}"
    code = (f"import sys; sys.path.insert(0, {ROOT!r}); "
            "import benchmark.reference.clipper_f64, benchmark.reference.compare; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in "
            "('roman_tpu_torch', 'roman_tpu', 'jax', 'jaxlib', 'flax')))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "[]", out.stderr[-2000:]
