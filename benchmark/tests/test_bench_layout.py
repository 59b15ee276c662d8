"""BENCHMARK.json against the contract's characters, everything it names
found by name, and the import rules."""

from __future__ import annotations

import ast
import json
import re
import subprocess
import sys

import pytest

from benchmark import run
from benchmark.lib import env

ROOT = run.ROOT
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _text_ok(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_sizes():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) <= 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51 and isinstance(BENCH["run_seconds"], int)
    assert all(re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and not p.endswith("_torch")
               for p in BENCH["paths"])
    assert len(BENCH["command"]) <= 32 and all(_text_ok(w) for w in BENCH["command"])


def test_names_units_and_texts():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _text_ok(c["source"]) and _text_ok(c["why"])
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        names.append(("config", c["name"]))
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and NAME.match(w["config"])
        assert w["chips"] in (1, 4) and _text_ok(w["why"])
        names.append(("cell", w["name"]))
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
        names.append(("metric", m["name"]))
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert _text_ok(m["layer"])
    assert len(names) == len(set(names))
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])


def test_every_name_is_found():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    for w in BENCH["workloads"]:
        entry, conf, mix, limits, _ = run.resolve(w["name"])
        assert (run.HERE / "drivers" / f"{mix['driver']}.py").exists()
        assert limits
        reported = run.cell_metrics(BENCH, entry, trace=False)
        assert "setup_s" in {m["name"] for m in reported} and len(reported) >= 2
        assert run.cell_metrics(BENCH, entry, trace=True)
    for c in BENCH["configs"]:
        assert (ROOT / c["file"]).exists() and c["file"].startswith("benchmark/")
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    for m in BENCH["per_layer"]:
        mod = run.load_module(run.HERE / "metrics" / f"{m['name']}.py", "t_" + m["name"])
        assert callable(mod.read)
        assert m["moves"] in e2e
        for cell in m.get("workloads", []):
            assert cell in cells
            assert cell in e2e[m["moves"]].get("workloads", [cell])


def _modules():
    files = sorted(p for p in (ROOT / "benchmark").rglob("*.py") if "tests" not in p.parts)
    return files


def test_nothing_the_benchmark_runs_loads_jax_or_the_jax_package():
    """Import every module of the benchmark in a fresh process (the metric
    readers by path), then look at sys.modules by whole top-level names."""
    code = (
        "import sys, importlib.util, pathlib\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "from benchmark.lib import env\n"
        f"for p in {[str(p) for p in _modules()]!r}:\n"
        "    spec = importlib.util.spec_from_file_location('m_' + str(abs(hash(p))), p)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "import diffab_pytorch_tpu_torch.train.trainer, diffab_pytorch_tpu_torch.sampling.sampler\n"
        "print(','.join(env.forbidden_loaded()))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""


def test_the_guard_compares_whole_top_level_names():
    assert env.forbidden_loaded({"diffab_pytorch_tpu_torch.models": None, "jaxtyping": None,
                                 "numpy": None}) == []
    assert env.forbidden_loaded({"diffab_pytorch_tpu.ops": None, "jax.numpy": None}) == [
        "diffab_pytorch_tpu", "jax"]


@pytest.mark.parametrize("path", sorted((ROOT / "benchmark" / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_port(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops = [a.name.split(".")[0] for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            tops = [(node.module or "").split(".")[0]]
        else:
            continue
        for top in tops:
            assert top not in ("diffab_pytorch_tpu_torch",) + env.FORBIDDEN, (path, top)
            if top == "benchmark":
                assert (node.module or "").startswith("benchmark.reference"), (path, node.module)
