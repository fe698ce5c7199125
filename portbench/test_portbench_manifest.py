"""``BENCHMARK.json`` against the contract's shape, each name found as a
file, and what the benchmark may import."""
import ast
import json
import os
import re
import subprocess
import sys

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}
# the reference side: it imports nothing of the program
REFERENCE = ["reference.py", "weights.py", "traffic.py", "check.py", "peaks.py",
             "configs/granite-3-2b.py", "configs/mamba2-130m.py", "kernels/__init__.py",
             "kernels/decode_attention.py", "kernels/flash_attention.py", "kernels/ssd_scan.py"]


@pytest.fixture(scope="module")
def manifest():
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def test_top_level_keys_and_paths(manifest):
    assert list(manifest) == ["command", "paths", "run_seconds", "configs", "workloads",
                              "end_to_end", "per_layer"]
    assert manifest["command"] == ["python3", "portbench/run.py"]
    assert manifest["paths"] == ["portbench"]
    assert 1 <= manifest["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (manifest["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_names_units_and_entry_keys(manifest):
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in manifest[k]]
    assert all(NAME.match(n) for n in names) and len(names) == len(set(names))
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert all(NAME.match(k) for k in c["reduced"])
        assert os.path.exists(os.path.join(ROOT, c["file"]))
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert len(w["why"]) <= 200
        assert os.path.exists(os.path.join(HERE, "mixes", w["traffic"] + ".json"))
        assert os.path.exists(os.path.join(HERE, "limits", w["name"] + ".json"))
    for m in manifest["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in manifest["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert os.path.exists(os.path.join(HERE, "metrics", m["name"] + ".py"))


def test_every_cell_reports_what_it_must(manifest):
    e2e = {m["name"]: m for m in manifest["end_to_end"]}

    def reports(m, cell):
        return "workloads" not in m or cell in m["workloads"]

    for w in manifest["workloads"]:
        cell = w["name"]
        mine = [n for n, m in e2e.items() if reports(m, cell)]
        assert "setup_s" in mine and len(mine) >= 2
        assert any(reports(m, cell) for m in manifest["per_layer"])
    for m in manifest["per_layer"]:
        assert m["moves"] in e2e and m["moves"] != "setup_s"
        assert all(reports(e2e[m["moves"]], cell) for cell in m["workloads"])


def _imports(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_module_imports_jax_or_the_jax_package():
    for dirpath, _, files in os.walk(HERE):
        for f in files:
            if f.endswith(".py"):
                tops = {m.split(".")[0] for m in _imports(os.path.join(dirpath, f))}
                assert not tops & FORBIDDEN, (f, tops & FORBIDDEN)


def test_the_reference_imports_nothing_of_the_program():
    for rel in REFERENCE:
        tops = {m.split(".")[0] for m in _imports(os.path.join(HERE, rel))}
        assert "repro_torch" not in tops and not tops & FORBIDDEN, (rel, tops)


def test_a_run_loads_no_jax_module():
    code = ("import sys; sys.path[:0] = [sys.argv[1], sys.argv[1] + '/src'];"
            "import portbench.harness, portbench.check, repro_torch.avec,"
            " repro_torch.models.model, repro_torch.core.library;"
            "print(sorted({m.split('.')[0] for m in sys.modules} & set(sys.argv[2:])))")
    out = subprocess.run([sys.executable, "-c", code, ROOT, *sorted(FORBIDDEN)],
                         capture_output=True, text=True, timeout=120)
    assert out.stdout.strip() == "[]", out.stderr
