"""The benchmark's files: every name in BENCHMARK.json finds its file, the
schema's shapes hold, and no file of the benchmark imports JAX or the
JAX package (nor, under reference/, the program)."""
import ast
import json
import re
from pathlib import Path

import pytest

from portbench import common

HERE = common.HERE
BENCH = common.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
MODES = ("frames", "steps")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "portbench/run.py"]
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("w", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_files_load(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(w["name"]) and _line(w["why"]) and w["chips"] == 1
    _w, cfg, mix, spec = common.cell(w["name"])
    assert mix["mode"] in MODES
    assert (HERE / "entries" / f"{cfg['entry']}.py").exists()
    assert spec["limits"] and all(v > 0 for v in spec["limits"].values())
    reports = [m["name"] for m in BENCH["end_to_end"]
               if w["name"] in m.get("workloads", [w["name"]])]
    assert "setup_s" in reports and len(reports) >= 2
    assert any(w["name"] in m.get("workloads", [w["name"]])
               for m in BENCH["per_layer"])


@pytest.mark.parametrize("c", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(c):
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    cfg = common.load_json(common.REPO / c["file"])
    assert c["file"] == f"portbench/configs/{c['name']}.json"
    assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
    assert cfg["reduced"] == c["reduced"]
    assert _line(c["source"]) and _line(c["why"])
    assert any(w["config"] == c["name"] for w in BENCH["workloads"])


def test_metrics_and_readers():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert _line(m["layer"])
        reader = common.load_module(HERE / "metrics" / f"{m['name']}.py")
        assert callable(reader.read)
        moved = e2e[m["moves"]]
        for w in m["workloads"]:
            assert w in moved.get("workloads", [w])
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) \
                == "import_module" and node.args and isinstance(
                    node.args[0], ast.Constant):
            out.add(node.args[0].value.split(".")[0])
    return out


@pytest.mark.parametrize("path", sorted(HERE.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(HERE)))
def test_no_jax_imports(path):
    tops = _imports(path)
    assert not tops & set(common.FORBIDDEN), tops
    if "reference" in path.relative_to(HERE).parts:
        assert "langsplatv2_tpu_torch" not in tops, tops


def test_forbidden_names_compare_whole():
    mods = ["langsplatv2_tpu_torch", "langsplatv2_tpu_torch.ops.blend",
            "jaxtyping", "flaxen", "torch"]
    assert common.forbidden_modules(mods) == []
    assert common.forbidden_modules(mods + ["jax.numpy", "langsplatv2_tpu",
                                            "flax"]) == [
        "flax", "jax.numpy", "langsplatv2_tpu"]
