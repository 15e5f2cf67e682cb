"""BENCHMARK.json against the format the benchmark keeps, and every name in it
resolving to its file under `perfbench/`."""

import ast
import json
import re
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_command_and_paths():
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and ".." not in p
        assert (ROOT / p).is_dir()
    cmd = BENCH["command"]
    assert 1 <= len(cmd) <= 32 and all(_line(w) for w in cmd)
    for w in cmd[1:]:
        assert not w.startswith("/") and ".." not in w
        if (ROOT / w).exists():
            assert any(Path(w).parts[0] == Path(p).parts[0] for p in BENCH["paths"])


def test_names_units_and_uniqueness():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    for group in (BENCH["configs"], BENCH["workloads"], metrics):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
        assert all(NAME.match(n) for n in names)
    for m in metrics:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES


def test_run_seconds_fit_the_check_with_24_cells():
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_configs_resolve():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        f = ROOT / c["file"]
        assert f.is_file() and any(c["file"].startswith(p + "/") for p in BENCH["paths"])
        data = json.loads(f.read_text())
        assert data["name"] == c["name"] and data["source"] == c["source"]
        assert data["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        assert _line(c["why"]) and _line(c["source"]) and c["source"].startswith("https://")
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])
    assert len({c["file"] for c in BENCH["configs"]}) == len(BENCH["configs"])


def test_workloads_resolve():
    configs = {c["name"] for c in BENCH["configs"]}
    pairs = set()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4) and _line(w["why"])
        assert NAME.match(w["traffic"])
        assert (HERE / "traffic" / f"{w['traffic']}.json").is_file()
        assert (HERE / "limits" / f"{w['name']}.json").is_file()
        pairs.add((w["config"], w["traffic"]))
    assert len(pairs) == len(BENCH["workloads"])
    assert sum(w["chips"] == 4 for w in BENCH["workloads"]) <= max(1, len(BENCH["workloads"]) // 4)


def _reports(cell: str, group: str) -> list:
    return [m for m in BENCH[group] if "workloads" not in m or cell in m["workloads"]]


def test_metrics_resolve_and_every_cell_reports_enough():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and _line(m["layer"])
        for cell in m.get("workloads", []):
            assert cell in cells
            assert any(x["name"] == m["moves"] for x in _reports(cell, "end_to_end"))
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        src = (HERE / "metrics" / f"{m['name']}.py").read_text()
        fns = [n.name for n in ast.parse(src).body if isinstance(n, ast.FunctionDef)]
        assert "read" in fns
    for cell in cells:
        names = {m["name"] for m in _reports(cell, "end_to_end")}
        assert "setup_s" in names and len(names) >= 2
        assert _reports(cell, "per_layer")


def _numbers_the_check_writes() -> set:
    """The names `check.numbers` stores a number under (`out["<name>"] = `)."""
    tree = ast.parse((HERE / "check.py").read_text())
    fn = next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "numbers")
    return {t.slice.value for n in ast.walk(fn) if isinstance(n, ast.Assign)
            for t in n.targets if isinstance(t, ast.Subscript) and isinstance(t.value, ast.Name)
            and t.value.id == "out" and isinstance(t.slice, ast.Constant)}


def test_the_check_writes_every_number_it_has():
    assert _numbers_the_check_writes() == {
        "sphere_share", "pyramid_share", "track_pose_gap_m", "track_pose_gap_rad",
        "track_hessian_gap", "track_residual_gap", "graph_cost_excess", "plane_match_gap",
        "plane_pose_gap_m", "plane_pose_gap_rad", "plane_info_gap"}


@pytest.mark.parametrize("path", sorted((HERE / "limits").glob("*.json")), ids=lambda p: p.stem)
def test_limits_name_known_numbers(path):
    """Every limits file (a cell's, or one no cell has yet) names only
    numbers `check.numbers` can produce."""
    limits = json.loads(path.read_text())
    assert limits and set(limits) <= _numbers_the_check_writes()
    assert all(v >= 0 for v in limits.values())
    assert path.stem in {w["name"] for w in BENCH["workloads"]}


def test_layers_are_named_alike():
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
