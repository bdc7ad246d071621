"""BENCHMARK.json against the benchmark's contract, and every file a cell
or a metric needs found by its name."""
from __future__ import annotations

import json
import math
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from hgnnbench import harness

ROOT = harness.ROOT
BENCH = harness.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def _reports(cell: str, metric: dict) -> bool:
    return cell in metric.get("workloads", CELLS)


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "hgnnbench/run.py"]
    assert 1 <= len(BENCH["paths"]) <= 16
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_.\-/]{1,200}", p) and not p.startswith("/")
        assert ".." not in p.split("/") and not p.endswith("_torch")
    for word in BENCH["command"][1:]:
        assert any(word == p or word.startswith(p + "/") for p in BENCH["paths"])
    assert len(json.dumps(BENCH)) < 64 * 1024


def test_run_seconds_fits_a_full_check_of_24_cells():
    rs = BENCH["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"] + METRICS,
                         ids=lambda e: e["name"])
def test_names_units_and_texts(entry):
    assert NAME.match(entry["name"])
    if "unit" in entry:
        assert UNIT.match(entry["unit"]) and entry["better"] in ("lower", "higher")
    for key in ("why", "layer", "source"):
        if key in entry:
            assert 1 <= len(entry[key]) <= 200 and "\n" not in entry[key]
            assert "\t" not in entry[key]
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])


def test_entries_have_just_the_contract_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_unique_names_and_pairs():
    for group in (BENCH["configs"], BENCH["workloads"], METRICS):
        names = [e["name"] for e in group]
        assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_every_moves_and_workloads_list():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", CELLS):
            assert cell in CELLS
            assert _reports(cell, e2e[m["moves"]]), (m["name"], cell)
    for m in BENCH["end_to_end"]:
        assert all(c in CELLS for c in m.get("workloads", CELLS))
    layers = {}
    for m in BENCH["per_layer"]:
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())


def test_every_cell_reports_setup_another_metric_and_a_layer():
    for cell in CELLS:
        e2e = [m["name"] for m in BENCH["end_to_end"] if _reports(cell, m)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(_reports(cell, m) for m in BENCH["per_layer"])


def test_four_chip_share():
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert all(w["chips"] in (1, 4) for w in BENCH["workloads"])
    assert four <= max(1, math.floor(len(CELLS) / 4))


def test_configs_are_used_and_filed_under_paths():
    used = {w["config"] for w in BENCH["workloads"]}
    files = [c["file"] for c in BENCH["configs"]]
    assert len(files) == len(set(files))
    for c in BENCH["configs"]:
        assert c["name"] in used
        assert c["file"] == f"hgnnbench/configs/{c['name']}.json"
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert not any(k.endswith(("_dim", "_rank")) or k in ("widths", "hidden", "heads")
                       for k in c["reduced"])


@pytest.mark.parametrize("name", CELLS)
def test_every_cell_finds_its_files_by_name(name):
    run = harness.Run(BENCH, name, 1, "cpu")
    cfg = run.cfg
    assert run.mode_name in ("train", "infer")
    assert set(cfg["limits"][run.mode_name])  # the numbers it compares, each with a limit
    for kind, mod in (("models", cfg["model"]), ("reference", cfg["model"]),
                      ("data", cfg["dataset"])):
        assert (harness.HERE / kind / f"{mod}.py").exists()
        harness.module(kind, mod)
    for m in BENCH["per_layer"]:
        if _reports(name, m):
            assert callable(harness.metric_reader(m["name"]))
    for m in BENCH["end_to_end"]:
        if _reports(name, m):
            assert callable(harness.metric_reader(m["name"], "end_to_end"))


def test_a_cell_and_a_metric_are_added_by_files_alone(tmp_path):
    """A copy of the benchmark, with a new traffic file, a new reader and
    their entries in BENCHMARK.json, finds both with no file edited."""
    root = tmp_path / "checkout"
    shutil.copytree(harness.HERE, root / "hgnnbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    (root / "hgnnbench" / "traffic" / "train-long.json").write_text(
        json.dumps({"mode": "train", "checked_steps": 3, "warmup_steps": 5,
                    "chunk_seconds": 2.0}))
    (root / "hgnnbench" / "metrics" / "steps.count.train.py").write_text(
        "def read(r):\n    return float(r.steps)\n")
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "han-dblp.train-long", "config": "han-dblp",
                               "traffic": "train-long", "chips": 1, "why": "longer warm-up"})
    for m in bench["end_to_end"]:
        if m["name"] in ("setup_s", "metapath_step_ms"):
            m.setdefault("workloads", [w["name"] for w in BENCH["workloads"]])
            m["workloads"].append("han-dblp.train-long")
    bench["per_layer"].append({"name": "steps.count.train", "unit": "steps", "better": "higher",
                               "source": "program_counter", "layer": "Train loop",
                               "moves": "metapath_step_ms",
                               "workloads": ["han-dblp.train-long"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    code = ("import sys; sys.path[:0] = [sys.argv[1], sys.argv[2]]\n"
            "from hgnnbench import harness\n"
            "run = harness.Run(harness.benchmark(), 'han-dblp.train-long', 1, 'cpu')\n"
            "assert run.traffic['warmup_steps'] == 5, run.traffic\n"
            "read = harness.metric_reader('steps.count.train')\n"
            "print(harness.HERE, read(type('R', (), {'steps': 7})()))\n")
    out = subprocess.run([sys.executable, "-c", code, str(root), str(ROOT / "src")],
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    here, value = out.stdout.split()
    assert Path(here) == root / "hgnnbench" and float(value) == 7.0
