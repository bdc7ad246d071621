"""Whole runs at a tiny size on the CPU (the harness's look for a card
skipped) come out correct with the cell's metrics, and a run loads no JAX
and opens nothing of ``benchmarks/``."""
from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys

import pytest
import torch

from hgnnbench import harness
from hgnnbench.tests.test_hgnnbench_inputs import TINY_MAG

SEED = 2**31 + 4242
TINY = {"han-dblp.train": {"scale": 0.05, "feat_scale": 0.05},
        "rgat-mag.train": {"graph": TINY_MAG}, "rgat-mag.infer": {"graph": TINY_MAG}}
BENCH = harness.benchmark()


def _run(name, trace=False):
    return harness.run_cell(name, SEED, 0.3, trace, device="cpu", overrides=TINY[name])


@pytest.mark.parametrize("name", list(TINY))
def test_a_sound_run_is_correct_and_reports_the_cells_metrics(name):
    line = _run(name)
    checks = line["checks"]
    assert line["correct"] and line["failed"] == 0 and line["attempted"] > 0, checks
    assert list(line)[-1] == "checks" and set(checks) == set(
        harness.config(harness.cell(BENCH, name)["config"])["limits"][
            harness.traffic(harness.cell(BENCH, name)["traffic"])["mode"]])
    want = {m["name"] for m in BENCH["end_to_end"] if name in m.get("workloads", [name])}
    assert set(line["metrics"]) == want
    assert all(v["value"] > 0 for v in line["metrics"].values())


@pytest.mark.parametrize("name", ["han-dblp.train", "rgat-mag.infer"])
def test_a_traced_run_reads_its_per_layer_metrics(name):
    line = _run(name, trace=True)
    assert line["correct"]
    assert "setup.prepare_s" in line["metrics"] and "breakdown" in line
    assert {"busy_s", "window_s"} <= set(line["device"])
    allowed = {m["name"] for m in BENCH["per_layer"] if name in m.get("workloads", [name])}
    assert set(line["metrics"]) <= allowed


# -- isolation ----------------------------------------------------------------

_PROBE = r"""
import sys
opened = []
sys.addaudithook(lambda ev, args: opened.append(str(args[0])) if ev == "open" else None)
sys.path[:0] = [sys.argv[1], sys.argv[2]]
from hgnnbench import harness
from hgnnbench.tests.test_hgnnbench_run import TINY
line = harness.run_cell("han-dblp.train", 5, 0.2, False, device="cpu",
                           overrides=TINY["han-dblp.train"])
bad = [p for p in opened if "/benchmarks/" in p.replace("\\", "/")]
print(line["correct"], harness.forbidden_modules(), bad)
"""


def test_a_run_loads_no_jax_and_reads_nothing_of_benchmarks():
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run([sys.executable, "-c", _PROBE, str(harness.ROOT),
                          str(harness.ROOT / "src")], capture_output=True, text=True,
                         timeout=600, env=env)
    assert out.returncode == 0, out.stderr[-3000:]
    assert out.stdout.split("\n")[-2] == "True [] []"


def test_forbidden_modules_compares_whole_top_level_names():
    assert harness.forbidden_modules(["repro_torch", "repro_torch.kernels", "jaxtyping"]) == []
    assert harness.forbidden_modules(["repro.core", "jax.numpy", "flax", "torch"]) == [
        "flax", "jax", "repro"]


def test_the_command_fails_without_a_card_or_without_the_port(tmp_path):
    cmd = [sys.executable, "hgnnbench/run.py", "--workload", "han-dblp.train",
           "--seed", str(SEED), "--seconds", "1", "--trace", "0"]
    if not torch.cuda.is_available():
        out = subprocess.run(cmd, cwd=harness.ROOT, capture_output=True, text=True,
                             timeout=300)
        assert out.returncode != 0 and out.stdout.strip() == ""
    # a directory holding only BENCHMARK.json and the benchmark's files
    shutil.copytree(harness.HERE, tmp_path / "hgnnbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run(cmd, cwd=tmp_path, capture_output=True, text=True, timeout=300,
                         env=env)
    assert out.returncode != 0 and out.stdout.strip() == ""
    assert json.loads((tmp_path / "BENCHMARK.json").read_text())["paths"] == ["hgnnbench"]
