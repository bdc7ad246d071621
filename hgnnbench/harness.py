"""One run of one cell: find the cell's files by name, set up, measure a
window, judge the outputs against the plain reference, read the
per-layer metrics from a traced window, and build the result line.

Everything a cell needs is found by name from ``BENCHMARK.json``:

* configuration ``<c>``: ``hgnnbench/configs/<c>.json``; its ``model``
  names the port's wiring ``hgnnbench/models/<model>.py`` and the plain
  reference ``hgnnbench/reference/<model>.py``; its ``dataset`` names the
  input generator ``hgnnbench/data/<dataset>.py``;
* traffic ``<t>``: ``hgnnbench/traffic/<t>.json``; its ``mode`` names the
  module that runs it, ``hgnnbench/modes/<mode>.py``;
* per-layer metric ``<m>``: the reader ``hgnnbench/metrics/<m>.py``;
  end-to-end metric ``<e>``: ``hgnnbench/end_to_end/<e>.py``, which picks
  its number from what the mode measured (``mean_ms``, ``p95_ms``,
  ``setup_s``).
"""
from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import sys
import time
from pathlib import Path

import torch

from . import check
from .reference.common import float32_matmuls
from .roofline import least_seconds
from .trace import Spans, TraceSummary, profiled

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
SEED_SALT = 0x5EED  # the weights' stream, apart from the inputs'
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(name: str) -> dict:
    return load_json(HERE / "configs" / f"{name}.json")


def traffic(name: str) -> dict:
    return load_json(HERE / "traffic" / f"{name}.json")


def module(kind: str, name: str):
    """``hgnnbench.<kind>.<name>`` (a model, reference, dataset or mode)."""
    return importlib.import_module(f"{__package__}.{kind}.{name}")


def metric_reader(name: str, kind: str = "metrics"):
    """The ``read`` function of ``<kind>/<name>.py``: a per-layer metric's
    (``metrics``) or an end-to-end metric's (``end_to_end``)."""
    path = HERE / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"{__package__}.{kind}.m_{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules(modules=None) -> list[str]:
    """Top-level names of ``modules`` (``sys.modules``) that a run must not
    load, compared whole: ``repro_torch`` is not ``repro``."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


class Run:
    """The state of one run, which the mode's module and the readers see."""

    def __init__(self, bench, name, seed, device, overrides=None):
        self.cell = cell(bench, name)
        self.cfg = config(self.cell["config"])
        for k, v in (overrides or {}).items():
            self.cfg[k] = v
        self.traffic = traffic(self.cell["traffic"])
        self.mode_name = self.traffic["mode"]
        self.mode = module("modes", self.mode_name)
        self.ref = module("reference", self.cfg["model"])
        self.seed = int(seed)
        self.device = torch.device(device)
        self.span = Spans()

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)


class Reading:
    """What a per-layer reader takes: the traced window, the spans, the
    window's step count and the work the algorithm needs a step."""

    def __init__(self, run: Run, win: dict, trace: TraceSummary | None, work: dict | None):
        self.mode = run.mode_name
        self.spans = run.span
        self.steps = win["count"]
        self.enqueue = win["enqueue"]
        self.latencies = win["latencies"]
        self.trace = trace
        self.work = work

    def least_seconds(self, kernel: str) -> float | None:
        """The least time of the window's launches of ``kernel``."""
        if not self.work or kernel not in self.work["kernels"]:
            return None
        per_step = sum(least_seconds(f, b) for f, b in self.work["kernels"][kernel])
        return per_step * self.steps


def make_inputs(run: Run) -> dict:
    """The run's inputs from its seed, and its weights (``run.params``)
    from the seed's own stream; products in float32 from here on."""
    float32_matmuls()
    inputs = module("data", run.cfg["dataset"]).make(run.cfg, run.seed, run.device)
    gen = torch.Generator(device=run.device)
    gen.manual_seed((run.seed ^ SEED_SALT) % (1 << 64))
    run.params = run.ref.init_params(run.cfg, inputs, gen, run.device)
    return inputs


def run_cell(name: str, seed: int, seconds: float, trace: bool, *, device: str = "cuda",
             start: float | None = None, overrides: dict | None = None) -> dict:
    """One run.  Returns the result line: ``correct``, ``attempted``,
    ``failed``, ``metrics``, ``device`` (and with ``trace`` ``breakdown``)
    and last ``checks``, each compared number with its limit.
    ``overrides`` replaces keys of the configuration (the tests' small
    sizes)."""
    start = time.perf_counter() if start is None else start
    bench = benchmark()
    run = Run(bench, name, seed, device, overrides)
    dev = run.device
    with run.span("bench/inputs"):
        inputs = make_inputs(run)
    run.port = module("models", run.cfg["model"]).Port(run.cfg, inputs, dev, run.span,
                                                       mode=run.mode_name)
    state = run.mode.setup(run)
    run.sync()
    setup_s = time.perf_counter() - start

    with profiled(trace, run.span) as prof:
        win = run.mode.window(run, state, seconds)
    summary = TraceSummary(prof, win["seconds"]) if prof is not None else None
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    prog = run.mode.outputs(run, state)
    del state, run.port
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    ref_graph = run.ref.prepare(run.cfg, inputs, dev)
    ref = run.mode.reference(run, ref_graph)
    correct, checks, failed = check.judge(run.mode.numbers(run, prog, ref),
                                          run.cfg["limits"][run.mode_name])
    failed += run.mode.failed_in_window(win)

    if trace:
        reading = Reading(run, win, summary, run.ref.work(run.cfg, ref_graph, run.mode_name))
        metrics = {}
        for m in bench["per_layer"]:
            if name not in m.get("workloads", [name]):
                continue
            value = metric_reader(m["name"])(reading)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        measured = dict(run.mode.metrics(win), setup_s=setup_s)
        metrics = {m["name"]: {"value": metric_reader(m["name"], "end_to_end")(measured),
                               "unit": m["unit"]}
                   for m in bench["end_to_end"] if name in m.get("workloads", [name])}
    line = {"correct": bool(correct), "attempted": win["count"], "failed": int(failed),
            "metrics": metrics, "device": device_info(dev, peak)}
    if summary is not None:
        line["device"]["busy_s"] = summary.busy_s
        line["device"]["window_s"] = summary.window_s
        line["breakdown"] = {"device_ops": summary.device_ops(),
                             "idle_gaps": summary.idle_gaps()}
    line["checks"] = checks
    return line


def device_info(dev: torch.device, peak: int) -> dict:
    if dev.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0, "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(dev), "count": 1,
            "memory_peak_bytes": int(peak)}
