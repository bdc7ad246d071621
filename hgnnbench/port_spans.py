"""Readings of the port's own spans (``repro_torch.obs.trace``) in a traced
window, and a command that takes them.

The port's tracer stamps its spans on the profiler's clock, and while a
``torch.profiler`` records, each span of an enabled tracer is also a
profiler range of its own name.  A window traced by ``trace.profiled``
with the port's tracer enabled so holds the ranges ``step/forward``,
``step/backward``, ``rgat/na``, ... beside the kernels their code
launched, and the tracer holds the spans' attributes.  The readers take a
``harness.Reading`` that carries the tracer as ``tracer`` and return None
where they find nothing to read (no trace, no tracer, no such span):

* :func:`idle_ms`: device-idle ms a step inside one span's ranges: the
  gaps between the window's merged busy intervals, overlapped with the
  ranges of that name;
* :func:`device_mallocs`: the mean ``device_mallocs`` (the caching
  allocator's cudaMalloc calls) of the window's ``train/step`` spans;
* :func:`block_csr_s`: host seconds of the ``setup/block_csr`` spans.

``harness.run_cell`` leaves the port's tracer off, so no metric of
``BENCHMARK.json`` reads these.  The command runs a cell's set-up and one
traced window as ``run.py --trace 1`` does, with the port's tracer enabled
(sync off) from before the set-up under ``--port-tracer 1``, and prints one
JSON line: the cell's per-layer metrics that need no reference (so the two
settings of ``--port-tracer`` give the tracer's cost), the idle ms a step
inside each port span, the cudaMalloc calls a step, the block-CSR seconds,
and the synchronise calls a step, in all and inside each port span.  It
judges no output.

    python3 hgnnbench/port_spans.py --workload han-dblp.train --seed 7 --seconds 20 \\
        --port-tracer 1
"""
import time

START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

import numpy as np  # noqa: E402

SYNCS = ("cudaDeviceSynchronize", "cudaStreamSynchronize")


def gaps(trace) -> np.ndarray:
    """[start, end) ns of the idle gaps between the window's merged busy
    intervals."""
    b = trace.busy_iv
    return np.stack([b[:-1, 1], b[1:, 0]], axis=1) if len(b) > 1 else np.zeros((0, 2), np.int64)


def ranges(trace, name: str) -> np.ndarray:
    """[start, end) ns of the window's host ranges named ``name``."""
    pick = [i for i, n in enumerate(trace.host_names) if n == name]
    return trace.host_iv[pick].reshape(-1, 2)


def covered(iv: np.ndarray, cover: np.ndarray) -> int:
    """Length of the sorted disjoint intervals ``iv`` inside the union of
    the intervals ``cover`` (any order, overlaps allowed)."""
    # imported here: run as a script, this module loads before main() puts
    # the repository on the path
    from hgnnbench.trace import _merge

    if len(iv) == 0 or len(cover) == 0:
        return 0
    cover = _merge(cover)
    starts, lens = iv[:, 0], iv[:, 1] - iv[:, 0]
    before = np.concatenate([[0], np.cumsum(lens)])  # length of iv[:k]

    def upto(t):  # length of iv below each t
        k = np.searchsorted(starts, t, side="right")  # iv[:k] start at or before t
        last = np.maximum(k - 1, 0)
        part = np.clip(t - starts[last], 0, lens[last])
        return np.where(k > 0, before[last] + part, 0)

    return int((upto(cover[:, 1]) - upto(cover[:, 0])).sum())


def inside(points: np.ndarray, cover: np.ndarray) -> int:
    """How many of ``points`` lie inside the union of the intervals
    ``cover``."""
    from hgnnbench.trace import _merge

    if len(points) == 0 or len(cover) == 0:
        return 0
    cover = _merge(cover)
    k = np.searchsorted(cover[:, 0], points, side="right") - 1  # the last cover to start
    return int(((k >= 0) & (points < cover[np.maximum(k, 0), 1])).sum())


def idle_ms(r, mode: str, name: str):
    """Device-idle ms a step inside the ranges of span ``name``."""
    if r.mode != mode or r.trace is None or r.trace.busy_s <= 0 or r.steps == 0:
        return None
    cover = ranges(r.trace, name)
    if len(cover) == 0:
        return None
    return covered(gaps(r.trace), cover) / 1e6 / r.steps


def device_mallocs(r, mode: str):
    """Mean cudaMalloc calls a step over the tracer's ``train/step`` spans
    that start inside the traced window (the profiler's first and last host
    event: one clock)."""
    tracer = getattr(r, "tracer", None)
    if r.mode != mode or tracer is None or r.trace is None or len(r.trace.host_iv) == 0:
        return None
    lo, hi = r.trace.host_iv[:, 0].min(), r.trace.host_iv[:, 1].max()
    counts = [e["attrs"]["device_mallocs"] for e in tracer.spans("train/step")
              if lo <= e["ts"] * 1e3 <= hi and "device_mallocs" in e["attrs"]]
    return sum(counts) / len(counts) if counts else None


def block_csr_s(r):
    """Host seconds of the port's ``setup/block_csr`` spans."""
    tracer = getattr(r, "tracer", None)
    durs = [] if tracer is None else [e["dur"] for e in tracer.spans("setup/block_csr")]
    return sum(durs) / 1e6 if durs else None


def measure(name: str, seed: int, seconds: float, port_tracer: bool, *,
            device: str = "cuda", start: float | None = None,
            overrides: dict | None = None) -> dict:
    """One cell's set-up and one profiled window (the harness's own steps,
    with no reference and no check); the readings as one dict.  ``start``:
    the host clock that ``setup_s`` runs from (default: now)."""
    start = time.perf_counter() if start is None else start
    from hgnnbench import harness
    from hgnnbench.trace import TraceSummary, profiled
    from repro_torch.obs import disable_tracing, enable_tracing

    tracer = enable_tracing(sync=False) if port_tracer else None
    try:
        bench = harness.benchmark()
        run = harness.Run(bench, name, seed, device, overrides)
        with run.span("bench/inputs"):
            inputs = harness.make_inputs(run)
        run.port = harness.module("models", run.cfg["model"]).Port(
            run.cfg, inputs, run.device, run.span, mode=run.mode_name)
        state = run.mode.setup(run)
        run.sync()
        setup_s = time.perf_counter() - start
        with profiled(True, run.span) as prof:
            win = run.mode.window(run, state, seconds)
    finally:
        disable_tracing()
    summary = TraceSummary(prof, win["seconds"])
    r = harness.Reading(run, win, summary, None)
    r.tracer = tracer
    steps = max(1, r.steps)
    metrics = {}
    for m in bench["per_layer"]:
        if name in m.get("workloads", [name]):
            value = harness.metric_reader(m["name"])(r)
            if value is not None:
                metrics[m["name"]] = value
    port = sorted({e["name"] for e in tracer.events}) if tracer is not None else []
    idle = {n: idle_ms(r, r.mode, n) for n in port}
    g = gaps(summary)
    syncs = np.array([a for n, (a, _) in zip(summary.host_names, summary.host_iv)
                      if n in SYNCS], np.int64)
    return {
        "workload": name, "seed": seed, "port_tracer": bool(port_tracer),
        "device": harness.device_info(run.device, 0)["kind"], "steps": r.steps,
        "setup_s": setup_s, "metrics": metrics,
        "idle_ms": {"window": 1e3 * (summary.window_s - summary.busy_s) / steps,
                    "gaps": float((g[:, 1] - g[:, 0]).sum()) / 1e6 / steps,
                    **{n: v for n, v in idle.items() if v is not None}},
        "device_mallocs": device_mallocs(r, r.mode),
        "block_csr_s": block_csr_s(r),
        "syncs": {s: summary.host_names.count(s) / steps for s in SYNCS},
        "syncs_in": {n: inside(syncs, ranges(summary, n)) / steps for n in port},
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--port-tracer", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)

    root = Path(__file__).resolve().parent.parent
    os.environ["TORCH_EXTENSIONS_DIR"] = str(root / "build" / "torch_extensions")
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"  # as run.py: one host thread for the CPU libraries
    for p in (root / "src", root):
        if str(p) not in sys.path:
            sys.path.insert(0, str(p))
    import torch

    torch.set_num_threads(1)
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    print(json.dumps(measure(args.workload, args.seed, args.seconds, bool(args.port_tracer),
                             start=START)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
