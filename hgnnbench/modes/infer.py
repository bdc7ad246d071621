"""Full-graph inference: the model's forward under ``torch.no_grad()``,
back to back, each ending in a device synchronise, as a user refreshing
every embedding waits for it.  A forward's latency runs from the previous
one's end (or the window's start) to its own end.

The window keeps ``kept_outputs`` of its forwards' logits, drawn from the
seed (reservoir samples of all the forwards, and the last), and the
reference's logits judge each of them once the window has closed.
"""
from __future__ import annotations

import random
import time

import torch

from .. import check
from .train import _p95


def setup(run) -> dict:
    params = run.port.to_port(run.params)
    fwd = run.port.forward_fn()

    def forward():
        with run.span("bench/forward"), torch.no_grad():
            return fwd(params)

    with run.span("bench/warmup/forwards"):
        for _ in range(run.traffic["warmup_forwards"]):
            forward()
        run.sync()
    return {"forward": forward}


def window(run, s: dict, seconds: float) -> dict:
    forward = s["forward"]
    pick = random.Random(run.seed)
    kept: list = [None] * max(0, run.traffic["kept_outputs"] - 1)
    lat, enqueue, last = [], [], None
    t0 = time.perf_counter()
    t_end, prev = t0 + seconds, t0
    while prev < t_end:
        a = time.perf_counter()
        last = forward()
        enqueue.append(time.perf_counter() - a)
        run.sync()
        now = time.perf_counter()
        lat.append(now - prev)
        prev = now
        n = len(lat)
        for i in range(len(kept)):  # reservoir samples of the forwards so far
            if pick.random() * n < 1:
                kept[i] = last
    s["kept"] = [o for o in kept if o is not None] + [last]
    return {"latencies": lat, "enqueue": enqueue, "seconds": prev - t0, "count": len(lat)}


def outputs(run, s: dict) -> list:
    return s.pop("kept")


def reference(run, ref_graph) -> torch.Tensor:
    with torch.no_grad():
        return run.ref.forward(run.cfg, run.params, ref_graph)


def numbers(run, prog: list, ref: torch.Tensor) -> dict:
    return {"logit_gap": check.logit_gap(prog, ref)}


def metrics(win: dict) -> dict:
    return {"mean_ms": 1e3 * win["seconds"] / win["count"],
            "p95_ms": 1e3 * _p95(win["latencies"])}


def failed_in_window(win: dict) -> int:
    return 0
