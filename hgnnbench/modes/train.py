"""Full-batch training steps, driven as the port's training launcher
drives them: ``make_hgnn_train_step`` over the model's forward, AdamW,
and ``train_loop`` called in chunks with no checkpoint until the window
ends.

Set-up draws the weights, builds the port's graphs, and drives the one
train state it builds through ``checked_steps`` steps, then
``warmup_steps`` more, through the same ``train_loop`` call as the
window; the reference then follows the checked steps from the same
weights.  A step's latency runs from the previous step's end (or the
window's start) to its own end, so the steps' latencies add up to the
window.
"""
from __future__ import annotations

import math
import time

import torch

from repro_torch.data import SyntheticHGNNData
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.optim import AdamWConfig, init_opt_state
from repro_torch.train import TrainState, make_hgnn_train_step, train_loop

from .. import check


def _quiet(*_):
    return None


class _Stamped:
    """The port's step function, with the host time of each call's entry
    and return (the return comes before the device is done)."""

    def __init__(self, fn, span):
        self.fn, self.span = fn, span
        self.entries: list[float] = []
        self.enqueue: list[float] = []

    def __call__(self, state, batch):
        t0 = time.perf_counter()
        self.entries.append(t0)
        with self.span("bench/step"):
            out = self.fn(state, batch)
        self.enqueue.append(time.perf_counter() - t0)
        return out


def setup(run) -> dict:
    cfg, traffic, dev, port = run.cfg, run.traffic, run.device, run.port
    opt = AdamWConfig(**cfg["optimizer"])
    tree = port.to_port(run.params)
    state = TrainState(params=tree, opt=init_opt_state(tree, opt),
                       step=torch.zeros((), dtype=torch.int32, device=dev))
    pipeline = SyntheticHGNNData(num_vertices=port.n_target, batch_size=port.n_target,
                                 seed=run.seed % (1 << 62))
    with run.span("bench/setup/train_step"):
        step = _Stamped(make_hgnn_train_step(port.forward_fn(), port.data, opt), run.span)
    reg = MetricsRegistry()

    def loop(state, steps):
        return train_loop(state=state, train_step=step, data=pipeline, steps=steps,
                          log_every=1 << 30, log=_quiet, registry=reg)

    checked = []
    with run.span("bench/warmup/checked_steps"):
        for _ in range(traffic["checked_steps"]):
            state, hist = loop(state, 1)
            checked.append((state, hist[-1]["loss"]))
    t0 = time.perf_counter()
    with run.span("bench/warmup/steps"):
        state, _ = loop(state, traffic["warmup_steps"])
    run.sync()
    est = (time.perf_counter() - t0) / max(1, traffic["warmup_steps"])
    return dict(opt=opt, step=step, loop=loop, state=state, checked=checked, est=est)


def window(run, s: dict, seconds: float) -> dict:
    """Steps until ``seconds`` have passed: (latencies, enqueue times,
    losses logged)."""
    step, loop, state = s["step"], s["loop"], s["state"]
    n0 = len(step.entries)
    chunk_max = max(1, int(run.traffic["chunk_seconds"] / max(s["est"], 1e-6)))
    bounds, losses = [], []
    t0 = time.perf_counter()
    t_end = t0 + seconds
    now = t0
    while now < t_end:
        k = max(1, min(chunk_max, math.ceil((t_end - now) / max(s["est"], 1e-6))))
        with run.span("bench/train_loop"):
            state, hist = loop(state, k)
        now = time.perf_counter()
        bounds.append(now)
        losses += [h["loss"] for h in hist]
    entries = step.entries[n0:]
    lat, prev, i = [], t0, 0
    for end in bounds:  # the steps of a chunk entered before it returned
        chunk = []
        while i < len(entries) and entries[i] <= end:
            chunk.append(entries[i])
            i += 1
        for j in range(len(chunk)):
            stop = chunk[j + 1] if j + 1 < len(chunk) else end
            lat.append(stop - prev)
            prev = stop
    s["state"] = state
    return {"latencies": lat, "enqueue": step.enqueue[n0:], "losses": losses,
            "seconds": bounds[-1] - t0, "count": len(entries)}


def outputs(run, s: dict) -> dict:
    """The program's numbers of the checked steps, in the reference's
    names, on the host: losses, the first gradient as AdamW took it, and
    the params after the last checked step."""
    port, b1 = run.port, s["opt"].b1
    states = [st for st, _ in s["checked"]]
    first_m = port.from_port(states[0].opt["m"])
    return {"losses": [loss for _, loss in s["checked"]],
            "grads": {k: (m / (1 - b1)).cpu() for k, m in first_m.items()},
            "params": {k: v.cpu() for k, v in port.from_port(states[-1].params).items()}}


def reference(run, ref_graph) -> dict:
    return run.ref.train_steps(run.cfg, run.params, ref_graph, run.traffic["checked_steps"])


def numbers(run, prog: dict, ref: dict) -> dict:
    return check.train_numbers(prog, ref, run.params)


def metrics(win: dict) -> dict:
    lat = win["latencies"]
    return {"mean_ms": 1e3 * win["seconds"] / win["count"], "p95_ms": 1e3 * _p95(lat)}


def failed_in_window(win: dict) -> int:
    return sum(1 for v in win["losses"] if not math.isfinite(v))


def _p95(xs: list) -> float:
    """The 95th percentile of all samples, by the nearest rank."""
    ys = sorted(xs)
    return ys[max(0, math.ceil(0.95 * len(ys)) - 1)]
