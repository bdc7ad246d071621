"""What the per-layer metric files share: each file under ``metrics/``
names its metric and calls one of these on the run's ``Reading``.  A
reader that finds nothing to read returns None, and the metric is left
out of the line."""
from __future__ import annotations

import math

from .roofline import PEAK_FLOPS


def spans_total(r, prefix: str):
    """Host seconds of the benchmark's spans under ``prefix``."""
    t = r.spans.total(prefix)
    return t if t > 0 else None


def enqueue_ms(r, mode: str):
    """Mean host ms from a step's (or forward's) call to its return, with
    no synchronise."""
    if r.mode != mode or not r.enqueue:
        return None
    return 1e3 * sum(r.enqueue) / len(r.enqueue)


def device_ms(r, mode: str, kernels: tuple[str, ...] = (), gemm: bool = False):
    """Device ms a step of the named kernels (or of the library's
    matrix products)."""
    if r.mode != mode or r.trace is None or r.steps == 0:
        return None
    t = r.trace.gemm_seconds() if gemm else sum(r.trace.kernel_seconds(k) for k in kernels)
    return 1e3 * t / r.steps if t > 0 else None


def roofline(r, kernel: str):
    """A kernel's share of its roofline, %: the least time its launches in
    the window need over their measured device time."""
    if r.trace is None:
        return None
    least, took = r.least_seconds(kernel), r.trace.kernel_seconds(kernel)
    return 100.0 * least / took if least and took > 0 else None


def mfu(r, mode: str):
    """The whole step's share of the float32 peak, %: the flops the
    algorithm needs a step over the peak, over the traced time a step."""
    if r.mode != mode or r.trace is None or not r.work or r.steps == 0:
        return None
    return 100.0 * r.work["flops"] / PEAK_FLOPS["float32"] / (r.trace.window_s / r.steps)


def idle(r, mode: str):
    """Share of the traced window with no kernel, copy or fill on the
    card, %."""
    if r.mode != mode or r.trace is None or r.trace.busy_s <= 0:
        return None
    return 100.0 * max(0.0, 1.0 - r.trace.busy_s / r.trace.window_s)


def p95_ms(r, mode: str):
    """95th percentile (nearest rank) of the traced window's step
    latencies, ms."""
    if r.mode != mode or not r.latencies:
        return None
    ys = sorted(r.latencies)
    return 1e3 * ys[max(0, math.ceil(0.95 * len(ys)) - 1)]
