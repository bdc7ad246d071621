"""Span-based tracing (the counterpart of ``repro.obs.trace``).

Spans around the FP/theta/NA/FA stages, one *lane row* per semantic
graph or serving slot, and a Chrome-trace/Perfetto exporter (DESIGN.md
§12).

* **Near-zero cost when disabled.**  The global tracer is ``None`` by
  default; ``trace_span`` then hands back a shared no-op span, so traced
  code paths compute exactly what untraced ones do.
* **The profiler's clock.**  Spans are stamped in Unix-epoch ns
  (``time.time_ns``), the clock ``torch.profiler`` maps its events onto,
  and exported in µs: a launcher's Chrome trace and a profiler trace of
  the same process line up.  While a ``torch.profiler`` records, each span
  of an enabled tracer is also a profiler range of its own name, beside
  the kernels its code launches.
* **Honest device timing.**  CUDA launches are asynchronous, so a span
  that closes after the launch measures only the enqueue.
  ``Span.sync(value)`` calls ``torch.cuda.synchronize()`` when the tracer
  was enabled with ``sync=True`` and ``value`` holds a CUDA tensor (a
  pass-through otherwise).
* **Deterministic structure.**  Span names, attributes, nesting depth and
  parentage depend only on the code path, never on timing.  Each finished
  span records its ``id`` and its parent's name and id (``parent``,
  ``parent_id``), so self time (a span less its children's cover) follows.

Usage::

    tracer = enable_tracing(sync=True)
    with trace_span("na/APA", stage="NA", lane="sg/APA", edges=n) as sp:
        z = sp.sync(neighbor_aggregate_multi(...))
    tracer.export_chrome_trace("trace.json")   # chrome://tracing, Perfetto
"""
from __future__ import annotations

import itertools
import json
import threading
import time

import torch
import torch.autograd.profiler as _profiler
from torch._C._profiler import _RecordFunctionFast

__all__ = [
    "Span",
    "Tracer",
    "disable_tracing",
    "enable_tracing",
    "get_tracer",
    "trace_span",
    "tracing_enabled",
]

_TRACER: "Tracer | None" = None


def _holds_cuda(value) -> bool:
    if isinstance(value, torch.Tensor):
        return value.is_cuda
    if isinstance(value, (tuple, list)):
        return any(_holds_cuda(v) for v in value)
    if isinstance(value, dict):
        return any(_holds_cuda(v) for v in value.values())
    return False


class Span:
    """A live span.  ``annotate`` adds attributes; ``sync`` optionally
    waits for the device so the close timestamp is honest."""

    __slots__ = ("tracer", "name", "lane", "attrs", "depth", "parent", "parent_id", "id",
                 "t0", "_sync", "_range")

    def __init__(self, tracer, name, lane, attrs, depth, parent, sync):
        self.tracer = tracer
        self.name = name
        self.lane = lane
        self.attrs = attrs
        self.depth = depth
        self.parent = None if parent is None else parent.name
        self.parent_id = None if parent is None else parent.id
        self.id = next(tracer._ids)
        self._sync = sync
        self._range = None
        self.t0 = 0

    def annotate(self, **attrs) -> None:
        self.attrs.update(attrs)

    def sync(self, value):
        if self._sync and _holds_cuda(value):
            torch.cuda.synchronize()
        return value


class _NoopSpan:
    """Shared do-nothing span handed out while tracing is disabled."""

    __slots__ = ()

    def annotate(self, **attrs) -> None:
        pass

    def sync(self, value):
        return value


_NOOP_SPAN = _NoopSpan()


class Tracer:
    """Collects finished spans; exports Chrome-trace JSON.

    Thread-safe: each thread keeps its own span stack, the finished-event
    list and lane-row table are lock-guarded.
    """

    def __init__(self, *, sync: bool = False):
        self.sync = sync
        self.events: list[dict] = []
        self._ids = itertools.count()
        self._lock = threading.Lock()
        self._local = threading.local()
        self._lanes: dict[str, int] = {}

    def _stack(self) -> list:
        st = getattr(self._local, "stack", None)
        if st is None:
            st = self._local.stack = []
        return st

    def _lane_tid(self, lane: str) -> int:
        with self._lock:
            if lane not in self._lanes:
                self._lanes[lane] = len(self._lanes)
            return self._lanes[lane]

    def begin(self, name: str, lane: str | None, attrs: dict, sync: bool | None) -> Span:
        stack = self._stack()
        parent = stack[-1] if stack else None
        if lane is None:
            # inherit the enclosing span's row so nested stages stay on it
            lane = parent.lane if parent is not None else "main"
        sp = Span(self, name, lane, attrs, depth=len(stack), parent=parent,
                  sync=self.sync if sync is None else sync)
        stack.append(sp)
        if _profiler._is_profiler_enabled:  # the range holds the span's stamps
            sp._range = _RecordFunctionFast(name)
            sp._range.__enter__()
        sp.t0 = time.time_ns()
        return sp

    def end(self, span: Span) -> None:
        t1 = time.time_ns()
        if span._range is not None:
            span._range.__exit__(None, None, None)
        stack = self._stack()
        if stack and stack[-1] is span:
            stack.pop()
        elif span in stack:  # mis-nested close; drop it and everything above
            del stack[stack.index(span):]
        event = dict(
            name=span.name,
            ts=span.t0 / 1e3,           # µs since the Unix epoch
            dur=(t1 - span.t0) / 1e3,   # µs
            lane=span.lane,
            tid=self._lane_tid(span.lane),
            depth=span.depth,
            id=span.id,
            parent=span.parent,
            parent_id=span.parent_id,
            attrs=span.attrs,
        )
        with self._lock:
            self.events.append(event)

    def export_chrome_trace(self, path: str) -> None:
        """Chrome-trace JSON (chrome://tracing, https://ui.perfetto.dev),
        one thread row per lane."""
        out = [dict(ph="M", name="process_name", pid=0, tid=0,
                    args=dict(name="repro_torch"))]
        with self._lock:
            lanes = sorted(self._lanes.items(), key=lambda kv: kv[1])
            events = list(self.events)
        for lane, tid in lanes:
            out.append(dict(ph="M", name="thread_name", pid=0, tid=tid,
                            args=dict(name=str(lane))))
        for e in events:
            out.append(dict(
                name=e["name"], ph="X", pid=0, tid=e["tid"],
                ts=e["ts"], dur=e["dur"],
                cat=str(e["attrs"].get("stage", "span")),
                args=dict(e["attrs"], depth=e["depth"], parent=e["parent"]),
            ))
        with open(path, "w") as f:
            json.dump({"traceEvents": out, "displayTimeUnit": "ms"}, f, indent=1)

    def spans(self, name: str | None = None) -> list[dict]:
        with self._lock:
            return [e for e in self.events if name is None or e["name"] == name]


class trace_span:
    """Context manager opening a span on the global tracer.

    ``lane`` picks the timeline row (default: inherit the enclosing span's
    row, else ``"main"``); ``sync`` overrides the tracer's default for this
    span; remaining keywords become span attributes (``stage=`` doubles as
    the Chrome-trace category).
    """

    __slots__ = ("name", "lane", "_sync", "attrs", "_span")

    def __init__(self, name: str, *, lane: str | None = None,
                 sync: bool | None = None, **attrs):
        self.name = name
        self.lane = lane
        self._sync = sync
        self.attrs = attrs
        self._span = None

    def __enter__(self):
        tr = _TRACER
        if tr is None:
            return _NOOP_SPAN
        self._span = tr.begin(self.name, self.lane, dict(self.attrs), self._sync)
        return self._span

    def __exit__(self, exc_type, exc, tb):
        sp = self._span
        if sp is not None:
            self._span = None
            sp.tracer.end(sp)
        return False


def enable_tracing(*, sync: bool = False) -> Tracer:
    """Install a fresh global tracer and return it."""
    global _TRACER
    _TRACER = Tracer(sync=sync)
    return _TRACER


def disable_tracing() -> None:
    """Drop the global tracer; trace_span reverts to the no-op fast path."""
    global _TRACER
    _TRACER = None


def get_tracer() -> Tracer | None:
    return _TRACER


def tracing_enabled() -> bool:
    return _TRACER is not None
