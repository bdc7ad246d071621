"""Process-wide metrics: counters, gauges, log-bucketed histograms (a
copy of ``repro.obs.metrics``).

The second observability pillar (DESIGN.md §12): where ``obs.trace``
answers *when* each stage ran, this registry answers *how much* — NA
launches, FP rows computed vs reused, per-step latency distributions,
predicted-vs-measured drift gauges.  Series are labeled, so one process
can hold e.g. ``serve.step_ms{admission=similarity}`` next to the FIFO
ablation, and a JSON snapshot is the export format.

Histograms are log-bucketed: observation ``v`` lands in the bucket with
upper edge ``base**k`` for the smallest integer ``k`` with
``base**k >= v`` (non-positive values go to a dedicated underflow
bucket).  Log buckets hold latency spreads spanning 4+ decades — a
compile-step outlier and a steady-state step coexist without choosing
edges up front — and quantiles come back as bucket upper edges, i.e.
conservative (never under-reported).
"""
from __future__ import annotations

import json
import math
import threading

__all__ = [
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsRegistry",
    "get_registry",
    "reset_registry",
]


class Counter:
    """Monotonically increasing count of events."""

    __slots__ = ("value",)
    kind = "counter"

    def __init__(self):
        self.value = 0

    def inc(self, n: int | float = 1) -> None:
        assert n >= 0, f"counter increment must be >= 0, got {n}"
        self.value += n

    def snapshot(self):
        return self.value


class Gauge:
    """Last-write-wins instantaneous value."""

    __slots__ = ("value",)
    kind = "gauge"

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = v

    def snapshot(self):
        return self.value


class Histogram:
    """Log-bucketed histogram: bucket k holds v in (base**(k-1), base**k]."""

    __slots__ = ("base", "buckets", "underflow", "count", "sum", "min", "max", "_log_base")
    kind = "histogram"

    def __init__(self, base: float = 2.0):
        assert base > 1.0, base
        self.base = float(base)
        self._log_base = math.log(self.base)
        self.buckets: dict[int, int] = {}
        self.underflow = 0  # v <= 0
        self.count = 0
        self.sum = 0.0
        self.min = math.inf
        self.max = -math.inf

    def observe(self, v: float) -> None:
        v = float(v)
        self.count += 1
        self.sum += v
        self.min = min(self.min, v)
        self.max = max(self.max, v)
        if v <= 0.0:
            self.underflow += 1
            return
        # round-guard: base**k must bucket exactly on its own edge
        k = math.ceil(round(math.log(v) / self._log_base, 9))
        self.buckets[k] = self.buckets.get(k, 0) + 1

    def bucket_edges(self) -> list[tuple[float, int]]:
        """Sorted (upper_edge, count) pairs for the populated buckets."""
        return [(self.base ** k, self.buckets[k]) for k in sorted(self.buckets)]

    def percentile(self, q: float) -> float:
        """Upper edge of the bucket containing quantile q in [0, 1]
        (0.0 for the underflow bucket); conservative by construction."""
        assert 0.0 <= q <= 1.0, q
        if self.count == 0:
            return 0.0
        rank = q * (self.count - 1)
        seen = self.underflow
        if rank < seen:
            return 0.0
        for k in sorted(self.buckets):
            seen += self.buckets[k]
            if rank < seen:
                return self.base ** k
        return self.base ** max(self.buckets) if self.buckets else 0.0

    @property
    def mean(self) -> float:
        return self.sum / self.count if self.count else 0.0

    def snapshot(self):
        return dict(
            count=self.count,
            sum=self.sum,
            mean=self.mean,
            min=self.min if self.count else None,
            max=self.max if self.count else None,
            underflow=self.underflow,
            base=self.base,
            buckets=[dict(le=edge, count=c) for edge, c in self.bucket_edges()],
            p50=self.percentile(0.5),
            p90=self.percentile(0.9),
            p99=self.percentile(0.99),
        )


class MetricsRegistry:
    """Get-or-create registry of labeled metric series.

    ``counter/gauge/histogram`` return the live series object for
    ``(name, labels)`` — callers keep the handle and mutate it on the
    hot path (a dict lookup is the only registry cost).  Asking for the
    same series under a different kind is a hard error: one name means
    one thing.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._series: dict[tuple, object] = {}

    @staticmethod
    def _key(name: str, labels: dict) -> tuple:
        return (name, tuple(sorted((k, str(v)) for k, v in labels.items())))

    def _get(self, cls, name: str, labels: dict, **kw):
        key = self._key(name, labels)
        with self._lock:
            obj = self._series.get(key)
            if obj is None:
                obj = self._series[key] = cls(**kw)
            elif not isinstance(obj, cls):
                raise TypeError(
                    f"metric {name!r}{labels} already registered as "
                    f"{obj.kind}, requested {cls.kind}"
                )
            return obj

    def counter(self, name: str, **labels) -> Counter:
        return self._get(Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(Gauge, name, labels)

    def histogram(self, name: str, *, base: float = 2.0, **labels) -> Histogram:
        return self._get(Histogram, name, labels, base=base)

    # -- read side ----------------------------------------------------------

    def value(self, name: str, **labels):
        """Raw value of a counter/gauge series (None if absent)."""
        obj = self._series.get(self._key(name, labels))
        if obj is None or isinstance(obj, Histogram):
            return None
        return obj.value

    def snapshot(self) -> dict:
        """JSON-able snapshot: kind -> name -> [{labels, ...series}]."""
        out: dict[str, dict] = {"counters": {}, "gauges": {}, "histograms": {}}
        with self._lock:
            items = list(self._series.items())
        for (name, labels), obj in sorted(items, key=lambda kv: kv[0]):
            bucket = {"counter": "counters", "gauge": "gauges",
                      "histogram": "histograms"}[obj.kind]
            out[bucket].setdefault(name, []).append(
                dict(labels=dict(labels), value=obj.snapshot())
            )
        return out

    def export_json(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.snapshot(), f, indent=1)

    def reset(self) -> None:
        with self._lock:
            self._series.clear()


_DEFAULT = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-wide default registry (launchers scrape this one)."""
    return _DEFAULT


def reset_registry() -> None:
    _DEFAULT.reset()
