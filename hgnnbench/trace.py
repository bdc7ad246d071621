"""Spans of the benchmark's own calls and the reduction of a
``torch.profiler`` trace of the measured window to what the per-layer
readers take: device time by kernel, the busy share, the longest device
ops and idle gaps.

A kernel is found by its name, as the profiler records it: ``KERNELS``
maps each of the port's hand-written kernels to the names of the CUDA
functions its launch runs, ``GEMM`` marks the library's matrix products.
"""
from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

# kernel (the port's module name) -> CUDA function names its launch runs
KERNELS = {
    "seg_gat_agg_multigraph": ("multigraph_fwd_kernel",),             # 1
    "seg_gat_agg_multigraph_bwd": ("edge_pass_a", "edge_pass_b"),     # 2
    "seg_gat_agg": ("seg_gat_agg_kernel",),                           # 5
    "fused_fp_coeff": ("fused_fp_coeff_wgmma_kernel", "fused_fp_coeff_kernel",
                       "split_transpose_w"),                          # 6
}
GEMM = ("gemm", "gemv", "nvjet", "xmma", "cutlass", "gemmk")
_OWN = tuple(n for names in KERNELS.values() for n in names)
_DEVICE_ACTIVITIES = ("kernel", "memcpy", "memset")


class Spans:
    """Host-clock spans around the benchmark's calls into the port
    (``name``, start, end), and the same names as profiler ranges while
    a trace is on."""

    def __init__(self):
        self.records: list[tuple[str, float, float]] = []
        self.profiling = False

    @contextlib.contextmanager
    def __call__(self, name: str):
        rf = torch.profiler.record_function(name) if self.profiling else contextlib.nullcontext()
        t0 = time.perf_counter()
        with rf:
            yield
        self.records.append((name, t0, time.perf_counter()))

    def total(self, prefix: str) -> float:
        return sum(t1 - t0 for n, t0, t1 in self.records if n.startswith(prefix))


def _start_end(e) -> tuple[int, int]:
    if hasattr(e, "start_ns"):
        return e.start_ns(), e.start_ns() + e.duration_ns()
    return e.start_us() * 1000, (e.start_us() + e.duration_us()) * 1000


def _is_device_op(e) -> bool:
    if e.device_type() != torch.autograd.DeviceType.CUDA:
        return False
    if getattr(e, "is_user_annotation", lambda: False)():
        return False
    kind = str(e.activity_type()).lower() if hasattr(e, "activity_type") else "kernel"
    return any(a in kind for a in _DEVICE_ACTIVITIES)


def _merge(iv: np.ndarray) -> np.ndarray:
    """Sorted disjoint union of [start, end) rows."""
    if iv.size == 0:
        return iv.reshape(0, 2)
    iv = iv[np.argsort(iv[:, 0], kind="stable")]
    end = np.maximum.accumulate(iv[:, 1])
    new = np.ones(len(iv), bool)
    new[1:] = iv[1:, 0] > end[:-1]
    starts = iv[new, 0]
    ends = np.append(end[np.nonzero(new)[0][1:] - 1], end[-1])
    return np.stack([starts, ends], axis=1)


class TraceSummary:
    """The device ops of one traced window: names, [start, end) in ns,
    and the host's profiler ranges to label idle gaps with."""

    def __init__(self, prof, window_s: float):
        events = prof.profiler.kineto_results.events()
        dev, host = [], []
        for e in events:
            if _is_device_op(e):
                dev.append((e.name(), *_start_end(e)))
            elif e.device_type() == torch.autograd.DeviceType.CPU:
                host.append((e.name(), *_start_end(e)))
        self.names = [d[0] for d in dev]
        self.iv = np.array([d[1:] for d in dev], np.int64).reshape(-1, 2)
        self.host_names = [h[0] for h in host]
        self.host_iv = np.array([h[1:] for h in host], np.int64).reshape(-1, 2)
        self.window_s = float(window_s)
        self.busy_iv = _merge(self.iv)
        self.busy_s = float((self.busy_iv[:, 1] - self.busy_iv[:, 0]).sum()) / 1e9

    def seconds(self, names: tuple[str, ...], *, exclude: tuple[str, ...] = ()) -> float:
        """Device seconds of the ops whose name holds one of ``names``
        (and none of ``exclude``)."""
        dur = self.iv[:, 1] - self.iv[:, 0]
        pick = [i for i, n in enumerate(self.names)
                if any(k in n for k in names) and not any(k in n for k in exclude)]
        return float(dur[pick].sum()) / 1e9 if pick else 0.0

    def kernel_seconds(self, kernel: str) -> float:
        return self.seconds(KERNELS[kernel])

    def gemm_seconds(self) -> float:
        return self.seconds(GEMM, exclude=_OWN)

    def device_ops(self, top: int = 10) -> list[list]:
        dur = self.iv[:, 1] - self.iv[:, 0]
        sums: dict[str, int] = {}
        for n, d in zip(self.names, dur):
            sums[n] = sums.get(n, 0) + int(d)
        best = sorted(sums.items(), key=lambda kv: -kv[1])[:top]
        return [[n[:160], v / 1e9] for n, v in best]

    def idle_gaps(self, top: int = 10) -> list[list]:
        """The longest gaps between device ops, each named by the
        innermost host ranges open at its middle: the benchmark's span and
        the port's operator."""
        b = self.busy_iv
        if len(b) < 2:
            return []
        gaps = np.stack([b[:-1, 1], b[1:, 0]], axis=1)
        order = np.argsort(gaps[:, 0] - gaps[:, 1], kind="stable")[:top]
        out = []
        for g0, g1 in gaps[order]:
            mid = (g0 + g1) // 2
            live = np.nonzero((self.host_iv[:, 0] <= mid) & (self.host_iv[:, 1] > mid))[0]
            spans = [i for i in live if self.host_names[i].startswith("bench/")]
            ops = [i for i in live if not self.host_names[i].startswith("bench/")]
            inner = lambda ix: max(ix, key=lambda i: self.host_iv[i, 0])  # noqa: E731
            label = " > ".join(self.host_names[inner(ix)][:80] for ix in (spans, ops) if ix)
            out.append([label or "no host range", float(g1 - g0) / 1e9])
        return out


@contextlib.contextmanager
def profiled(enabled: bool, spans: Spans):
    """A ``torch.profiler`` over the block (CPU ranges and CUDA ops) when
    ``enabled``; yields the profiler or None."""
    if not enabled:
        yield None
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        spans.profiling = True
        try:
            yield prof
        finally:
            spans.profiling = False
