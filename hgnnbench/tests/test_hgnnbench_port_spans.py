"""``port_spans``: the overlap of idle gaps with span ranges on hand-made
intervals and against a brute-force count, each reader's None where it
finds nothing to read, and one measurement at a tiny size on the CPU."""
from __future__ import annotations

import time
from types import SimpleNamespace

import numpy as np
import pytest

from hgnnbench import port_spans
from hgnnbench.tests.test_hgnnbench_run import SEED, TINY
from repro_torch.obs import disable_tracing, enable_tracing, trace_span


@pytest.fixture(autouse=True)
def _clean_tracer():
    disable_tracing()
    yield
    disable_tracing()


def _iv(rows):
    return np.array(rows, np.int64).reshape(-1, 2)


@pytest.mark.parametrize("cover, want", [
    ([[5, 25], [24, 26], [45, 100]], 5 + 6 + 5),  # overlapping cover, counted once
    ([[-10, 0], [10, 20], [50, 60]], 0),  # touching edges only
    ([[0, 50]], 30),
    ([[22, 23], [41, 42]], 2),  # inside single intervals
    ([[45, 100], [5, 25]], 5 + 5 + 5),  # any order
    ([], 0),
])
def test_covered_on_hand_made_intervals(cover, want):
    iv = _iv([[0, 10], [20, 30], [40, 50]])
    assert port_spans.covered(iv, _iv(cover)) == want


def test_inside_counts_points_in_the_union_once():
    cover = _iv([[5, 25], [24, 26], [45, 100]])
    points = np.array([0, 5, 10, 25, 26, 44, 45, 99, 100])
    assert port_spans.inside(points, cover) == 5  # 5, 10, 25, 45, 99; 26 and 100 are ends
    assert port_spans.inside(points, _iv([])) == 0
    assert port_spans.inside(np.array([], np.int64), cover) == 0


def test_covered_matches_a_count_of_unit_cells():
    rng = np.random.default_rng(7)
    for _ in range(50):
        edges = np.sort(rng.choice(200, size=2 * rng.integers(0, 8), replace=False))
        iv = edges.reshape(-1, 2)
        starts = rng.integers(0, 200, size=rng.integers(0, 6))
        cover = np.stack([starts, starts + rng.integers(1, 60, size=starts.size)], axis=1)
        cells = np.zeros(300, bool)
        for a, b in iv:
            cells[a:b] = True
        inside = np.zeros(300, bool)
        for a, b in cover:
            inside[a:b] = True
        assert port_spans.covered(iv, cover) == int((cells & inside).sum())


def _trace(busy, host):
    busy = _iv(busy)
    return SimpleNamespace(busy_iv=busy, busy_s=float((busy[:, 1] - busy[:, 0]).sum()) / 1e9,
                           host_names=[n for n, _, _ in host],
                           host_iv=_iv([[a, b] for _, a, b in host]))


def _reading(trace, steps=2, mode="train", tracer=None):
    r = SimpleNamespace(mode=mode, trace=trace, steps=steps)
    if tracer is not None:
        r.tracer = tracer
    return r


def test_idle_ms_sums_the_gaps_inside_a_spans_ranges_a_step():
    # busy [0, 1) ms, [3, 4) ms, [7, 8) ms: gaps [1, 3) and [4, 7) ms
    ms = 1_000_000
    trace = _trace([[0, ms], [3 * ms, 4 * ms], [7 * ms, 8 * ms]],
                   [("step/forward", 0, 2 * ms), ("step/forward", 4 * ms, 5 * ms),
                    ("step/backward", 5 * ms, 8 * ms), ("aten::mm", 0, 8 * ms)])
    assert port_spans.gaps(trace).tolist() == [[ms, 3 * ms], [4 * ms, 7 * ms]]
    r = _reading(trace)
    assert port_spans.idle_ms(r, "train", "step/forward") == pytest.approx(1.0)  # 2 ms / 2
    assert port_spans.idle_ms(r, "train", "step/backward") == pytest.approx(1.0)
    assert port_spans.idle_ms(r, "train", "step/optimizer") is None  # no such range
    assert port_spans.idle_ms(r, "infer", "step/forward") is None
    assert port_spans.idle_ms(_reading(None), "train", "step/forward") is None
    assert port_spans.idle_ms(_reading(_trace([], [("step/forward", 0, 9)])), "train",
                              "step/forward") is None  # nothing ran on the device


def test_device_mallocs_reads_the_window_s_train_steps_only():
    tracer = enable_tracing()
    with trace_span("train/step") as sp:  # before the window
        sp.annotate(device_mallocs=100)
    lo = time.time_ns()
    for k in (1, 2, 6):
        with trace_span("train/step") as sp:
            sp.annotate(device_mallocs=k)
    with trace_span("train/step"):  # no count: a CPU step
        pass
    disable_tracing()
    trace = _trace([[lo, lo + 1]], [("bench/train_loop", lo, time.time_ns())])
    assert port_spans.device_mallocs(_reading(trace, tracer=tracer), "train") == 3.0
    assert port_spans.device_mallocs(_reading(trace, tracer=tracer), "infer") is None
    assert port_spans.device_mallocs(_reading(trace), "train") is None  # no tracer
    assert port_spans.device_mallocs(_reading(None, tracer=tracer), "train") is None


def test_block_csr_s_adds_the_set_up_spans():
    tracer = enable_tracing()
    for g in ("APA", "APCPA"):
        with trace_span("setup/block_csr", graph=g):
            time.sleep(0.001)
    disable_tracing()
    assert port_spans.block_csr_s(_reading(None, tracer=tracer)) == pytest.approx(
        sum(e["dur"] for e in tracer.spans()) / 1e6)
    assert port_spans.block_csr_s(_reading(None, tracer=tracer)) >= 0.002
    assert port_spans.block_csr_s(_reading(None)) is None
    assert port_spans.block_csr_s(_reading(None, tracer=enable_tracing())) is None


@pytest.mark.parametrize("port_tracer", [True, False])
def test_a_measurement_on_the_cpu(port_tracer):
    name = "rgat-mag.train"
    out = port_spans.measure(name, SEED, 0.3, port_tracer, device="cpu", overrides=TINY[name])
    assert out["steps"] > 0 and out["device"] == "cpu"
    assert "setup.prepare_s" in out["metrics"] and "step.enqueue_ms.train" in out["metrics"]
    assert set(out["idle_ms"]) == {"window", "gaps"}  # no device op: no idle by span
    assert out["device_mallocs"] is None  # counted on the card only
    assert (out["block_csr_s"] is not None) == port_tracer
    if port_tracer:
        assert 0 < out["block_csr_s"] < out["metrics"]["setup.prepare_s"]
    assert out["syncs"] == {"cudaDeviceSynchronize": 0.0, "cudaStreamSynchronize": 0.0}
    if port_tracer:  # one count a port span
        assert {"train/step", "step/forward", "rgat/na"} <= set(out["syncs_in"])
    else:
        assert out["syncs_in"] == {}
    assert not any(out["syncs_in"].values())
