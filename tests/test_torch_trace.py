"""The port's tracer (``repro_torch.obs.trace``) on the profiler's clock:
a span of an enabled tracer is a ``torch.profiler`` range of its own name
that starts and ends with it, a disabled tracer opens none, ``id`` and
``parent_id`` give self time, and the spans inside the HGNN step and the
R-GAT forward leave every output bit where it was."""
import json
import time

import pytest
import torch

from repro_torch.core import NABackend
from repro_torch.core.multilane import build_multilane_plan
from repro_torch.data import SyntheticHGNNData
from repro_torch.graphs import dataset_target, relation_semantic_graphs, synthetic_hetgraph
from repro_torch.graphs import synthetic_labels
from repro_torch.launch import hgnn_train
from repro_torch.models.hgnn import HAN, MODELS, han_forward_multilane, live_relations
from repro_torch.models.hgnn import prepare_data
from repro_torch.obs import MetricsRegistry, disable_tracing, enable_tracing, trace_span
from repro_torch.optim import AdamWConfig
from repro_torch.train import init_hgnn_train_state, make_hgnn_train_step, train_loop
from repro_torch.tree import tree_leaves

CLOCK_NS = 50_000  # tracer against profiler, each edge of each span
STEP_PHASES = ("step/loss", "step/forward", "step/backward", "step/optimizer")


@pytest.fixture(autouse=True)
def _clean_tracer():
    disable_tracing()
    yield
    disable_tracing()


def _profiled(fn):
    """Run ``fn`` under a CPU ``torch.profiler``; {name: [(start, end) ns]}
    of its host events."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    out: dict[str, list] = {}
    for e in prof.profiler.kineto_results.events():
        out.setdefault(e.name(), []).append((e.start_ns(), e.start_ns() + e.duration_ns()))
    return out


def _nest():
    with trace_span("t/warm"):
        pass
    with trace_span("t/outer", stage="NA"):
        torch.ones(64, 64).sum()
        with trace_span("t/inner", lane="sg/x"):
            torch.ones(64, 64).mm(torch.ones(64, 64))


def test_a_span_is_a_profiler_range_on_the_profilers_clock(tmp_path):
    tracer = enable_tracing()
    ranges = _profiled(_nest)
    for e in tracer.spans():
        [(start, end)] = ranges[e["name"]]
        t0 = round(e["ts"] * 1e3)
        t1 = t0 + round(e["dur"] * 1e3)
        assert abs(start - t0) < CLOCK_NS and abs(end - t1) < CLOCK_NS, (e, start, end)
        assert start <= t0 and t1 <= end  # the range holds the span
    # the Chrome trace carries the same stamps: one clock with the profiler's
    tracer.export_chrome_trace(str(tmp_path / "t.json"))
    events = [e for e in json.loads((tmp_path / "t.json").read_text())["traceEvents"]
              if e["ph"] == "X"]
    assert [(e["name"], e["ts"], e["dur"]) for e in events] == \
        [(e["name"], e["ts"], e["dur"]) for e in tracer.spans()]
    assert abs(events[0]["ts"] - time.time_ns() / 1e3) < 60e6  # µs since the epoch


def test_a_disabled_tracer_records_no_range():
    ranges = _profiled(_nest)
    assert not {"t/warm", "t/outer", "t/inner"} & set(ranges)
    tracer = enable_tracing()
    _nest()  # no profiler: spans, and still no range
    assert [e["name"] for e in tracer.spans()] == ["t/warm", "t/inner", "t/outer"]


def _self_us(events: list[dict]) -> dict[int, float]:
    """Each span's duration less its children's (they do not overlap)."""
    own = {e["id"]: e["dur"] for e in events}
    for e in events:
        if e["parent_id"] is not None:
            own[e["parent_id"]] -= e["dur"]
    return own


def test_ids_and_parent_ids_give_self_time():
    tracer = enable_tracing()
    with trace_span("a"):
        time.sleep(0.004)
        with trace_span("b"):
            time.sleep(0.010)
            with trace_span("c"):
                time.sleep(0.010)
        with trace_span("b"):
            time.sleep(0.010)
    events = tracer.spans()
    by_id = {e["id"]: e for e in events}
    assert len(by_id) == len(events) == 4
    for e in events:
        parent = by_id.get(e["parent_id"])
        assert (parent and parent["name"]) == e["parent"]
        assert e["depth"] == (0 if parent is None else parent["depth"] + 1)
    own = _self_us(events)
    want = {"a": 4e3, "b": 10e3, "c": 10e3}
    for e in events:  # a sleep runs over, never short
        assert own[e["id"]] >= want[e["name"]], (e, own[e["id"]])
    [root] = [e for e in events if e["parent_id"] is None]
    assert sum(own.values()) == pytest.approx(root["dur"])  # self times tile the root


# -- spans in the HGNN step and the R-GAT forward ------------------------------


def _traced_and_not(fn):
    """(fn() with the tracer off, fn() with it on, the tracer)."""
    off = fn()
    tracer = enable_tracing()
    try:
        on = fn()
    finally:
        disable_tracing()
    return off, on, tracer


def _bitwise(a, b):
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b), strict=True))


def test_han_multilane_train_step_is_bitwise_the_same_traced():
    _, data = hgnn_train.build_problem("acm", device="cpu", scale=0.05, feat_scale=0.1,
                                       block=16, max_edges=20_000)
    plan = build_multilane_plan(data.graphs, 1)
    opt = AdamWConfig(lr=5e-3, weight_decay=0.0)
    state0 = init_hgnn_train_state(HAN, torch.Generator().manual_seed(0), data, opt,
                                   hidden=8, heads=2, att_dim=16)
    step = make_hgnn_train_step(
        lambda p: han_forward_multilane(p, data, plan, backend="kernel"), data, opt)
    n = data.labels.shape[0]

    def two_steps():
        state, hist = train_loop(state=state0, train_step=step,
                                 data=SyntheticHGNNData(n, n // 2, seed=3), steps=2,
                                 log_every=1, log=lambda *_: None, registry=MetricsRegistry())
        return state, [h["loss"] for h in hist]

    (off, loss_off), (on, loss_on), tracer = _traced_and_not(two_steps)
    assert loss_on == loss_off and _bitwise(on.params, off.params) and _bitwise(on.opt, off.opt)
    events = tracer.spans()
    by_id = {e["id"]: e for e in events}
    steps = tracer.spans("train/step")
    assert len(steps) == 2 and all("device_mallocs" not in e["attrs"] for e in steps)  # CPU
    for name in STEP_PHASES:  # each phase a child of its step; the loss in two parts
        spans = tracer.spans(name)
        assert len(spans) == (4 if name == "step/loss" else 2)
        assert {by_id[e["parent_id"]]["name"] for e in spans} == {"train/step"}
    for name in ("han/fp", "han/theta", "na/multilane", "han/fusion", "han/classifier"):
        spans = tracer.spans(name)
        assert len(spans) == 2 and {e["parent"] for e in spans} == {"step/forward"}, name
        assert {e["lane"] for e in spans} == {"main"}


@pytest.fixture(scope="module")
def relation_problem():
    target, ncls = dataset_target("acm")
    g = synthetic_hetgraph("acm", scale=0.05, feat_scale=0.1, seed=0)
    sgs = relation_semantic_graphs(g)
    tracer = enable_tracing()
    try:
        data = prepare_data(g, sgs, target, ncls, synthetic_labels(g, "acm"), block=16,
                            device="cpu")
    finally:
        disable_tracing()
    params = MODELS["R-GAT"].init(torch.Generator().manual_seed(1), data, hidden=8, heads=2,
                                  layers=2)
    return data, params, tracer


def test_block_csr_set_up_is_one_span_a_graph(relation_problem):
    data, _, tracer = relation_problem
    spans = tracer.spans("setup/block_csr")
    assert [e["attrs"]["graph"] for e in spans] == [b.name for b in data.graphs]
    assert all(e["dur"] > 0 for e in spans)


@pytest.mark.parametrize("backend", [NABackend.KERNEL, NABackend.MULTIGRAPH],
                         ids=lambda b: b.value)
def test_rgat_forward_is_bitwise_the_same_traced(relation_problem, backend):
    data, params, _ = relation_problem

    def forward():
        with torch.no_grad():
            return MODELS["R-GAT"].forward(params, data, backend=backend)

    off, on, tracer = _traced_and_not(forward)
    assert torch.equal(on, off)
    layers = len(params["layers"])
    lanes = [f"sg/{data.graphs[i].name}"
             for live, _ in live_relations(data.graphs, data.target_type, layers) for i in live]
    for name in ("rgat/fp", "rgat/na"):  # per live relation and layer, on the relation's lane
        assert [e["lane"] for e in tracer.spans(name)] == lanes
    assert len(tracer.spans("rgat/mean")) == layers and len(tracer.spans("rgat/classifier")) == 1
    inner = tracer.spans("na/multigraph")
    assert len(inner) == (len(lanes) if backend is NABackend.MULTIGRAPH else 0)
    assert {e["parent"] for e in inner} <= {"rgat/na"}
    assert all(e["attrs"]["graph_names"] is not None for e in inner)
