"""The plain references against the port at a tiny size on the CPU (where
the port's kernel wrappers run their plain versions), and the roofline
counts against a hand-worked graph."""
from __future__ import annotations

import copy

import numpy as np
import pytest
import torch

from hgnnbench import harness, roofline
from hgnnbench.data import dblp, ogbn_mag
from hgnnbench.reference import han as ref_han
from hgnnbench.reference import rgat as ref_rgat
from hgnnbench.tests.test_hgnnbench_inputs import TINY_MAG
from hgnnbench.trace import Spans, _merge

SEED = 2**31 + 99
# float32 on both sides, summed in other orders (dense softmax against the
# port's online block softmax, index_add against segment sums): a few ulps
# of the largest logit
LOGIT_RTOL = 2e-6


def _setup(name: str, overrides: dict):
    run = harness.Run(harness.benchmark(), name, SEED, "cpu", overrides)
    inputs = harness.module("data", run.cfg["dataset"]).make(run.cfg, SEED, run.device)
    gen = torch.Generator().manual_seed(SEED)
    params = run.ref.init_params(run.cfg, inputs, gen, run.device)
    port = harness.module("models", run.cfg["model"]).Port(run.cfg, inputs, run.device, Spans(),
                                                           mode=run.mode_name)
    return run, inputs, params, port


def _gap(a, b):
    return float((a - b).abs().max() / b.abs().max())


def test_composition_equals_the_ports_semantic_graphs():
    cfg = copy.deepcopy(harness.config("han-dblp"))
    cfg["scale"] = cfg["feat_scale"] = 0.1
    inputs = dblp.make(cfg, SEED)
    from hgnnbench.models.han import hetgraph
    from repro_torch.graphs import build_semantic_graphs
    sgs = build_semantic_graphs(hetgraph(inputs), [tuple(m) for m in cfg["graph"]["metapaths"]])
    for sg, mp in zip(sgs, cfg["graph"]["metapaths"]):
        adj = ref_han.compose(inputs, tuple(mp), "cpu")
        dense = np.zeros(adj.shape, bool)
        dense[sg.dst_ids, sg.src_ids] = True
        assert np.array_equal(adj.numpy(), dense)


def test_han_reference_matches_the_port():
    run, inputs, params, port = _setup("han-dblp.train", {"scale": 0.05, "feat_scale": 0.05})
    graph = ref_han.prepare(run.cfg, inputs, "cpu")
    want = ref_han.forward(run.cfg, params, graph)
    got = port.forward_fn()(port.to_port(params))
    assert _gap(got, want) < LOGIT_RTOL
    # the port's tree and back is the identity on the reference's names
    back = port.from_port(port.to_port(params))
    assert set(back) == set(params) and all(torch.equal(back[k], params[k]) for k in params)


@pytest.mark.parametrize("name", ["rgat-mag.train", "rgat-mag.infer"])
def test_rgat_reference_matches_the_port(name):
    run, inputs, params, port = _setup(name, {"graph": TINY_MAG})
    graph = ref_rgat.prepare(run.cfg, inputs, "cpu")
    want = ref_rgat.forward(run.cfg, params, graph)
    with torch.no_grad():
        got = port.forward_fn()(port.to_port(params))
    assert _gap(got, want) < LOGIT_RTOL
    back = port.from_port(port.to_port(params))
    assert set(back) == set(params) and all(torch.equal(back[k], params[k]) for k in params)


def test_rgat_chunks_sum_to_the_whole(monkeypatch):
    """The reference's edge chunks (under checkpoint) add up to one pass."""
    cfg = copy.deepcopy(harness.config("rgat-mag"))
    cfg["graph"] = TINY_MAG
    inputs = ogbn_mag.make(cfg, SEED, "cpu")
    params = ref_rgat.init_params(cfg, inputs, torch.Generator().manual_seed(1), "cpu")
    graph = ref_rgat.prepare(cfg, inputs, "cpu")
    whole = ref_rgat.forward(cfg, params, graph)
    monkeypatch.setattr(ref_rgat, "CHUNK_EDGES", 257)
    leaves = {k: p.clone().requires_grad_() for k, p in params.items()}
    chunked = ref_rgat.forward(cfg, leaves, graph)
    assert _gap(chunked.detach(), whole) < LOGIT_RTOL
    chunked.sum().backward()
    assert all(torch.isfinite(p.grad).all() for p in leaves.values() if p.grad is not None)


def test_roofline_counts_on_a_hand_worked_graph():
    # 3 edges into 2 dst rows from 2 src rows, one graph, 1 head of 2
    assert roofline.na_forward(3, 2, 2, 1, 1, 2, lse=True) == (31.0, 76.0)
    assert roofline.na_forward(3, 2, 2, 1, 1, 2, lse=False) == (31.0, 68.0)
    assert roofline.na_backward(3, 2, 2, 1, 1, 2) == (54.0, 116.0)
    # x [3, 4] @ w [4, 2 heads x 2] + b, two coefficient vectors
    assert roofline.fp_coeff(3, 4, 2, 2) == (156.0, 256.0)
    assert roofline.least_seconds(0.0, 3.35e12) == pytest.approx(1.0)
    assert roofline.least_seconds(roofline.PEAK_FLOPS["float32"], 1.0) == pytest.approx(1.0)


def test_work_counts_every_launch():
    run, inputs, params, port = _setup("rgat-mag.train", {"graph": TINY_MAG})
    graph = ref_rgat.prepare(run.cfg, inputs, "cpu")
    train = ref_rgat.work(run.cfg, graph, "train")
    infer = ref_rgat.work(run.cfg, graph, "infer")
    n_rel = len(ref_rgat.relations(run.cfg))
    layers = run.cfg["widths"]["layers"]
    assert len(train["kernels"]["seg_gat_agg_multigraph"]) == n_rel * layers
    # the last layer's backward reaches only the relations into papers
    into_paper = sum(dt == "paper" for st, dt, _, _ in graph["rels"].values())
    assert into_paper < len(train["kernels"]["seg_gat_agg_multigraph_bwd"]) < n_rel * layers
    assert len(infer["kernels"]["fused_fp_coeff"]) == 2 * n_rel * layers
    assert len(infer["kernels"]["seg_gat_agg"]) == n_rel * layers
    assert train["flops"] > infer["flops"] > 0


def test_busy_union_of_overlapping_device_ops():
    iv = np.array([[0, 10], [5, 12], [20, 25], [22, 23], [30, 31]], np.int64)
    assert _merge(iv).tolist() == [[0, 12], [20, 25], [30, 31]]
