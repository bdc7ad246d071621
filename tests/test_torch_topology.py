"""The edge kernels' one checked topology (``kernels.topology``), on the CPU.

* On a held topology a second forward and backward of #1/#2 (HAN over its
  one-lane plan, one R-GAT relation), of #3/#4 and a second #5 call run
  no range check: neither ``topology.check_ranges`` nor ``torch.aminmax``
  (the host read).  The same kernels called with raw tensors and a column
  out of range still raise.
* A topology's check reads all its bounds back in one host copy.
"""
import importlib

import pytest
import torch

from repro_torch.core import NABackend, neighbor_aggregate
from repro_torch.graphs import dataset_target, relation_semantic_graphs, synthetic_hetgraph
from repro_torch.graphs import synthetic_labels
from repro_torch.kernels import seg_gat_agg, seg_gat_agg_fused_fp, seg_gat_agg_multigraph
from repro_torch.kernels.topology import Topology
from repro_torch.launch.hgnn_train import build_problem
from repro_torch.models.hgnn import HAN, han_forward, prepare_data

from test_torch_cuda import FUSED_CASES, KERNEL5_CASES, one_thread  # noqa: F401 (a fixture)

topology_mod = importlib.import_module("repro_torch.kernels.topology")
pytestmark = pytest.mark.usefixtures("one_thread")


def _out_of_range(col: torch.Tensor, n_blocks: int) -> torch.Tensor:
    bad = col.clone()
    bad[0, 0] = n_blocks
    return bad


def _han():
    """HAN's training forward and backward on MULTIGRAPH (#1/#2 over the
    one-lane plan's units); raw: #1/#2 on those units, a column out of range."""
    _, data = build_problem("acm", scale=0.05, feat_scale=0.1, block=8, max_edges=20_000,
                            device="cpu")
    params = HAN.init(torch.Generator().manual_seed(0), data, hidden=8, heads=2, att_dim=16)
    params["w_fp"].requires_grad_()

    def run():
        han_forward(params, data, backend=NABackend.MULTIGRAPH).sum().backward()

    lu = data.plan().units()
    n = data.plan().n_dst_blocks * data.plan().block
    G = len(data.graphs)

    def raw():
        seg_gat_agg_multigraph(_out_of_range(lu.col_index, n // lu.masks.shape[-1]), lu.graph_id,
                               lu.dst_row, lu.masks, torch.zeros(G, n, 2), torch.zeros(G, n, 2),
                               torch.zeros(n, 2, 4))

    return run, raw


def _rgat_relation():
    """One R-GAT relation's NA on MULTIGRAPH (#1/#2 at G = 1 on the batch's
    own topology), forward and backward; raw: the same kernels on the
    batch's tables, a column out of range."""
    g = synthetic_hetgraph("acm", scale=0.05, feat_scale=0.1, seed=0)
    target, ncls = dataset_target("acm")
    data = prepare_data(g, relation_semantic_graphs(g), target, ncls, synthetic_labels(g, "acm"),
                        block=8, device="cpu")
    batch = data.graphs[0]
    gen = torch.Generator().manual_seed(1)
    ths, thd, hs = (torch.randn(*s, generator=gen).requires_grad_() for s in (
        (batch.num_src, 2), (batch.num_dst, 2), (batch.num_src, 2, 4)))

    def run():
        neighbor_aggregate(batch, ths, thd, hs, backend=NABackend.MULTIGRAPH).sum().backward()

    R = batch.col_index.shape[0]

    def raw():
        seg_gat_agg_multigraph(
            _out_of_range(batch.col_index, batch.num_src_pad // batch.block),
            torch.zeros(R, dtype=torch.int32), torch.arange(R, dtype=torch.int32), batch.masks,
            torch.zeros(1, batch.num_src_pad, 2), torch.zeros(1, batch.num_dst_pad, 2),
            torch.zeros(batch.num_src_pad, 2, 4))

    return run, raw


def _fused():
    """#3 and #4 on a topology built once; raw: #3 on the tensors, a
    column out of range."""
    col, gid, row, wsel, masks, *rest = (torch.from_numpy(a) for a in FUSED_CASES["seed2"]())
    n = rest[0].shape[0]
    topology = Topology(col, gid, row, masks, n_graphs=wsel.shape[0], ns_pad=n, nd_pad=n)
    leaves = [t.requires_grad_() for t in rest]

    def run():
        seg_gat_agg_fused_fp(col, gid, row, wsel, masks, *leaves,
                             topology=topology).sum().backward()

    def raw():
        seg_gat_agg_fused_fp(_out_of_range(col, n // masks.shape[-1]), gid, row, wsel, masks,
                             *rest)

    return run, raw


def _kernel5():
    """#5 on one graph's topology; raw: #5 on the tensors, a column out of
    range."""
    col, masks, ths, thd, hs, bias = (torch.from_numpy(a)
                                      for a in KERNEL5_CASES["B8-R3-W2-H2-Dh16"]())
    topology = Topology.one_graph(col, masks, ns_pad=ths.shape[0])

    def run():
        seg_gat_agg(col, masks, ths, thd, hs, edge_bias=bias, topology=topology)

    def raw():
        seg_gat_agg(_out_of_range(col, ths.shape[0] // masks.shape[-1]), masks, ths, thd, hs,
                    edge_bias=bias)

    return run, raw


CASES = {"HAN": _han, "R-GAT relation": _rgat_relation, "fused": _fused, "kernel5": _kernel5}


@pytest.mark.parametrize("name", sorted(CASES))
def test_a_held_topology_reads_no_range_and_raw_tensors_are_checked(name, monkeypatch):
    run, raw = CASES[name]()
    run()  # builds and checks the topology where the caller keeps one
    calls = []
    with monkeypatch.context() as m:
        m.setattr(topology_mod, "check_ranges", lambda *a, **k: calls.append("check_ranges"))
        m.setattr(torch, "aminmax", lambda *a, **k: calls.append("aminmax"))
        run()
    assert calls == []
    with pytest.raises(ValueError, match="col_index: entries must lie in"):
        raw()


def test_a_topology_reads_its_bounds_back_in_one_host_copy(monkeypatch):
    col, masks, ths = (torch.from_numpy(a) for a in KERNEL5_CASES["B8-R3-W2-H2-Dh16"]()[:3])
    copies = []
    tolist = torch.Tensor.tolist
    monkeypatch.setattr(torch.Tensor, "tolist", lambda t: copies.append(t.shape) or tolist(t))
    topology = Topology.one_graph(col, masks, ns_pad=ths.shape[0])
    assert copies == [(3, 2)]  # (min, max) of col_index, graph_id and dst_row
    (R, W), B = col.shape, masks.shape[-1]
    assert topology.extents == (R, W, B, 1, ths.shape[0], R * B)
