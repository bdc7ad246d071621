"""Port parity of kernel #5 (``seg_gat_agg``, the per-graph KERNEL backend).

On CPU tensors the port's wrapper takes its plain PyTorch version; it is
held against the JAX package's Pallas kernel run in interpret mode on the
reference tests' shapes (tests/test_kernels.py:test_seg_gat_agg_shapes),
an all-padding row, fully masked rows, B = 32, 64 and 128, Ns ≠ Nd and
a case for each (V, NK) instantiation of the CUDA kernel's edge walk, each
with a per-head edge bias, at atol=rtol=1e-5 (float32, the same online
softmax in another sum order).  The cases are tests/test_torch_cuda.py's,
which holds the CUDA kernel against the plain version on the card.  Like
the JAX kernel it has no gradient; the SEGMENT and KERNEL backends of
``neighbor_aggregate`` agree with BLOCK; and KERNEL checks a graph's
columns once (the graph's topology, built on its first call), not on
every call."""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro_torch.core import NABackend, batch_semantic_graph, neighbor_aggregate, neighbor_aggregate_multi
from repro_torch.graphs import (
    build_semantic_graph,
    dataset_target,
    relation_semantic_graphs,
    synthetic_hetgraph,
    synthetic_labels,
)
from repro_torch.kernels import seg_gat_agg, seg_gat_agg_multigraph_plain
from repro_torch.kernels.topology import Topology
from repro_torch.models.hgnn import MODELS, prepare_data

from test_torch_cuda import KERNEL5_CASES, one_thread  # noqa: F401 (one_thread: a fixture)

jkernel = importlib.import_module("repro.kernels.seg_gat_agg")
topology_mod = importlib.import_module("repro_torch.kernels.topology")
mg = importlib.import_module("repro_torch.kernels.seg_gat_agg_multigraph")

TOL = dict(rtol=1e-5, atol=1e-5)


def _torch(case):
    return [torch.from_numpy(np.array(a)) for a in case]


@pytest.mark.parametrize("name", sorted(KERNEL5_CASES))
def test_kernel5_plain_matches_pallas_interpret(name, one_thread):
    case = KERNEL5_CASES[name]()
    col, masks, ths, thd, hs, bias = case
    want = jkernel.seg_gat_agg(*map(jnp.asarray, case[:5]), edge_bias=jnp.asarray(bias),
                               interpret=True)
    got = seg_gat_agg(*_torch(case[:5]), edge_bias=torch.from_numpy(bias))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    B = masks.shape[-1]
    dead = np.repeat((col < 0).all(axis=1), B)
    assert (got.numpy()[dead] == 0).all()  # an all-padding row gives exact zeros


@pytest.mark.parametrize("bias", [0.0, 0.7, "0-d"])
def test_kernel5_scalar_bias_matches_pallas_interpret(bias):
    case = KERNEL5_CASES["B8-R3-W2-H2-Dh16"]()
    jb = 0.5 if bias == "0-d" else bias
    tb = torch.tensor(0.5) if bias == "0-d" else bias
    want = jkernel.seg_gat_agg(*map(jnp.asarray, case[:5]), edge_bias=jb, interpret=True)
    got = seg_gat_agg(*_torch(case[:5]), edge_bias=tb)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_kernel5_is_multigraph_kernel_at_one_graph():
    """#5 computes #1's function for G = 1 (tests/test_kernels.py pins the
    identity in JAX); the card compares the two kernels too."""
    col, masks, ths, thd, hs, bias = _torch(KERNEL5_CASES["degenerate-B16"]())
    R = col.shape[0]
    got = seg_gat_agg(col, masks, ths, thd, hs, edge_bias=bias)
    want, _ = seg_gat_agg_multigraph_plain(
        col, torch.zeros(R, dtype=torch.int32), torch.arange(R, dtype=torch.int32), masks,
        ths[None], thd[None], hs, bias[None])
    torch.testing.assert_close(got, want, **TOL)


def test_kernel5_has_no_gradient_like_the_pallas_kernel():
    col, masks, ths, thd, hs, bias = KERNEL5_CASES["B8-R3-W2-H2-Dh16"]()

    def jloss(t):
        return jnp.sum(jkernel.seg_gat_agg(jnp.asarray(col), jnp.asarray(masks), t,
                                           jnp.asarray(thd), jnp.asarray(hs), interpret=True))

    with pytest.raises(NotImplementedError):
        jax.grad(jloss)(jnp.asarray(ths))
    leaves = [t.requires_grad_() for t in _torch((ths, thd, hs))]
    with pytest.raises(NotImplementedError, match="MULTIGRAPH"):
        seg_gat_agg(torch.from_numpy(col), torch.from_numpy(masks), *leaves)
    with torch.no_grad():  # inference under no_grad is fine
        assert seg_gat_agg(torch.from_numpy(col), torch.from_numpy(masks), *leaves).grad_fn is None


@pytest.mark.parametrize("what,match", [
    ("theta_dst rows", "theta_dst"),
    ("float64", "dtype"),
    ("column out of range", "col_index"),
    ("bias length", "edge_bias"),
])
def test_kernel5_checks_its_operands(what, match):
    col, masks, ths, thd, hs, bias = _torch(KERNEL5_CASES["B8-R3-W2-H2-Dh16"]())
    if what == "theta_dst rows":
        thd = thd[:-1]
    elif what == "float64":
        hs = hs.double()
    elif what == "column out of range":
        col = col.clone()
        col[0, 0] = ths.shape[0] // masks.shape[-1]
    else:
        bias = torch.zeros(bias.shape[0] + 1)
    with pytest.raises((ValueError, TypeError), match=match):
        seg_gat_agg(col, masks, ths, thd, hs, edge_bias=bias)


@pytest.mark.parametrize("backend", [NABackend.SEGMENT, NABackend.KERNEL])
def test_segment_and_kernel_backends_agree_with_block(backend):
    """Converted from the test that pinned SEGMENT and KERNEL as not ported:
    both now agree with the BLOCK oracle, on a metapath graph (shared
    vertex space) and on relation graphs (Ns ≠ Nd), one graph at a time and
    through the per-graph loop of ``neighbor_aggregate_multi``."""
    g = synthetic_hetgraph("imdb", scale=0.05, feat_scale=0.02, seed=0)
    sgs = [build_semantic_graph(g, ("movie", "director", "movie"), max_edges=2000)]
    sgs += relation_semantic_graphs(g)
    rng = np.random.default_rng(0)
    H, Dh = 2, 4
    for sg in sgs:
        batch = batch_semantic_graph(sg, block=8)
        ths = torch.from_numpy(rng.standard_normal((sg.num_src, H)).astype(np.float32))
        thd = torch.from_numpy(rng.standard_normal((sg.num_dst, H)).astype(np.float32))
        hs = torch.from_numpy(rng.standard_normal((sg.num_src, H, Dh)).astype(np.float32))
        bias = torch.from_numpy(rng.standard_normal(H).astype(np.float32))
        want = neighbor_aggregate(batch, ths, thd, hs, backend=NABackend.BLOCK, edge_bias=bias)
        got = neighbor_aggregate(batch, ths, thd, hs, backend=backend, edge_bias=bias)
        assert got.shape == (sg.num_dst, H, Dh)
        torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-6)
        multi = neighbor_aggregate_multi([batch], ths[None], thd[None], hs, backend=backend,
                                         edge_bias=bias[None])
        torch.testing.assert_close(multi[0], got, rtol=0, atol=0)


def test_the_card_cases_reach_every_instantiation_of_the_edge_walk():
    """#5 runs #1's edge walk, compiled once per (V, NK) (``lane_groups``):
    KERNEL5_CASES, which the card tests hold against the plain version,
    reach all eight, R-GAT's row (H·Dh = 256) and B = 64 and 128 among
    them."""
    reached = {}
    for name, case in KERNEL5_CASES.items():
        masks, hs = case()[1], case()[4]
        mg.check_edge_shape(name, masks.shape[-1], *hs.shape[1:])
        reached.setdefault(mg.lane_groups(*hs.shape[1:]), []).append((masks.shape[-1], *hs.shape[1:]))
    assert set(reached) == {(v, nk) for v in (1, 4) for nk in (1, 2, 4, 8)}
    assert (16, 4, 64) in reached[4, 2]
    assert {b for b, _, _ in sum(reached.values(), [])} == set(mg.EDGE_BLOCKS)


def test_a_range_check_token_holds_only_for_its_unchanged_tensor():
    """``topology=`` skips the column check only for the tensors it was
    built from, unchanged since (their version counters): another tensor
    with a column out of range, or its own column written out of range
    afterwards, raises."""
    col, masks, ths, thd, hs, bias = _torch(KERNEL5_CASES["B8-R3-W2-H2-Dh16"]())
    token = Topology.one_graph(col, masks, ns_pad=ths.shape[0])
    want = seg_gat_agg(col, masks, ths, thd, hs, edge_bias=bias)
    torch.testing.assert_close(seg_gat_agg(col, masks, ths, thd, hs, edge_bias=bias,
                                           topology=token), want, rtol=0, atol=0)
    bad = col.clone()
    bad[0, 0] = ths.shape[0] // masks.shape[-1]
    with pytest.raises(ValueError, match="col_index"):
        seg_gat_agg(bad, masks, ths, thd, hs, edge_bias=bias, topology=token)
    col[0, 0] = ths.shape[0] // masks.shape[-1]  # in place: the topology's version is stale
    with pytest.raises(ValueError, match="col_index"):
        seg_gat_agg(col, masks, ths, thd, hs, edge_bias=bias, topology=token)


@pytest.mark.parametrize("name,kw", [
    ("R-GAT", dict(hidden=8, heads=2, layers=2)),
    ("S-HGN", dict(hidden=8, heads=2, layers=2, edge_dim=8)),
])
def test_kernel_dispatch_checks_the_columns_once_per_graph(name, kw, monkeypatch):
    """KERNEL's dispatch range-checks a graph's col_index on its first call
    only (``SemanticGraphBatch.topology``): during a second forward neither
    ``topology.check_ranges`` nor ``torch.aminmax`` (the host sync) runs,
    and the logits are the first forward's."""
    g = synthetic_hetgraph("acm", scale=0.05, feat_scale=0.1, seed=0)
    target, ncls = dataset_target("acm")
    data = prepare_data(g, relation_semantic_graphs(g), target, ncls, synthetic_labels(g, "acm"),
                        block=16, device="cpu")
    model = MODELS[name]
    params = model.init(torch.Generator().manual_seed(0), data, **kw)
    calls = []
    with torch.no_grad():
        first = model.forward(params, data, backend=NABackend.KERNEL)
        monkeypatch.setattr(topology_mod, "check_ranges",
                            lambda *a, **k: calls.append("check_ranges"))
        monkeypatch.setattr(torch, "aminmax", lambda *a, **k: calls.append("aminmax"))
        again = model.forward(params, data, backend=NABackend.KERNEL)
    assert calls == []
    torch.testing.assert_close(again, first, rtol=0, atol=0)
