"""The edge side of the multigraph NA kernels #1 and #2, on the CPU.

The CUDA kernels visit the set mask entries of live slots (the edges)
only: #1 walks them in the forward's order with no index; #2 runs a
dst-major pass and a src-major pass over the edge index its topology
builds (``Topology.edge_index``).  Here, where the kernels cannot run:

* the index against a plain reference built by loops, on the reference
  tests' shapes and degenerate cases (padding slots whose masks hold set
  bits, fully masked rows, repeated (graph, row) units, W = 1, B in {8,
  16, 32, 64, 128}): exactly the set entries of live slots, once each, in
  the stated dst-major and src-major orders; and as a property over random
  topologies;
* a plain emulation of #1's walk (kept slots, set j in ascending order)
  against the plain version (atol=rtol=1e-5), and of #2's passes A and B,
  built on the index alone, against ``seg_gat_agg_multigraph_bwd_plain``
  (rtol 1e-4, atol 1e-5); tests/test_torch_multigraph_edges_jax.py holds
  both emulations against the JAX package's interpret-mode kernel;
* a topology held to another topology's operands raises, to the same
  topology in other tensors passes;
* HAN builds its edge index once per data set, R-GAT once per graph, and
  a backward on the model's topology neither builds one nor reads the
  device to check it;
* the shapes #1 and #2 take, and that the card's cases reach each of
  their kernels' instantiations.
"""
import importlib

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro_torch.core import NABackend
from repro_torch.kernels import (
    seg_gat_agg_multigraph,
    seg_gat_agg_multigraph_bwd,
    seg_gat_agg_multigraph_bwd_plain,
    seg_gat_agg_multigraph_fwd,
    seg_gat_agg_multigraph_plain,
)
from repro_torch.launch.hgnn_train import build_problem
from repro_torch.models.hgnn import HAN, RGAT, han_forward
from repro_torch.optim import AdamWConfig
from repro_torch.train import init_hgnn_train_state, make_hgnn_train_step
from test_torch_cuda import (  # noqa: F401 (one_thread: a fixture)
    CARD_MULTI_CASES, MULTI_CASES, REPEATED_UNITS, multigraph_case, one_thread)

mg = importlib.import_module("repro_torch.kernels.seg_gat_agg_multigraph")
topology_mod = importlib.import_module("repro_torch.kernels.topology")
pytestmark = pytest.mark.usefixtures("one_thread")  # the plain versions at B = 64 and 128

SLOPE = 0.2
GRAD_NAMES = ("theta_src", "theta_dst", "h_src", "edge_bias")
FWD_TOL = dict(atol=1e-5, rtol=1e-5)
BWD_TOL = dict(rtol=1e-4, atol=1e-5)


def _padding_with_set_bits():
    """Padding slots whose masks are all set, and a fully masked row."""
    case = list(multigraph_case(41, B=8, U=5, W=4, G=2, nblk=5))
    col, masks = case[0].copy(), case[3].copy()
    masks[col < 0] = True
    masks[2, :, 5, :] = False
    case[0], case[3] = col, masks
    return tuple(case)


EDGE_CASES = dict(MULTI_CASES, **REPEATED_UNITS, **{
    "B=32": lambda: multigraph_case(37, B=32, U=3, W=3, nblk=3),
    "padding-set-bits": _padding_with_set_bits,
})


def _tensors(case):
    return [torch.from_numpy(np.array(a)) for a in case]


def _topology(case):
    col, gid, row, masks, ths, thd = case[:6]
    return topology_mod.Topology(col, gid, row, masks, n_graphs=ths.shape[0],
                                 ns_pad=ths.shape[1], nd_pad=thd.shape[1])


def _index(case):
    return _topology(case).edge_index()


def _reference_index(col, gid, row, masks, G, ns_pad, nd_pad):
    """The index by loops: edges dst-major by (u, i, w, j); src-major by
    (s, graph, u, w, i); units by (graph, dst block) in unit order."""
    U, W, B, _ = masks.shape
    edges = [(u, i, w, j) for u in range(U) for i in range(B) for w in range(W) for j in range(B)
             if col[u, w] >= 0 and masks[u, w, i, j]]
    src = [int(col[u, w]) * B + j for u, i, w, j in edges]
    row_off = [0]
    for r in range(U * B):
        row_off.append(row_off[-1] + sum(1 for u, i, _, _ in edges if u * B + i == r))
    key = [(src[e], int(gid[u]), u, w, i) for e, (u, i, w, _) in enumerate(edges)]
    order = sorted(range(len(edges)), key=lambda e: key[e])
    flat = [src[e] * G + int(gid[edges[e][0]]) for e in order]
    src_off = [sum(1 for f in flat if f < k) for k in range(ns_pad * G + 1)]
    nblk = nd_pad // B
    groups = [[u for u in range(U) if int(gid[u]) * nblk + int(row[u]) == k]
              for k in range(G * nblk)]
    gdst_off = np.cumsum([0] + [len(x) for x in groups])
    return dict(E=len(edges), row_off=row_off, e_src=src, src_off=src_off, src_edge=order,
                src_row=[edges[e][0] * B + edges[e][1] for e in order],
                gdst=(gdst_off.tolist(), [u for x in groups for u in x]))


def _assert_index(index, case):
    col, gid, row, masks, ths, thd = case[:6]
    want = _reference_index(col.numpy(), gid.numpy(), row.numpy(), masks.numpy(),
                            ths.shape[0], ths.shape[1], thd.shape[1])
    assert index["E"] == want["E"] == int(masks[col >= 0].sum())
    for k in ("row_off", "e_src", "src_off", "src_edge", "src_row"):
        assert index[k].dtype == torch.int32 and index[k].tolist() == want[k], k
    assert [t.tolist() for t in index["gdst"]] == [list(x) for x in want["gdst"]]


@pytest.mark.parametrize("name", sorted(EDGE_CASES))
def test_edge_index_matches_a_reference(name):
    case = _tensors(EDGE_CASES[name]())
    _assert_index(_index(case), case)


@settings(max_examples=30, deadline=None)
@given(st.integers(0, 2**32 - 1), st.sampled_from([8, 16, 32]), st.integers(1, 6),
       st.integers(1, 4), st.integers(1, 3), st.integers(1, 5))
def test_edge_index_lists_each_edge_once_in_order(seed, B, U, W, G, nblk):
    rng = np.random.default_rng(seed)
    col = np.full((U, W), -1, np.int32)
    for u in range(U):  # a unit's live columns are distinct, in any slots
        k = rng.integers(0, min(W, nblk) + 1)
        col[u, rng.choice(W, size=k, replace=False)] = rng.choice(nblk, size=k, replace=False)
    masks = rng.random((U, W, B, B)) < 0.1
    gid = rng.integers(0, G, U).astype(np.int32)
    row = rng.integers(0, nblk, U).astype(np.int32)
    ths = np.zeros((G, nblk * B, 1), np.float32)
    case = _tensors((col, gid, row, masks, ths, ths))
    _assert_index(_index(case), case)


# -- the kernels' algorithms in plain code ---------------------------------------


def _emulate_forward(col, gid, row, masks, ths, thd, hs, bias):
    """#1's walk: per unit row, the live slots whose row holds a set bit
    (padding skipped whatever its mask), the online-softmax step over the
    set j only."""
    U, W, B, _ = masks.shape
    H, Dh = hs.shape[1:]
    out = np.zeros((U * B, H, Dh), np.float32)
    lse = np.zeros((U * B, H), np.float32)
    for u in range(U):
        g = gid[u]
        for i in range(B):
            m = np.full(H, -1e30, np.float32)
            l = np.zeros(H, np.float32)
            acc = np.zeros((H, Dh), np.float32)
            td = thd[g, row[u] * B + i]
            for w in range(W):
                js = np.flatnonzero(masks[u, w, i])
                if col[u, w] < 0 or js.size == 0:
                    continue
                s = col[u, w] * B + js
                pre = td + ths[g, s] + bias[g]
                lg = np.where(pre >= 0, pre, SLOPE * pre)
                m_new = np.maximum(m, lg.max(axis=0))
                sc = np.exp(m - m_new)
                p = np.exp(lg - m_new)
                l = l * sc + p.sum(axis=0)
                acc = acc * sc[:, None] + np.einsum("nh,nhd->hd", p, hs[s])
                m = m_new
            out[u * B + i] = acc / np.maximum(l, 1e-9)[:, None]
            lse[u * B + i] = m + np.log(np.maximum(l, 1e-30))
    return out, lse


def _emulate_backward(index, case, out, lse, g_out):
    """#2's passes on the index alone.  Pass A: per (graph, dst vertex), its
    units in gdst order, each unit row's edges in dst-major order: p and
    dpre an edge, d_theta_dst summed.  Pass B: per src vertex and graph,
    the src-major CSR segment: d_h_src += p·g_out, d_theta_src = Σ dpre."""
    _, _, _, masks, ths, thd, hs, bias = case
    B = masks.shape[-1]
    G, ns_pad, H = ths.shape
    nd_pad, Dh = thd.shape[1], hs.shape[-1]
    nblk = nd_pad // B
    off, units = (t.long() for t in index["gdst"])
    row_off, e_src = index["row_off"].long(), index["e_src"].long()
    delta = (g_out * out).sum(-1)
    p_e = torch.zeros(index["E"], H)
    dpre_e = torch.zeros(index["E"], H)
    d_thd = torch.zeros(G, nd_pad, H)
    for k in range(G * nblk):
        g, blk = divmod(k, nblk)
        for i in range(B):
            for u in units[off[k]:off[k + 1]].tolist():
                R = u * B + i
                e = torch.arange(int(row_off[R]), int(row_off[R + 1]))
                s = e_src[e]
                pre = thd[g, blk * B + i] + ths[g, s] + bias[g]
                p = torch.exp(torch.where(pre >= 0, pre, SLOPE * pre) - lse[R])
                dl = p * ((g_out[R][None] * hs[s]).sum(-1) - delta[R])
                dpre = torch.where(pre >= 0, dl, SLOPE * dl)
                p_e[e], dpre_e[e] = p, dpre
                d_thd[g, blk * B + i] += dpre.sum(0)
    src_off, src_edge, src_row = (index[k].long() for k in ("src_off", "src_edge", "src_row"))
    seg = torch.repeat_interleave(torch.arange(ns_pad * G), src_off.diff())
    d_hs = torch.zeros(ns_pad, H, Dh).index_add_(
        0, seg // G, p_e[src_edge][:, :, None] * g_out[src_row])
    d_ths = torch.zeros(ns_pad * G, H).index_add_(0, seg, dpre_e[src_edge])
    return d_ths.view(ns_pad, G, H).transpose(0, 1), d_thd, d_hs, d_thd.sum(1)


def emulated_gradients(case):
    """(emulated #2's gradients, the plain VJP's) of sum(sin(out)) on ``case``."""
    t = _tensors(case)
    out, lse = seg_gat_agg_multigraph_plain(*t)
    g_out = torch.cos(out)  # the cotangent of sum(sin(out))
    got = _emulate_backward(_index(t), t, out, lse, g_out)
    return got, seg_gat_agg_multigraph_bwd_plain(*t, out, lse, g_out)


@pytest.mark.parametrize("name", sorted(EDGE_CASES))
def test_forward_edge_walk_matches_plain(name):
    case = EDGE_CASES[name]()
    got = _emulate_forward(*case)
    want = seg_gat_agg_multigraph_plain(*_tensors(case))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w.numpy(), **FWD_TOL)


@pytest.mark.parametrize("name", sorted(EDGE_CASES))
def test_backward_passes_match_the_plain_vjp(name):
    got, want = emulated_gradients(EDGE_CASES[name]())
    for nm, g, w in zip(GRAD_NAMES, got, want):
        torch.testing.assert_close(g, w, msg=nm, **BWD_TOL)


# -- the index guard ---------------------------------------------------------------------


def _with(case, what):
    """The operands of ``case`` but for one thing."""
    case = [t.clone() for t in case]
    col, gid, row, masks = case[:4]
    if what == "col_index":
        col[0, 0] = (col[0, 0] + 1) % (case[4].shape[1] // masks.shape[-1])
    elif what == "graph_id":
        gid[0] = (gid[0] + 1) % case[4].shape[0]
    elif what == "dst_row":
        row[0] = (row[0] + 1) % (case[5].shape[1] // masks.shape[-1])
    elif what == "masks":
        masks[0, 0, 0, 0] = ~masks[0, 0, 0, 0]
    elif what == "units":
        case = [col[:-1], gid[:-1], row[:-1], masks[:-1], *case[4:]]
    elif what == "ns_pad":
        B = masks.shape[-1]
        case[4] = torch.cat([case[4], torch.zeros(case[4].shape[0], B, case[4].shape[2])], 1)
        case[6] = torch.cat([case[6], torch.zeros(B, *case[6].shape[1:])])
    return case


@pytest.mark.parametrize("what", ["col_index", "graph_id", "dst_row", "masks", "units", "ns_pad"])
def test_an_index_of_another_topology_raises(what):
    case = _tensors(MULTI_CASES["seed7"]())
    topology = _topology(case)
    other = _with(case, what)
    out, lse = seg_gat_agg_multigraph_plain(*other)
    with pytest.raises(ValueError, match="the topology was built for"):
        seg_gat_agg_multigraph_bwd(*other, out, lse, torch.cos(out), topology=topology)
    with pytest.raises(ValueError, match="the topology was built for"):
        seg_gat_agg_multigraph_fwd(*other, topology=topology)
    leaves = [t.requires_grad_() for t in other[4:]]
    with pytest.raises(ValueError, match="the topology was built for"):
        seg_gat_agg_multigraph(*other[:4], *leaves, topology=topology).sum().backward()


def test_an_index_changed_in_place_raises_and_equal_tensors_pass():
    case = _tensors(MULTI_CASES["seed7-degenerate"]())
    topology = _topology(case)
    out, lse = seg_gat_agg_multigraph_plain(*case)
    g_out = torch.cos(out)
    want = seg_gat_agg_multigraph_bwd(*case, out, lse, g_out)
    same = [t.clone() for t in case]  # the same topology in other tensors
    for g, w in zip(seg_gat_agg_multigraph_bwd(*same, out, lse, g_out, topology=topology), want):
        assert torch.equal(g, w)
    case[3][1, 0, 2, 3] = ~case[3][1, 0, 2, 3]  # the topology's own masks, changed after
    with pytest.raises(ValueError, match="masks changed in place"):
        seg_gat_agg_multigraph_bwd(*case, out, lse, g_out, topology=topology)
    with pytest.raises(ValueError, match="masks changed in place"):  # and so every copy
        seg_gat_agg_multigraph_bwd(*same, out, lse, g_out, topology=topology)
    with pytest.raises(TypeError, match="expected a Topology"):
        seg_gat_agg_multigraph_bwd(*same, out, lse, g_out, topology={"E": 0})


# -- built once per topology ---------------------------------------------------------------


@pytest.fixture
def counted_builds(monkeypatch):
    """Counts topology builds, each one range check (``topology.check_ranges``;
    HAN's one-lane plan builds through ``LaneUnits.topology``, R-GAT's
    batches through ``SemanticGraphBatch.topology``).  The card's backward
    builds the edge index on the topology, once (the plain version on the
    CPU reads none)."""
    calls = []
    check = topology_mod.check_ranges

    def counting(**bounds):
        calls.append(bounds["col_index"][0].shape)
        return check(**bounds)

    monkeypatch.setattr(topology_mod, "check_ranges", counting)
    return calls


def _train(model, data, steps, **width):
    opt = AdamWConfig(lr=5e-3, weight_decay=0.0)
    state = init_hgnn_train_state(model, torch.Generator().manual_seed(0), data, opt, **width)
    if model is HAN:
        fwd = lambda p: han_forward(p, data, backend=NABackend.MULTIGRAPH)  # noqa: E731
    else:
        fwd = lambda p: model.forward(p, data, backend=NABackend.MULTIGRAPH)  # noqa: E731
    step = make_hgnn_train_step(fwd, data, opt)
    idx = torch.arange(data.labels.shape[0])
    losses = []
    for _ in range(steps):
        state, m = step(state, {"idx": idx})
        losses.append(float(m["loss"]))
    return losses


def test_han_builds_the_edge_index_once_per_data_set(counted_builds):
    _, data = build_problem("acm", scale=0.05, feat_scale=0.1, block=8, max_edges=20_000,
                            device="cpu")
    losses = _train(HAN, data, 3, hidden=8, heads=2, att_dim=16)
    assert len(counted_builds) == 1 and losses[-1] < losses[0]
    assert data.plan() is data.plan()
    data.graphs = list(data.graphs)[:1]  # another batch set: built anew
    _train(HAN, data, 1, hidden=8, heads=2, att_dim=16)
    assert len(counted_builds) == 2


def test_rgat_builds_each_graphs_edge_index_once(counted_builds):
    _, data = build_problem("acm", scale=0.05, feat_scale=0.1, block=8, max_edges=20_000,
                            device="cpu")
    _train(RGAT, data, 2, hidden=8, heads=2, layers=2)
    assert len(counted_builds) == len(data.graphs)


@pytest.mark.parametrize("model", ["HAN", "R-GAT"])
def test_a_backward_with_the_models_index_reads_nothing_of_the_device(model, monkeypatch):
    """The backward takes the unit tables from the topology autograd kept,
    the same objects at the same version, so ``Topology.holds`` passes them
    without ``torch.equal``; the backward builds no index, sorts nothing
    and checks no range."""
    _, data = build_problem("acm", scale=0.05, feat_scale=0.1, block=8, max_edges=20_000,
                            device="cpu")
    width = (dict(hidden=8, heads=2, att_dim=16) if model == "HAN"
             else dict(hidden=8, heads=2, layers=2))
    reads, backwards = [], []
    bwd = mg.seg_gat_agg_multigraph_bwd

    def counted(mod, name):
        real = getattr(mod, name)
        return lambda *args, **kw: reads.append(name) or real(*args, **kw)

    def watched_bwd(*args, **kw):
        backwards.append(kw.get("topology") is not None)
        with monkeypatch.context() as m:
            for mod, name in ((torch, "equal"), (torch, "sort"), (topology_mod, "check_ranges"),
                              (topology_mod, "build_edge_index")):
                m.setattr(mod, name, counted(mod, name))
            return bwd(*args, **kw)

    monkeypatch.setattr(mg, "seg_gat_agg_multigraph_bwd", watched_bwd)
    losses = _train(HAN if model == "HAN" else RGAT, data, 2, **width)
    per_step = 1 if model == "HAN" else 2 * len(data.graphs)  # R-GAT: a call per layer and graph
    assert backwards == [True] * 2 * per_step and reads == []
    assert all(np.isfinite(losses))


# -- what the kernels take ------------------------------------------------------------------


@pytest.mark.parametrize("B,H,Dh,ok", [
    (8, 2, 8, True), (16, 8, 64, True), (64, 8, 64, True), (128, 4, 64, True),
    (128, 8, 128, True), (16, 3, 3, True), (16, 32, 8, True), (16, 8, 36, True),
    (4, 2, 8, False), (256, 2, 8, False), (48, 2, 8, False), (16, 33, 4, False),
    (16, 8, 132, False), (16, 9, 30, False),
])
def test_the_edge_kernels_take_blocks_to_128_and_a_warps_row(B, H, Dh, ok):
    if ok:
        mg.check_edge_shape("k", B, H, Dh)
    else:
        with pytest.raises(ValueError):
            mg.check_edge_shape("k", B, H, Dh)


def test_the_card_cases_reach_every_instantiation_of_the_edge_kernels():
    """#1 and #2 are compiled once per (V, NK) (``lane_groups``): the card
    tests' cases hold each of the eight against the plain version, R-GAT's
    row (H·Dh = 256) and HAN's at B = 128 among them."""
    reached = {}
    for name, case in CARD_MULTI_CASES.items():
        masks, hs = case()[3], case()[6]
        mg.check_edge_shape(name, masks.shape[-1], *hs.shape[1:])
        reached.setdefault(mg.lane_groups(*hs.shape[1:]), []).append((masks.shape[-1], *hs.shape[1:]))
    assert set(reached) == {(v, nk) for v in (1, 4) for nk in (1, 2, 4, 8)}
    assert (16, 4, 64) in reached[4, 2] and (128, 8, 64) in reached[4, 4]
