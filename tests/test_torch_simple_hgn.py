"""Simple-HGN's joint NA (one softmax over every relation into a vertex,
the prior layers' attention mixed in) and its trainer entry.

CPU: the plain versions of the joint #1 and #2 against one dense softmax
over all relations and its autograd, with and without prior layers, at
8 heads and at the output layer's 1 × 349 (and its padding to 352); the
training launcher on Simple-HGN, and its refusals.  Card (``cuda``
marker, skipped here): the joint kernels against their plain versions,
twice bitwise equal.  This file imports no JAX."""
import pytest
import torch

from repro_torch.core.fusion import build_joint_graph
from repro_torch.graphs import HetGraph, make_relation
from repro_torch.kernels.seg_gat_agg_multigraph import (
    JointPriors,
    seg_gat_agg_multigraph_joint_bwd,
    seg_gat_agg_multigraph_joint_bwd_plain,
    seg_gat_agg_multigraph_joint_fwd,
    seg_gat_agg_multigraph_joint_plain,
)
from repro_torch.launch import hgnn_train

SLOPE, BETA = 0.05, 0.05
COUNTS = {"a": 21, "b": 13}  # ragged against B = 8: padding rows in both ranges
RELS = {"ab": ("a", "b", 70), "ba": ("b", "a", 60), "aa": ("a", "a", 50), "aa2": ("a", "a", 40)}


def _graph(seed=0):
    """Two vertex types, four relations (two between the same types, so a
    pair of vertices can be joined by edges of two types), distinct pairs
    within a relation, and a self-loop relation a type of one shared type."""
    gen = torch.Generator().manual_seed(seed)
    rels, types = {}, {}
    for i, (name, (st, dt, m)) in enumerate(RELS.items()):
        keys = torch.randperm(COUNTS[st] * COUNTS[dt], generator=gen)[:m]
        rels[name] = make_relation(name, st, dt, (keys // COUNTS[dt]).numpy(),
                                   (keys % COUNTS[dt]).numpy())
        types[name] = i
    for t, n in COUNTS.items():
        ids = torch.arange(n).numpy()
        rels[f"{t}_self"], types[f"{t}_self"] = make_relation(f"{t}_self", t, t, ids, ids), len(RELS)
    g = HetGraph(vertex_counts=COUNTS, features={}, relations=rels)
    return g, build_joint_graph(g, types, block=8, device="cpu")


def _dense(jg, g):
    """[T, N, N] adjacency over the joint table (dst, src)."""
    adj = torch.zeros((jg.num_edge_types, jg.num_rows, jg.num_rows), dtype=torch.bool)
    for name, r in g.relations.items():
        d = torch.as_tensor(r.dst_ids).long() + jg.offsets[r.dst_type]
        s = torch.as_tensor(r.src_ids).long() + jg.offsets[r.src_type]
        adj[jg.edge_types[name], d, s] = True
    return adj


def _dense_p(adj, th_s, th_d, bias):
    """[T, N, N, H]: the softmax over (type, src) of every dst row."""
    pre = th_d[None, :, None, :] + th_s[None, None, :, :] + bias[:, None, None, :]
    lg = torch.where(pre >= 0, pre, SLOPE * pre).masked_fill(~adj[..., None], float("-inf"))
    flat = lg.permute(1, 0, 2, 3).reshape(adj.shape[1], -1, lg.shape[-1])
    p = torch.softmax(flat, dim=1).nan_to_num(0.0)
    return p.reshape(adj.shape[1], adj.shape[0], adj.shape[2], -1).permute(1, 0, 2, 3)


def _operands(jg, H, Dh, K, seed=1):
    gen = torch.Generator().manual_seed(seed)
    n, T = jg.num_rows, jg.num_edge_types
    r = lambda *s: torch.randn(*s, generator=gen)  # noqa: E731
    ops = dict(theta_src=r(n, H), theta_dst=r(n, H), h_src=r(n, H, Dh), edge_bias=r(T, H))
    prior = None
    if K:
        ths, thd, bias = r(K, n, H), r(K, n, H), r(K, T, H)
        idx = jg.index(jg.num_units)
        lse = torch.stack([seg_gat_agg_multigraph_joint_plain(idx, ths[k], thd[k], ops["h_src"],
                                                              bias[k], leaky_slope=SLOPE)[1]
                           for k in range(K)])
        prior = JointPriors(ths, thd, bias, lse, [0.3 + 0.4 * k for k in range(K)])
    return ops, prior


def _dense_out(adj, ops, prior, beta):
    p = _dense_p(adj, ops["theta_src"], ops["theta_dst"], ops["edge_bias"])
    soft = torch.einsum("tijh,jhd->ihd", p, ops["h_src"])
    if prior is None:
        return soft, soft
    alpha = sum(c * _dense_p(adj, prior.theta_src[k], prior.theta_dst[k], prior.bias[k])
                for k, c in enumerate(prior.coef))
    return (1 - beta) * soft + beta * torch.einsum("tijh,jhd->ihd", alpha, ops["h_src"]), soft


CASES = [(2, 8, 0), (2, 8, 1), (2, 8, 2), (1, 349, 0), (1, 352, 1)]


@pytest.mark.parametrize("H,Dh,K", CASES)
def test_joint_plain_forward_is_one_dense_softmax_over_every_relation(H, Dh, K):
    g, jg = _graph()
    adj = _dense(jg, g)
    ops, prior = _operands(jg, H, Dh, K)
    out, lse, soft = seg_gat_agg_multigraph_joint_fwd(jg.index(jg.num_units), **ops,
                                                      priors=prior, beta=BETA, leaky_slope=SLOPE)
    want, want_soft = _dense_out(adj, ops, prior, BETA)
    torch.testing.assert_close(out, want, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(soft, want_soft, atol=1e-5, rtol=1e-5)
    # lse: the joint softmax's log-normaliser, over every type's edges of a live row
    pre = ops["theta_dst"][None, :, None, :] + ops["theta_src"][None, None] \
        + ops["edge_bias"][:, None, None, :]
    lg = torch.where(pre >= 0, pre, SLOPE * pre).masked_fill(~adj[..., None], float("-inf"))
    want_lse = torch.logsumexp(lg.permute(1, 0, 2, 3).reshape(jg.num_rows, -1, H), dim=1)
    live = adj.any(dim=(0, 2))
    torch.testing.assert_close(lse[live], want_lse[live], atol=1e-5, rtol=1e-5)
    assert torch.equal(out[~live], torch.zeros_like(out[~live]))


@pytest.mark.parametrize("H,Dh,K", [(2, 8, 0), (2, 8, 2), (1, 349, 1)])
def test_joint_plain_backward_is_the_dense_formulas_gradient(H, Dh, K):
    g, jg = _graph(3)
    adj = _dense(jg, g)
    ops, prior = _operands(jg, H, Dh, K, seed=4)
    idx = jg.index(jg.num_units)
    out, lse, soft = seg_gat_agg_multigraph_joint_fwd(idx, **ops, priors=prior, beta=BETA,
                                                      leaky_slope=SLOPE)
    g_out = torch.randn(out.shape, generator=torch.Generator().manual_seed(5))
    got = seg_gat_agg_multigraph_joint_bwd(idx, **ops, soft=soft, lse=lse, g_out=g_out,
                                           priors=prior, beta=BETA, leaky_slope=SLOPE)
    leaves = {k: v.clone().requires_grad_() for k, v in ops.items()}
    want_out, _ = _dense_out(adj, leaves, prior, BETA)  # the prior attention: no gradient
    want = torch.autograd.grad((want_out * g_out).sum(), [leaves[k] for k in (
        "theta_src", "theta_dst", "h_src", "edge_bias")])
    for name, a, b in zip(("d_theta_src", "d_theta_dst", "d_h_src", "d_edge_bias"), got, want):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4, msg=lambda m, n=name: f"{n}: {m}")
    assert all(torch.equal(a, b) for a, b in zip(got, seg_gat_agg_multigraph_joint_bwd_plain(
        idx, **ops, soft=soft, lse=lse, g_out=g_out, priors=prior, beta=BETA,
        leaky_slope=SLOPE)))


def test_the_output_layers_padding_leaves_its_columns():
    """349 columns and the same with 3 zero columns (the model's padding to
    352): the first 349 columns and lse agree, the padding stays zero."""
    _, jg = _graph(6)
    ops, _ = _operands(jg, 1, 349, 0, seed=7)
    idx = jg.index(jg.units_of("a"))
    out, lse, _ = seg_gat_agg_multigraph_joint_fwd(idx, **ops, leaky_slope=SLOPE)
    padded = dict(ops, h_src=torch.nn.functional.pad(ops["h_src"], (0, 3)))
    out_p, lse_p, _ = seg_gat_agg_multigraph_joint_fwd(idx, **padded, leaky_slope=SLOPE)
    assert out.shape[0] == jg.units_of("a") * 8 < jg.num_rows
    assert torch.equal(out_p[..., :349], out) and torch.equal(lse_p, lse)
    assert not out_p[..., 349:].any()


def test_joint_graph_keeps_edges_of_two_types_between_one_pair_apart():
    g, jg = _graph()
    idx = jg.index(jg.num_units)
    assert idx["E"] == jg.num_edges == sum(r.num_edges for r in g.relations.values())
    assert jg.offsets == {"a": 0, "b": 24} and jg.num_rows == 40
    assert int(jg.unit_off[-1]) == jg.slot_col.numel() == jg.masks.shape[0]
    with pytest.raises(ValueError, match="first type"):
        jg.units_of("b")


def test_the_launcher_trains_simple_hgn_on_the_cpu_and_refuses_splits():
    kw = dict(dataset="acm", model_name="Simple-HGN", scale=0.05, feat_scale=0.05, block=8,
              hidden=8, heads=2, log=lambda *_: None, device="cpu")
    state, hist, meta = hgnn_train.run_training(steps=3, log_every=1, **kw)
    assert meta["model"] == "Simple-HGN" and meta["backend"] == "multigraph"
    assert len(hist) == 3 and all(torch.isfinite(torch.tensor(h["loss"])) for h in hist)
    assert len(state.params["layers"]) == 3 and "res" in state.params["layers"][-1]
    for bad in (dict(model_split=2), dict(lanes=2), dict(backend="reference")):
        with pytest.raises(ValueError, match="Simple-HGN"):
            hgnn_train.run_training(steps=1, **kw, **bad)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("H,Dh,K", [(8, 64, 1), (8, 64, 0), (1, 352, 0), (2, 8, 2)])
def test_joint_kernels_match_their_plain_versions_on_cuda(cuda, H, Dh, K):
    _, jg = _graph(8)
    ops, prior = _operands(jg, H, Dh, K, seed=9)
    jg_c = build_joint_graph(_graph(8)[0], jg.edge_types, block=8, device=cuda)
    idx_c, idx = jg_c.index(jg_c.num_units), jg.index(jg.num_units)
    to = lambda x: x.to(cuda)  # noqa: E731
    ops_c = {k: to(v) for k, v in ops.items()}
    prior_c = None if prior is None else JointPriors(
        to(prior.theta_src), to(prior.theta_dst), to(prior.bias), to(prior.lse), prior.coef)
    kw = dict(beta=BETA, leaky_slope=SLOPE)
    got = seg_gat_agg_multigraph_joint_fwd(idx_c, **ops_c, priors=prior_c, **kw)
    again = seg_gat_agg_multigraph_joint_fwd(idx_c, **ops_c, priors=prior_c, **kw)
    want = seg_gat_agg_multigraph_joint_fwd(idx, **ops, priors=prior, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))
    for a, b in zip(got, want):
        torch.testing.assert_close(a.cpu(), b, atol=1e-5, rtol=1e-5)
    out, lse, soft = want
    g_out = torch.randn(out.shape, generator=torch.Generator().manual_seed(10))
    bw = seg_gat_agg_multigraph_joint_bwd(idx_c, **ops_c, soft=to(soft), lse=to(lse),
                                          g_out=to(g_out), priors=prior_c, **kw)
    bw2 = seg_gat_agg_multigraph_joint_bwd(idx_c, **ops_c, soft=to(soft), lse=to(lse),
                                           g_out=to(g_out), priors=prior_c, **kw)
    assert all(torch.equal(a, b) for a, b in zip(bw, bw2))
    want_b = seg_gat_agg_multigraph_joint_bwd(idx, **ops, soft=soft, lse=lse, g_out=g_out,
                                              priors=prior, **kw)
    for a, b in zip(bw, want_b):
        torch.testing.assert_close(a.cpu(), b, atol=1e-4, rtol=1e-4)
