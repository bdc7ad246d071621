"""S-HGN / Simple-HGN (Lv et al., KDD'21): the counterpart of
``repro.models.hgnn.shgn`` (``SHGN``), and the model as HGB publishes it
(``SIMPLE_HGN``, below).

Table 2 semantics: type-specific FP, GAT-style NA whose logits carry a
learnable *edge-type* term a_e^T (W_r r) — constant per relation, so it
enters the decomposed NA as the per-head ``edge_bias`` (computed on the
device and handed to the kernel as a pointer), residual connections, and
no separate SF stage (relations fuse inside NA layers).

Backends: as R-GAT's; on KERNEL each relation and layer is two launches
of kernel #6 (the src and the dst side's FP+θ through the layer's shared
``w``) and one of kernel #5 with its ``edge_bias[H]``.  The input FP,
done once per vertex type with no θ, stays a plain product.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from ...core.fusion import (
    NABackend,
    build_joint_graph,
    neighbor_aggregate,
    neighbor_aggregate_joint,
    project_coefficients,
)
from ...graphs.hetgraph import HetGraph, make_relation
from ...kernels.seg_gat_agg_multigraph import JointPriors
from ...obs.trace import trace_span
from ...runtime import resolve_device
from ...tree import tree_map
from .common import HGNNData, HGNNModel, glorot


def init_shgn(
    gen: torch.Generator,
    data: HGNNData,
    *,
    hidden: int = 64,
    heads: int = 4,
    layers: int = 2,
    edge_dim: int = 64,
) -> dict:
    """S-HGN parameters (the reference's tree), drawn from ``gen`` in a
    fixed order and placed on the data's device."""
    dims = data.feature_dims
    n_rel = len(data.graphs)
    # type-specific input projection (the FP stage; done once)
    fp = {t: glorot(gen, (d, heads * hidden)) for t, d in dims.items()}
    layer_params = []
    for _ in range(layers):
        layer_params.append(
            {
                "w": glorot(gen, (heads * hidden, heads * hidden)),
                "a_src": glorot(gen, (heads, hidden)),
                "a_dst": glorot(gen, (heads, hidden)),
                "a_edge": glorot(gen, (heads, edge_dim)),
                "r_emb": glorot(gen, (n_rel, edge_dim)),
                "w_r": glorot(gen, (edge_dim, edge_dim)),
            }
        )
    params = {
        "fp": fp,
        "layers": layer_params,
        "w_out": glorot(gen, (heads * hidden, data.num_classes)),
        "b_out": torch.zeros(data.num_classes),
    }
    dev = data.features[data.target_type].device
    return tree_map(lambda t: t.to(dev), params)


def shgn_forward(params, data: HGNNData, *, backend: NABackend = NABackend.SEGMENT):
    # FP: each vertex type projected exactly once
    h = {t: data.features[t] @ params["fp"][t] for t in data.features}
    for lp in params["layers"]:
        agg: dict[str, list[torch.Tensor]] = {}
        for i, batch in enumerate(data.graphs):
            hs, th_s, _ = project_coefficients(h[batch.src_type], lp["w"], lp["a_src"],
                                               lp["a_dst"], backend=backend)
            _, _, th_d = project_coefficients(h[batch.dst_type], lp["w"], lp["a_src"],
                                              lp["a_dst"], backend=backend)
            # edge-type attention term: one number per (relation, head)
            r = lp["r_emb"][i] @ lp["w_r"]  # [edge_dim]
            edge_bias = lp["a_edge"] @ r    # [heads]
            z = neighbor_aggregate(batch, th_s, th_d, hs, backend=backend, edge_bias=edge_bias)
            agg.setdefault(batch.dst_type, []).append(z.reshape(batch.num_dst, -1))
        h_new = {}
        for t in h:
            if t in agg:
                s = torch.stack(agg[t]).sum(dim=0)
                h_new[t] = F.elu(s) + h[t]  # residual
            else:
                h_new[t] = h[t]
        h = h_new
    out = h[data.target_type]
    out = out / torch.linalg.vector_norm(out, dim=-1, keepdim=True).clamp(min=1e-9)
    return out @ params["w_out"] + params["b_out"]


SHGN = HGNNModel(name="S-HGN", init=init_shgn, forward=shgn_forward)


# -- Simple-HGN as published --------------------------------------------------------
#
# HGB's myGAT (github.com/THUDM/HGB, NC/benchmark/methods/baseline: GNN.py,
# conv.py).  Every vertex in one table; per type an input projection
# h0 = x M_t + b_t; then per GAT layer l, with one W^l for all types:
#
#   g = h W^l  [N, H, D],  theta_src = <g, a_src>, theta_dst = <g, a_dst>
#   bias[psi] = <W_r^l e^l_psi, a_edge> a head, e^l_psi the layer's embedding
#               of edge type psi
#   p = softmax over every in-edge j of i, of every type, of
#       LeakyReLU_0.05(theta_dst[i] + theta_src[j] + bias[psi(i, j)])
#   alpha^1 = p^1, alpha^l = (1 - beta) p^l + beta alpha^{l-1} (detached)
#   z_i = sum_j alpha_ij g_j
#
# hidden layers: ELU(z + res), res none in layer 1 and the identity after;
# the output layer (1 head of C, res = h W_res, no activation, and, as
# myGAT calls it, no residual attention: alpha^{l-1} has H heads and the
# layer 1), then logits / max(|logits|_2, 1e-12).  The NA is
# core.fusion.neighbor_aggregate_joint (one launch of the joint #1 a layer,
# one of the joint #2 under autograd); the output layer's width is padded
# to a multiple of 4 columns (zero columns of W, sliced off before the
# residual), the row the kernels' float4 lane groups take.

SIMPLE_HGN_BETA = 0.05   # residual attention's share (HGB: --alpha)
SIMPLE_HGN_SLOPE = 0.05  # LeakyReLU's negative slope (HGB: --slope)


def simple_hgn_graph(g: HetGraph) -> tuple[HetGraph, dict[str, int]]:
    """HGB's graph of ``g``: each relation, its reverse ``<name>_rev`` and a
    self-loop relation ``<type>_self`` a vertex type, with the edge types
    (relation i -> i, its reverse -> R + i, every self-loop -> 2R)."""
    rels, types = {}, {}
    n_rel = len(g.relations)
    for i, (name, r) in enumerate(g.relations.items()):
        rels[name], types[name] = r, i
        rels[f"{name}_rev"], types[f"{name}_rev"] = r.reversed(f"{name}_rev"), n_rel + i
    for t, n in g.vertex_counts.items():
        ids = np.arange(int(n), dtype=np.int32)
        rels[f"{t}_self"], types[f"{t}_self"] = make_relation(f"{t}_self", t, t, ids, ids), 2 * n_rel
    return HetGraph(vertex_counts=g.vertex_counts, features=g.features, relations=rels), types


def prepare_simple_hgn(g: HetGraph, edge_types: dict[str, int], target_type: str,
                       num_classes: int, labels=None, *, block: int = 8,
                       device: str | torch.device = "cuda") -> HGNNData:
    """Simple-HGN's inputs on ``device``: the features and the
    :class:`~repro_torch.core.fusion.JointGraph` of every relation of ``g``
    (the target type first in its table), no per-relation graphs."""
    device = resolve_device(device)
    order = [target_type] + [t for t in g.vertex_counts if t != target_type]
    g = HetGraph(vertex_counts={t: g.vertex_counts[t] for t in order}, features=g.features,
                 relations=g.relations)
    return HGNNData(
        features={t: torch.as_tensor(g.features[t], device=device) for t in order},
        graphs=[], target_type=target_type, num_classes=num_classes,
        labels=None if labels is None else torch.as_tensor(labels, device=device).long(),
        joint=build_joint_graph(g, edge_types, block=block, device=device))


def init_simple_hgn(gen: torch.Generator, data: HGNNData, *, hidden: int = 64, heads: int = 8,
                    layers: int = 2, edge_dim: int = 64) -> dict:
    """Simple-HGN's parameters: ``fp[type]`` (w, b), then ``layers`` hidden
    GAT layers and the output layer, each (w, a_src, a_dst, a_edge,
    edge_emb, w_r), the output layer with ``res`` too; drawn from ``gen`` in
    a fixed order (biases zero) and placed on the data's device."""
    n_types, n_cls = data.joint.num_edge_types, data.num_classes
    params = {"fp": {t: {"w": glorot(gen, (d, hidden)), "b": torch.zeros(hidden)}
                     for t, d in data.feature_dims.items()}, "layers": []}
    d_in = hidden
    for layer in range(layers + 1):
        h, dh = (1, n_cls) if layer == layers else (heads, hidden)
        lp = {"w": glorot(gen, (d_in, h * dh)), "a_src": glorot(gen, (h, dh)),
              "a_dst": glorot(gen, (h, dh)), "a_edge": glorot(gen, (h, edge_dim)),
              "edge_emb": glorot(gen, (n_types, edge_dim)),
              "w_r": glorot(gen, (edge_dim, h * edge_dim))}
        if layer == layers:
            lp["res"] = glorot(gen, (d_in, n_cls))
        params["layers"].append(lp)
        d_in = heads * hidden
    dev = data.features[data.target_type].device
    return tree_map(lambda t: t.to(dev), params)


def _edge_bias(lp) -> torch.Tensor:
    """[T, H]: each edge type's attention term a head."""
    heads, edge_dim = lp["a_edge"].shape
    r = (lp["edge_emb"] @ lp["w_r"]).reshape(-1, heads, edge_dim)
    return (r * lp["a_edge"]).sum(dim=-1)


def simple_hgn_forward(params, data: HGNNData, *, backend: NABackend = NABackend.MULTIGRAPH,
                       beta: float = SIMPLE_HGN_BETA, leaky_slope: float = SIMPLE_HGN_SLOPE):
    """Simple-HGN logits ``[N_target, C]`` (L2-normalised rows).

    Spans (DESIGN.md §12): per layer ``simple_hgn/fp`` (the product, θ and
    the edge types' terms) and ``simple_hgn/na`` on lane ``dst/<types>``
    (the types whose rows the layer's NA computes), the input projection a
    ``simple_hgn/fp`` of its own, and last ``simple_hgn/classifier`` (the
    output layer's residual and the norm)."""
    jg = data.joint
    if jg is None:
        raise ValueError("Simple-HGN needs prepare_simple_hgn's data (its JointGraph)")
    n = jg.num_rows
    all_lane = "dst/" + "+".join(jg.types)
    with trace_span("simple_hgn/fp", stage="FP", lane=all_lane, layer="input"):
        parts = []
        for t in jg.types:
            fp = params["fp"][t]
            x = data.features[t] @ fp["w"] + fp["b"]
            pad = -(-jg.counts[t] // jg.block) * jg.block - jg.counts[t]
            parts += [x, x.new_zeros((pad, x.shape[1]))] if pad else [x]
        h = torch.cat(parts)
    *hidden, last = params["layers"]
    priors, coef = [], ()
    for layer, lp in enumerate(hidden):
        heads, dh = lp["a_src"].shape
        with trace_span("simple_hgn/fp", stage="FP", lane=all_lane, layer=layer):
            g = (h @ lp["w"]).reshape(n, heads, dh)
            th_s = torch.einsum("nhd,hd->nh", g, lp["a_src"])
            th_d = torch.einsum("nhd,hd->nh", g, lp["a_dst"])
            bias = _edge_bias(lp)
        with trace_span("simple_hgn/na", stage="NA", lane=all_lane, layer=layer):
            prior = None if not priors else JointPriors(
                *(torch.stack(x) for x in zip(*priors)), coef)
            z, lse = neighbor_aggregate_joint(jg, th_s, th_d, g, bias, priors=prior, beta=beta,
                                              backend=backend, leaky_slope=leaky_slope)
            z = z.reshape(n, heads * dh)
            h = F.elu(z + h) if layer else F.elu(z)
        # alpha^layer = (1 - beta) p^layer + beta alpha^(layer-1), as coefficients of the p^k
        coef = (1.0,) if layer == 0 else tuple(beta * c for c in coef) + (1.0 - beta,)
        priors.append((th_s.detach(), th_d.detach(), bias.detach(), lse))
    n_cls = last["res"].shape[1]
    d_pad = -(-n_cls // 4) * 4
    tgt = data.target_type
    lane = f"dst/{tgt}"
    with trace_span("simple_hgn/fp", stage="FP", lane=lane, layer=len(hidden)):
        g = (h @ F.pad(last["w"], (0, d_pad - n_cls))).reshape(n, 1, d_pad)
        th_s = g[:, 0, :n_cls] @ last["a_src"][0]
        th_d = g[:, 0, :n_cls] @ last["a_dst"][0]
        bias = _edge_bias(last)
    with trace_span("simple_hgn/na", stage="NA", lane=lane, layer=len(hidden)):
        z, _ = neighbor_aggregate_joint(jg, th_s[:, None], th_d[:, None], g, bias,
                                        n_units=jg.units_of(tgt), backend=backend,
                                        leaky_slope=leaky_slope)
    with trace_span("simple_hgn/classifier"):
        nt = jg.counts[tgt]
        logits = z[:nt, 0, :n_cls] + h[:nt] @ last["res"]
        return logits / torch.linalg.vector_norm(logits, dim=-1, keepdim=True).clamp(min=1e-12)


SIMPLE_HGN = HGNNModel(name="Simple-HGN", init=init_simple_hgn, forward=simple_hgn_forward)
