"""Plain PyTorch Simple-HGN (Lv et al., "Are We Really Making Much
Progress? Revisiting, Benchmarking, and Refining Heterogeneous Graph
Neural Networks", KDD'21, arXiv:2112.14936) over edge lists, in float32
(or the control's TF32), for the benchmark's comparison.  Imports
nothing of the port.

The model is HGB's myGAT (github.com/THUDM/HGB,
NC/benchmark/methods/baseline: GNN.py, conv.py).  Every vertex in one
table (the types in the configuration's order, the target first), every
relation, its reverse and one self-loop a vertex, with 2R + 1 edge types
(relation i: i, its reverse: R + i, every self-loop: 2R).

    h0_v = x_v M_type(v) + b_type(v)                    (input, 128 -> 64)
    layer l:  g = h W^l                                 [N, H, D], one W^l for all types
              theta_src = <g, a_src>, theta_dst = <g, a_dst>         a head
              bias^l[psi] = <W_r^l e^l_psi, a_edge>                  a head
              e_ij = LeakyReLU_0.05(theta_dst_i + theta_src_j + bias^l[psi(i, j)])
              p^l_ij = softmax over every in-edge j of i, of every type, self-loop included
              alpha^1 = p^1,  alpha^l = (1 - beta) p^l + beta alpha^(l-1), alpha^(l-1) detached
              z_i = sum_j alpha^l_ij g_j
    hidden layers (8 heads of 64): h^l = ELU(concat_h z + res), res none in
              layer 1, the identity in layer 2
    output layer (1 head of C = 349): z + h W_res, no activation, no
              residual attention (myGAT passes res_attn=None to it)
    logits = that / max(|that|_2, 1e-12); cross-entropy on the labelled papers.

Departures from HGB, each also in the configuration's ``assumed``:
dropout 0 (HGB: feat_drop = attn_drop = 0.5); AdamW with a decoupled
decay and the benchmark's clip (HGB: Adam with an L2 term); edges of
different types between one pair of vertices are kept apart, and a
paper that cites itself keeps that edge beside its self-loop (HGB's DGL
graph merges an adjacency sum into one edge a pair, with one type, and
drops self-loops before adding its own); layer 2's residual is the
identity (512 = 8 x 64 in and out; HGB's conv.py, from an older DGL
GATConv, compares the input width with the head width and would fit a
512 x 512 map there); Glorot-uniform weights with zero biases from the
benchmark's seed (HGB: PyTorch's defaults and Xavier-normal with gain
1.414 for the input projections); no conv bias (HGB's default too).

Each layer's aggregate is summed over chunks of edges, each chunk under
``torch.utils.checkpoint`` when a gradient is wanted, so the gathered
rows of one chunk at a time are alive.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..roofline import F32, I32, gemm
from .common import adamw, adamw_state, cross_entropy, draw, einsum, leaky_relu, mm

CHUNK_EDGES = 1 << 20


def relations(cfg: dict) -> dict[str, tuple[str, str]]:
    """Every relation of the model's graph, name -> (src type, dst type):
    the configuration's, their reverses ``<name>_rev`` (those it lists),
    and a self-loop ``<type>_self`` a vertex type."""
    g = cfg["graph"]
    rels = {r: (st, dt) for r, (st, dt, _) in g["relations"].items()}
    rels.update({f"{r}_rev": (rels[r][1], rels[r][0]) for r in g["reverse"]})
    rels.update({f"{t}_self": (t, t) for t in g["vertices"]})
    return rels


def edge_types(cfg: dict) -> dict[str, int]:
    """Relation -> edge type: relation i -> i, its reverse -> R + i, every
    self-loop -> 2R (HGB's 2R + 1 types)."""
    base = list(cfg["graph"]["relations"])
    n = len(base)
    out = {}
    for r in relations(cfg):
        if r.endswith("_self") and r[: -len("_self")] in cfg["graph"]["vertices"]:
            out[r] = 2 * n
        elif r.endswith("_rev") and r[: -len("_rev")] in base:
            out[r] = n + base.index(r[: -len("_rev")])
        else:
            out[r] = base.index(r)
    return out


def vertex_order(cfg: dict) -> list[str]:
    target = cfg["graph"]["target"]
    return [target] + [t for t in cfg["graph"]["vertices"] if t != target]


def prepare(cfg: dict, inputs: dict, device) -> dict:
    """The reference's own graph: one edge list over the table of every
    vertex (the types of :func:`vertex_order` back to back, no padding),
    with each edge's type, and the edges into the target's rows apart."""
    types = vertex_order(cfg)
    counts = {t: int(inputs["vertex_counts"][t]) for t in types}
    offsets, at = {}, 0
    for t in types:
        offsets[t], at = at, at + counts[t]
    et = edge_types(cfg)
    ends = {}
    for name, (st, dt, src, dst) in inputs["relations"].items():
        ends[name] = (st, dt, torch.as_tensor(src, device=device).long(),
                      torch.as_tensor(dst, device=device).long())
    for name in cfg["graph"]["reverse"]:
        st, dt, s, d = ends[name]
        ends[f"{name}_rev"] = (dt, st, d, s)
    for t in types:
        ids = torch.arange(counts[t], device=device)
        ends[f"{t}_self"] = (t, t, ids, ids)
    src = torch.cat([s + offsets[st] for st, _, s, _ in ends.values()])
    dst = torch.cat([d + offsets[dt] for _, dt, _, d in ends.values()])
    etype = torch.cat([torch.full_like(s, et[name]) for name, (_, _, s, _) in ends.items()])
    target = cfg["graph"]["target"]
    into = torch.nonzero(dst < counts[target]).flatten()
    return {"types": types, "counts": counts, "n": at, "src": src, "dst": dst, "etype": etype,
            "target_edges": (src[into], dst[into], etype[into]),
            "x": {t: torch.as_tensor(inputs["features"][t], device=device) for t in types},
            "labels": torch.as_tensor(inputs["labels"], device=device).long(),
            "target": target, "num_types": max(et.values()) + 1}


def param_shapes(cfg: dict, inputs: dict) -> tuple[dict, tuple]:
    w, g = cfg["widths"], cfg["graph"]
    d0, hidden, heads, edim = w["input"], w["hidden"], w["heads"], w["edge_dim"]
    n_cls, n_types = int(g["num_classes"]), max(edge_types(cfg).values()) + 1
    shapes, zero = {}, []
    for t in vertex_order(cfg):
        shapes[f"fp.{t}.w"] = (int(inputs["features"][t].shape[1]), d0)
        shapes[f"fp.{t}.b"] = (d0,)
        zero.append(f"fp.{t}.b")
    d_in = d0
    for layer in range(w["layers"] + 1):
        last = layer == w["layers"]
        h, dh = (1, n_cls) if last else (heads, hidden)
        pre = f"layers.{layer}."
        shapes[pre + "w"] = (d_in, h * dh)
        shapes[pre + "a_src"] = (h, dh)
        shapes[pre + "a_dst"] = (h, dh)
        shapes[pre + "a_edge"] = (h, edim)
        shapes[pre + "edge_emb"] = (n_types, edim)
        shapes[pre + "w_r"] = (edim, h * edim)
        if last:
            shapes[pre + "res"] = (d_in, n_cls)
        d_in = heads * hidden
    return shapes, tuple(zero)


def init_params(cfg: dict, inputs: dict, gen: torch.Generator, device) -> dict:
    shapes, zero = param_shapes(cfg, inputs)
    return draw(shapes, gen, device, zero)


def _aggregate(alpha, g, src, dst, n_dst):
    out = torch.zeros((n_dst, *g.shape[1:]), device=g.device)
    return out.index_add_(0, dst, alpha[:, :, None] * g[src])


def attention(th_s, th_d, bias, src, dst, etype, n_dst: int, slope: float) -> torch.Tensor:
    """[E, H]: the softmax over each dst's in-edges, of every type."""
    e = leaky_relu(th_s[src] + th_d[dst] + bias[etype], slope)
    m = torch.full((n_dst, e.shape[1]), float("-inf"), device=e.device)
    m = m.scatter_reduce(0, dst[:, None].expand_as(e), e.detach(), "amax")
    p = torch.exp(e - m[dst])
    s = torch.zeros_like(m).index_add_(0, dst, p)
    return p / s[dst]


def aggregate(alpha, g, src, dst, n_dst: int) -> torch.Tensor:
    """[n_dst, H, D]: sum over in-edges of alpha g[src], in chunks of edges."""
    z = torch.zeros((n_dst, *g.shape[1:]), device=g.device)
    for c0 in range(0, src.numel(), CHUNK_EDGES):
        args = (alpha[c0:c0 + CHUNK_EDGES], g, src[c0:c0 + CHUNK_EDGES],
                dst[c0:c0 + CHUNK_EDGES], n_dst)
        z = z + (checkpoint(_aggregate, *args, use_reentrant=False)
                 if torch.is_grad_enabled() else _aggregate(*args))
    return z


def _layer_terms(params, layer: int, h):
    p = lambda k: params[f"layers.{layer}.{k}"]  # noqa: E731
    heads, dh = p("a_src").shape
    g = mm(h, p("w")).reshape(h.shape[0], heads, dh)
    th_s = einsum("nkd,kd->nk", g, p("a_src"))
    th_d = einsum("nkd,kd->nk", g, p("a_dst"))
    r = mm(p("edge_emb"), p("w_r")).reshape(p("edge_emb").shape[0], heads, -1)
    bias = (r * p("a_edge")).sum(dim=-1)
    return g, th_s, th_d, bias


def forward(cfg: dict, params: dict, graph: dict) -> torch.Tensor:
    w = cfg["widths"]
    beta, slope = w["beta"], w["slope"]
    n, src, dst, et = graph["n"], graph["src"], graph["dst"], graph["etype"]
    h = torch.cat([mm(graph["x"][t], params[f"fp.{t}.w"]) + params[f"fp.{t}.b"]
                   for t in graph["types"]])
    alpha = None
    for layer in range(w["layers"]):
        g, th_s, th_d, bias = _layer_terms(params, layer, h)
        p = attention(th_s, th_d, bias, src, dst, et, n, slope)
        alpha = p if alpha is None else (1 - beta) * p + beta * alpha
        z = aggregate(alpha, g, src, dst, n).reshape(n, -1)
        h = F.elu(z + h) if layer else F.elu(z)
        alpha = alpha.detach()
    nt = graph["counts"][graph["target"]]
    g, th_s, th_d, bias = _layer_terms(params, w["layers"], h)
    ts, td, tt = graph["target_edges"]
    p = attention(th_s, th_d, bias, ts, td, tt, nt, slope)
    logits = aggregate(p, g, ts, td, nt)[:, 0] + mm(h[:nt], params[f"layers.{w['layers']}.res"])
    return logits / torch.linalg.vector_norm(logits, dim=-1, keepdim=True).clamp(min=1e-12)


def train_steps(cfg: dict, params: dict, graph: dict, steps: int,
                rows: int | None = None) -> dict:
    """As ``reference.han.train_steps``."""
    opt = cfg["optimizer"]
    state = adamw_state(params)
    losses, first = [], None
    for _ in range(steps):
        leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
        loss = cross_entropy(forward(cfg, leaves, graph)[:rows], graph["labels"][:rows])
        grads = torch.autograd.grad(loss, list(leaves.values()), allow_unused=True)
        grads = {k: torch.zeros_like(p) if g is None else g
                 for (k, p), g in zip(leaves.items(), grads)}
        losses.append(float(loss.detach()))
        params, state = adamw({k: p.detach() for k, p in leaves.items()}, grads, state, opt)
        if first is None:
            first = {k: m / (1 - opt["b1"]) for k, m in state["m"].items()}
    return {"losses": losses, "grads": first, "params": params}


PRIOR_EDGE_FLOPS = 8  # a prior layer's p on an edge and head: logit 3, LeakyReLU, lse, exp, fma 2


def na_joint_forward(edges: int, n_src: int, rows: int, types: int, heads: int, dh: int,
                     priors: int) -> tuple[float, float]:
    """The joint NA's forward (the joint #1): (flops, bytes).  Per edge and
    head: the logit with its type's bias (3 adds, LeakyReLU 1), exp 1, the
    running sum 1, the weighted row 2·Dh; per prior layer its p (8) and,
    with any prior, the prior row 2·Dh; per dst row and head one divide a
    column, and with priors the mix (3 a column).  Reads theta, h_src, the
    biases, one src id and one type id an edge and one offset a dst row
    (each prior layer's theta, bias and lse); writes out and lse (and the
    softmax part with priors)."""
    flops = edges * heads * (2 * dh + 5 + priors * PRIOR_EDGE_FLOPS + (2 * dh if priors else 0)) \
        + rows * heads * dh * (4 if priors else 1)
    read = ((n_src + rows) * heads + n_src * heads * dh + types * heads) * F32 \
        + priors * ((n_src + 2 * rows) * heads + types * heads) * F32 + (2 * edges + rows) * I32
    write = rows * heads * ((2 if priors else 1) * dh + 1) * F32
    return float(flops), float(read + write)


def na_joint_backward(edges: int, n_src: int, rows: int, types: int, heads: int, dh: int,
                      priors: int) -> tuple[float, float]:
    """The joint NA's backward (the joint #2): (flops, bytes).  Per edge and
    head: the logit and p again (6), <g_out, h_src> 2·Dh, dp's softmax term
    2, LeakyReLU's slope 1, d_h_src += coefficient · g_out 2·Dh, d_theta and
    d_bias sums 3; per prior layer its p (8) and with any prior the mix of
    the coefficient (3).  Reads theta, bias, h_src, g_out, lse and delta,
    the edge ids (src and type) and row offsets, each prior layer's theta,
    bias and lse; writes d_theta_src, d_theta_dst, d_bias and d_h_src."""
    flops = edges * heads * (4 * dh + 12 + priors * PRIOR_EDGE_FLOPS + (3 if priors else 0))
    read = ((n_src + rows) * heads + types * heads + n_src * heads * dh
            + rows * heads * (dh + 2)) * F32 \
        + priors * ((n_src + 2 * rows) * heads + types * heads) * F32 + (2 * edges + rows) * I32
    write = ((n_src + rows) * heads + types * heads + n_src * heads * dh) * F32
    return float(flops), float(read + write)


def work(cfg: dict, graph: dict, mode: str) -> dict:
    """What one training step needs: each NA kernel's launches as (flops,
    bytes) and the step's flops (the forward's products, θ, the biases'
    products and NA; the backward twice the products but the raw
    features', and the NA backward).  Counted at the published widths:
    the output layer at its 349 columns, whatever the port pads."""
    if mode != "train":
        raise ValueError(f"Simple-HGN's benchmark trains; no {mode!r} cell")
    w = cfg["widths"]
    heads, hidden, edim, layers = w["heads"], w["hidden"], w["edge_dim"], w["layers"]
    n, nt, T = graph["n"], graph["counts"][graph["target"]], graph["num_types"]
    e_all, e_tgt = int(graph["src"].numel()), int(graph["target_edges"][0].numel())
    n_cls = int(cfg["graph"]["num_classes"])
    fwd = sum(gemm(graph["counts"][t], int(x.shape[1]), w["input"])
              for t, x in graph["x"].items())
    bwd = fwd  # the raw features take no gradient: the input products' weights only
    kernels: dict[str, list] = {"seg_gat_agg_multigraph": [], "seg_gat_agg_multigraph_bwd": []}
    d_in = w["input"]
    for layer in range(layers + 1):
        last = layer == layers
        h, dh = (1, n_cls) if last else (heads, hidden)
        e, rows = (e_tgt, nt) if last else (e_all, n)
        priors = 0 if last else layer
        prods = gemm(n, d_in, h * dh) + 2 * 2 * n * h * dh + gemm(T, edim, h * edim)
        if last:
            prods += gemm(nt, d_in, n_cls)
        f = na_joint_forward(e, n, rows, T, h, dh, priors)
        b = na_joint_backward(e, n, rows, T, h, dh, priors)
        kernels["seg_gat_agg_multigraph"].append(f)
        kernels["seg_gat_agg_multigraph_bwd"].append(b)
        fwd += prods + f[0]
        bwd += 2 * prods + b[0]
        d_in = heads * hidden
    return {"kernels": kernels, "flops": fwd + bwd}
