"""Plain PyTorch R-GAT (Busbridge et al., arXiv:1904.05811) over edge
lists, in float32 (or the control's TF32), for the benchmark's comparison.
Imports nothing of the port.

Layer equations as the port states them (layer l, relation r: src type s
-> dst type t, heads of Dh):

    hs = h_s W_src^r,  hd = h_t W_dst^r                    [N, H, Dh]
    e[edge u -> v, k] = LeakyReLU_0.2(<hs_u,k, a_src^r_k> + <hd_v,k, a_dst^r_k>)
    z^r_v = sum over in-edges u of softmax_u(e[., v, k]) hs_u,k   (0 with none)
    h'_t = ELU(mean over the relations r into t of z^r)   (ELU(h_t W_self_t)
           for a type no relation enters)
    logits = h_target W_out + b_out

Each relation's aggregate is summed over chunks of edges, each chunk
under ``torch.utils.checkpoint`` when a gradient is wanted, so the
gathered rows of one chunk at a time are alive; the reference then fits
beside nothing else on the card.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..roofline import fp_coeff, gemm, na_backward, na_forward
from .common import adamw, adamw_state, cross_entropy, draw, einsum, leaky_relu, mm

CHUNK_EDGES = 1 << 20


def relations(cfg: dict) -> list[str]:
    """Relation names in the configuration's order, each reverse named
    ``<name>_rev`` after the forward ones."""
    g = cfg["graph"]
    return list(g["relations"]) + [f"{r}_rev" for r in g["reverse"]]


def prepare(cfg: dict, inputs: dict, device) -> dict:
    """The reference's own graph: every relation's edges on ``device``,
    reverses made here by swapping the ends."""
    rels = {}
    for name, (st, dt, src, dst) in inputs["relations"].items():
        rels[name] = (st, dt, torch.as_tensor(src, device=device).long(),
                      torch.as_tensor(dst, device=device).long())
    for name in cfg["graph"]["reverse"]:
        st, dt, s, d = rels[name]
        rels[f"{name}_rev"] = (dt, st, d, s)
    target = cfg["graph"]["target"]
    return {"rels": rels, "edges": {k: int(v[2].numel()) for k, v in rels.items()},
            "x": {t: torch.as_tensor(x, device=device) for t, x in inputs["features"].items()},
            "labels": torch.as_tensor(inputs["labels"], device=device).long(),
            "target": target}


def param_shapes(cfg: dict, inputs: dict) -> tuple[dict, tuple]:
    w, g = cfg["widths"], cfg["graph"]
    heads, hidden, layers = w["heads"], w["hidden"], w["layers"]
    c = heads * hidden
    dims = {t: int(x.shape[1]) for t, x in inputs["features"].items()}
    types = {r: (g["relations"][r][0], g["relations"][r][1]) for r in g["relations"]}
    types.update({f"{r}_rev": (types[r][1], types[r][0]) for r in g["reverse"]})
    shapes = {}
    for layer in range(layers):
        for r in relations(cfg):
            st, dt = types[r]
            shapes[f"layers.{layer}.rel.{r}.w_src"] = (dims[st] if layer == 0 else c, c)
            shapes[f"layers.{layer}.rel.{r}.w_dst"] = (dims[dt] if layer == 0 else c, c)
            shapes[f"layers.{layer}.rel.{r}.a_src"] = (heads, hidden)
            shapes[f"layers.{layer}.rel.{r}.a_dst"] = (heads, hidden)
        for t, d in dims.items():
            shapes[f"layers.{layer}.self.{t}"] = (d if layer == 0 else c, c)
    shapes["w_out"] = (c, int(g["num_classes"]))
    shapes["b_out"] = (int(g["num_classes"]),)
    return shapes, ("b_out",)


def init_params(cfg: dict, inputs: dict, gen: torch.Generator, device) -> dict:
    shapes, zero = param_shapes(cfg, inputs)
    return draw(shapes, gen, device, zero)


def _aggregate(alpha, hs, src, dst, n_dst):
    out = torch.zeros((n_dst, *hs.shape[1:]), device=hs.device)
    return out.index_add_(0, dst, alpha[:, :, None] * hs[src])


def edge_attention(th_s, th_d, hs, src, dst, n_dst: int) -> torch.Tensor:
    """[n_dst, H, Dh]: the softmax over each dst's in-edges of its
    logits, weighting the src rows of ``hs``."""
    e = leaky_relu(th_s[src] + th_d[dst])                               # [E, H]
    m = torch.full((n_dst, e.shape[1]), float("-inf"), device=e.device)
    m = m.scatter_reduce(0, dst[:, None].expand_as(e), e.detach(), "amax")
    p = torch.exp(e - m[dst])
    s = torch.zeros_like(m).index_add_(0, dst, p)
    alpha = p / s[dst]
    z = None
    for c0 in range(0, src.numel(), CHUNK_EDGES):
        args = (alpha[c0:c0 + CHUNK_EDGES], hs, src[c0:c0 + CHUNK_EDGES],
                dst[c0:c0 + CHUNK_EDGES], n_dst)
        part = (checkpoint(_aggregate, *args, use_reentrant=False)
                if torch.is_grad_enabled() else _aggregate(*args))
        z = part if z is None else z + part
    if z is None:
        z = torch.zeros((n_dst, *hs.shape[1:]), device=hs.device)
    return z


def forward(cfg: dict, params: dict, graph: dict) -> torch.Tensor:
    heads = cfg["widths"]["heads"]
    h = dict(graph["x"])
    for layer in range(cfg["widths"]["layers"]):
        agg: dict[str, list] = {}
        for r, (st, dt, src, dst) in graph["rels"].items():
            p = lambda k: params[f"layers.{layer}.rel.{r}.{k}"]  # noqa: E731
            hs = mm(h[st], p("w_src")).reshape(h[st].shape[0], heads, -1)
            hd = mm(h[dt], p("w_dst")).reshape(h[dt].shape[0], heads, -1)
            th_s = einsum("nkd,kd->nk", hs, p("a_src"))
            th_d = einsum("nkd,kd->nk", hd, p("a_dst"))
            z = edge_attention(th_s, th_d, hs, src, dst, h[dt].shape[0])
            agg.setdefault(dt, []).append(z.reshape(h[dt].shape[0], -1))
        h = {t: F.elu(torch.stack(agg[t]).mean(dim=0) if t in agg
                      else mm(x, params[f"layers.{layer}.self.{t}"]))
             for t, x in h.items()}
    return mm(h[graph["target"]], params["w_out"]) + params["b_out"]


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


def work(cfg: dict, graph: dict, mode: str) -> dict:
    """What one training step or one forward needs: each kernel's
    launches as (flops, bytes) and the step's flops.  The forward computes
    every relation of every layer; a training step's backward covers the
    relations whose output the loss reaches (from the target's relations
    in the last layer down), with no gradient of the raw features."""
    w = cfg["widths"]
    h, dh, layers = w["heads"], w["hidden"], w["layers"]
    c = h * dh
    n = {t: int(x.shape[0]) for t, x in graph["x"].items()}
    k0 = {t: int(x.shape[1]) for t, x in graph["x"].items()}
    rels = {r: (st, dt, graph["edges"][r]) for r, (st, dt, _, _) in graph["rels"].items()}
    live = {graph["target"]}
    live_at = []
    for _ in range(layers):  # from the last layer down
        on = [r for r, (st, dt, _) in rels.items() if dt in live]
        live_at.insert(0, on)
        live = {t for r in on for t in rels[r][:2]}
    kernels: dict[str, list] = {}
    flops = 3 * gemm(n[graph["target"]], c, int(cfg["graph"]["num_classes"]))
    for layer in range(layers):
        for r, (st, dt, e) in rels.items():
            kin = {t: (k0[t] if layer == 0 else c) for t in (st, dt)}
            grad = r in live_at[layer]
            fp = [gemm(n[t], kin[t], c) for t in (st, dt)]
            theta = 2 * (2 * n[st] * c + 2 * n[dt] * c) if mode == "infer" else \
                2 * n[st] * c + 2 * n[dt] * c
            if mode == "infer":
                kernels.setdefault("fused_fp_coeff", []).extend(
                    fp_coeff(n[t], kin[t], h, dh) for t in (st, dt))
                kernels.setdefault("seg_gat_agg", []).append(
                    na_forward(e, n[st], n[dt], 1, h, dh, lse=False))
                flops += sum(fp) + theta + kernels["seg_gat_agg"][-1][0]
                continue
            fwd = na_forward(e, n[st], n[dt], 1, h, dh, lse=True)
            kernels.setdefault("seg_gat_agg_multigraph", []).append(fwd)
            flops += sum(fp) + theta + fwd[0]
            if grad:
                bwd = na_backward(e, n[st], n[dt], 1, h, dh)
                kernels.setdefault("seg_gat_agg_multigraph_bwd", []).append(bwd)
                flops += sum(fp) * (1 if layer == 0 else 2) + 2 * theta + bwd[0]
    return {"kernels": kernels, "flops": flops}
