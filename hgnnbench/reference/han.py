"""Plain PyTorch HAN (Wang et al., arXiv:1903.07293) over dense metapath
adjacencies, in float32 (or the control's TF32), for the benchmark's
comparison.  Imports nothing of the port.

Layer equations, one HAN layer as the port states them:

    h = x W_fp + b_fp                          [N, H·Dh], heads of Dh
    for each metapath P, with A_P[v, u] = 1 iff a path u -> ... -> v:
        e[v, u, k] = LeakyReLU_0.2(<h_v,k, a_dst[P, k]> + <h_u,k, a_src[P, k]>)
        z_P[v, k]  = sum_u softmax_u(e[v, ., k] over A_P[v, .]) h_u,k
                     (0 where v has no in-edge)
        z_P        = ELU(z_P)
        w_P        = mean_v q^T tanh(z_P,v W_g + b_g)
    beta = softmax_P(w_P);  fused = sum_P beta_P z_P
    logits = fused W_out + b_out

Metapath adjacencies are composed here from the relation arrays by 0/1
products (boolean semantics: a pair joined by several paths is one edge,
as the port's composition deduplicates).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..roofline import gemm, na_backward, na_forward
from .common import adamw, adamw_state, cross_entropy, draw, einsum, leaky_relu, mm

NEG = -1e30  # a masked logit: exp underflows to 0 beside any live one


def _relation_matrix(inputs: dict, st: str, dt: str, device) -> torch.Tensor:
    """Dense 0/1 [N_st, N_dt] of the first relation st -> dt, else of
    the first dt -> st transposed."""
    counts = inputs["vertex_counts"]
    for want_rev in (False, True):
        for s_type, d_type, src, dst in inputs["relations"].values():
            if (s_type, d_type) == ((dt, st) if want_rev else (st, dt)):
                m = torch.zeros((counts[s_type], counts[d_type]), device=device)
                m[torch.as_tensor(src, device=device).long(),
                  torch.as_tensor(dst, device=device).long()] = 1.0
                return m.t() if want_rev else m
    raise KeyError(f"no relation {st} -> {dt}")


def compose(inputs: dict, metapath, device) -> torch.Tensor:
    """Bool [N_dst, N_src]: entry [v, u] is set iff a path of ``metapath``
    leads from u to v."""
    m = _relation_matrix(inputs, metapath[0], metapath[1], device)
    for a, b in zip(metapath[1:-1], metapath[2:]):
        m = ((m @ _relation_matrix(inputs, a, b, device)) > 0).float()
    return m.t() > 0


def prepare(cfg: dict, inputs: dict, device) -> dict:
    """The reference's own graph: one adjacency a metapath, in the
    configuration's order, with their edge counts."""
    adjs = [compose(inputs, tuple(mp), device) for mp in cfg["graph"]["metapaths"]]
    target = cfg["graph"]["target"]
    return {"adjs": adjs, "edges": [int(a.sum()) for a in adjs],
            "x": torch.as_tensor(inputs["features"][target], device=device),
            "labels": torch.as_tensor(inputs["labels"], device=device).long()}


def param_shapes(cfg: dict, inputs: dict) -> tuple[dict, tuple]:
    w = cfg["widths"]
    heads, hidden, att = w["heads"], w["hidden"], w["att_dim"]
    d_in = int(inputs["features"][cfg["graph"]["target"]].shape[1])
    c = heads * hidden
    shapes = {"w_fp": (d_in, c), "b_fp": (c,)}
    for g in range(len(cfg["graph"]["metapaths"])):
        shapes[f"a_src.{g}"] = (heads, hidden)
        shapes[f"a_dst.{g}"] = (heads, hidden)
    shapes.update({"w_g": (c, att), "b_g": (att,), "q": (att, 1),
                   "w_out": (c, int(cfg["graph"]["num_classes"])),
                   "b_out": (int(cfg["graph"]["num_classes"]),)})
    return shapes, ("b_fp", "b_g", "b_out")


def init_params(cfg: dict, inputs: dict, gen: torch.Generator, device) -> dict:
    """The weights of a run, drawn from ``gen`` on ``device``: a flat dict
    of leaves, metapath-indexed leaves in the configuration's order."""
    shapes, zero = param_shapes(cfg, inputs)
    return draw(shapes, gen, device, zero)


def _na(hh, adj, a_src, a_dst):
    th_s = einsum("nkd,kd->nk", hh, a_src)
    th_d = einsum("nkd,kd->nk", hh, a_dst)
    e = leaky_relu(th_d[:, None, :] + th_s[None, :, :])        # [v, u, k]
    e = torch.where(adj[:, :, None], e, torch.full_like(e, NEG))
    alpha = torch.softmax(e, dim=1)
    alpha = torch.where(adj.any(dim=1)[:, None, None], alpha, torch.zeros_like(alpha))
    return einsum("vuk,ukd->vkd", alpha, hh)


def forward(cfg: dict, params: dict, graph: dict) -> torch.Tensor:
    x = graph["x"]
    n = x.shape[0]
    heads = cfg["widths"]["heads"]
    hh = (mm(x, params["w_fp"]) + params["b_fp"]).reshape(n, heads, -1)
    zs, ws = [], []
    for g, adj in enumerate(graph["adjs"]):
        z = F.elu(_na(hh, adj, params[f"a_src.{g}"], params[f"a_dst.{g}"]).reshape(n, -1))
        s = mm(torch.tanh(mm(z, params["w_g"]) + params["b_g"]), params["q"])[:, 0]
        ws.append(s.mean())
        zs.append(z)
    beta = torch.softmax(torch.stack(ws), dim=0)
    fused = sum(b * z for b, z in zip(beta, zs))
    return mm(fused, params["w_out"]) + params["b_out"]


def train_steps(cfg: dict, params: dict, graph: dict, steps: int,
                rows: int | None = None) -> dict:
    """``steps`` full-batch AdamW steps from ``params``: each step's loss,
    the first step's gradient after the clip (as AdamW takes it) and the
    params after the last step.  ``rows``: the loss over the first rows
    only (a fault the comparison has to catch)."""
    opt = cfg["optimizer"]
    state = adamw_state(params)
    losses, first = [], None
    for _ in range(steps):
        leaves = {k: p.detach().requires_grad_() for k, p in params.items()}
        loss = cross_entropy(forward(cfg, leaves, graph)[:rows], graph["labels"][:rows])
        grads = dict(zip(leaves, torch.autograd.grad(loss, list(leaves.values()))))
        losses.append(float(loss.detach()))
        params, state = adamw({k: p.detach() for k, p in leaves.items()}, grads, state, opt)
        if first is None:
            first = {k: m / (1 - opt["b1"]) for k, m in state["m"].items()}
    return {"losses": losses, "grads": first, "params": params}


def work(cfg: dict, graph: dict, mode: str) -> dict | None:
    """What one training step needs: each kernel's launches as (flops,
    bytes), and the step's flops (forward, and the backward of what the
    loss reaches: no gradient of the raw features)."""
    if mode != "train":
        return None
    w = cfg["widths"]
    h, dh, att = w["heads"], w["hidden"], w["att_dim"]
    n, k = (int(s) for s in graph["x"].shape)
    c, g, e = h * dh, len(graph["edges"]), sum(graph["edges"])
    classes = int(cfg["graph"]["num_classes"])
    fwd = na_forward(e, n, n, g, h, dh, lse=True)
    bwd = na_backward(e, n, n, g, h, dh)
    dense = (2 * gemm(n, k, c)                                   # FP, dW only
             + 3 * (2 * g * 2 * n * c)                           # theta
             + 3 * g * (gemm(n, c, att) + gemm(n, att, 1))       # LSF
             + 3 * (2 * g * n * c)                               # GSF
             + 3 * gemm(n, c, classes))                          # classifier
    return {"kernels": {"seg_gat_agg_multigraph": [fwd], "seg_gat_agg_multigraph_bwd": [bwd]},
            "flops": dense + fwd[0] + bwd[0]}
