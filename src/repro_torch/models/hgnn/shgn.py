"""S-HGN / Simple-HGN (Lv et al., KDD'21), the counterpart of
``repro.models.hgnn.shgn``.

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

import torch
import torch.nn.functional as F

from ...core.fusion import NABackend, neighbor_aggregate, project_coefficients
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
