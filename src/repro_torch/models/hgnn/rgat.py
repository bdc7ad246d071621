"""R-GAT — relational GAT (Wang et al., ACL'20), the counterpart of
``repro.models.hgnn.rgat``.

Table 2 semantics: relation-specific FP h^r = W^r x, GAT attention NA per
relation graph, SF h_v = mean over relations of z^P_v.  Source and
destination endpoints are projected with relation-specific weights (they
may have different raw dims at layer 0), and the GAT logits use the
decomposed theta_src/theta_dst form.

Backends: SEGMENT and BLOCK (plain PyTorch, plain autograd), KERNEL
(inference only: per relation and layer two launches of kernel #6, the
src and the dst side's FP+θ, and one of kernel #5 for NA) and MULTIGRAPH
(kernels #1/#2 at G = 1 per relation; the trainer's path).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ...core.fusion import NABackend, neighbor_aggregate, project_coefficients
from ...tree import tree_map
from .common import HGNNData, HGNNModel, glorot


def init_rgat(
    gen: torch.Generator,
    data: HGNNData,
    *,
    hidden: int = 64,
    heads: int = 4,
    layers: int = 3,
) -> dict:
    """R-GAT parameters (the reference's tree: ``layers[l]["rel"]["g<i>"]``
    and ``layers[l]["self"][type]``), drawn from ``gen`` in a fixed order
    and placed on the data's device."""
    dims = data.feature_dims
    layer_params = []
    for layer in range(layers):
        rel = {}
        for i, g in enumerate(data.graphs):
            d_src = dims[g.src_type] if layer == 0 else heads * hidden
            d_dst = dims[g.dst_type] if layer == 0 else heads * hidden
            rel[f"g{i}"] = {
                "w_src": glorot(gen, (d_src, heads * hidden)),
                "w_dst": glorot(gen, (d_dst, heads * hidden)),
                "a_src": glorot(gen, (heads, hidden)),
                "a_dst": glorot(gen, (heads, hidden)),
            }
        self_w = {}
        for t, d in dims.items():
            d_t = d if layer == 0 else heads * hidden
            self_w[t] = glorot(gen, (d_t, heads * hidden))
        layer_params.append({"rel": rel, "self": self_w})
    params = {
        "layers": layer_params,
        "w_out": glorot(gen, (heads * hidden, data.num_classes)),
        "b_out": torch.zeros(data.num_classes),
    }
    dev = data.features[data.target_type].device
    return tree_map(lambda t: t.to(dev), params)


def rgat_forward(params, data: HGNNData, *, backend: NABackend = NABackend.SEGMENT):
    h = dict(data.features)
    for lp in params["layers"]:
        agg: dict[str, list[torch.Tensor]] = {}
        for i, batch in enumerate(data.graphs):
            rp = lp["rel"][f"g{i}"]
            # FP (relation-specific) fused with coefficient computation
            hs, th_s, _ = project_coefficients(h[batch.src_type], rp["w_src"], rp["a_src"],
                                               rp["a_dst"], backend=backend)
            _, _, th_d = project_coefficients(h[batch.dst_type], rp["w_dst"], rp["a_src"],
                                              rp["a_dst"], backend=backend)
            z = neighbor_aggregate(batch, th_s, th_d, hs, backend=backend)
            agg.setdefault(batch.dst_type, []).append(z.reshape(batch.num_dst, -1))
        h_new = {}
        for t in h:
            if t in agg:
                s = torch.stack(agg[t]).mean(dim=0)  # SF: mean over relations
            else:
                s = h[t] @ lp["self"][t]
            h_new[t] = F.elu(s)
        h = h_new
    return h[data.target_type] @ params["w_out"] + params["b_out"]


RGAT = HGNNModel(name="R-GAT", init=init_rgat, forward=rgat_forward)
