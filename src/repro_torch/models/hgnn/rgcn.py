"""R-GCN — relational GCN (Schlichtkrull et al., ESWC'18), the
counterpart of ``repro.models.hgnn.rgcn``.

Table 2 semantics: relation-specific FP h^r = W^r x, mean NA per relation
graph, SF h_v = sum_r z^r_v + W^{c_v} x_v (self loop), ReLU between layers.
Mean NA has one implementation, plain PyTorch as in the JAX package
(``core.fusion.mean_aggregate``, a segmented sum over the dst-sorted edge
list): no kernel runs on this path.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ...core.fusion import NABackend, mean_aggregate
from ...tree import tree_map
from .common import HGNNData, HGNNModel, glorot


def init_rgcn(
    gen: torch.Generator,
    data: HGNNData,
    *,
    hidden: int = 64,
    layers: int = 3,
) -> dict:
    """R-GCN parameters (the reference's tree), drawn from ``gen`` in a
    fixed order and placed on the data's device."""
    dims = data.feature_dims
    layer_params = []
    for layer in range(layers):
        rel_w, self_w = {}, {}
        for i, g in enumerate(data.graphs):
            d_src = dims[g.src_type] if layer == 0 else hidden
            rel_w[f"g{i}"] = glorot(gen, (d_src, hidden))
        for t, d in dims.items():
            d_t = d if layer == 0 else hidden
            self_w[t] = glorot(gen, (d_t, hidden))
        layer_params.append({"rel": rel_w, "self": self_w})
    params = {
        "layers": layer_params,
        "w_out": glorot(gen, (hidden, data.num_classes)),
        "b_out": torch.zeros(data.num_classes),
    }
    dev = data.features[data.target_type].device
    return tree_map(lambda t: t.to(dev), params)


def rgcn_forward(params, data: HGNNData, *, backend: NABackend = NABackend.SEGMENT):
    del backend  # mean aggregation has a single implementation
    h = dict(data.features)
    for lp in params["layers"]:
        # FP (relation-specific) + NA (mean) per relation graph
        agg: dict[str, list[torch.Tensor]] = {}
        for i, batch in enumerate(data.graphs):
            hr = h[batch.src_type] @ lp["rel"][f"g{i}"]
            agg.setdefault(batch.dst_type, []).append(mean_aggregate(batch, hr))
        # SF: sum over relations + self transform
        h_new = {}
        for t in h:
            s = h[t] @ lp["self"][t]
            for z in agg.get(t, []):
                s = s + z
            h_new[t] = F.relu(s)
        h = h_new
    return h[data.target_type] @ params["w_out"] + params["b_out"]


RGCN = HGNNModel(name="R-GCN", init=init_rgcn, forward=rgcn_forward)
