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
(kernels #1/#2 at G = 1 per relation; the trainer's path).  Off KERNEL,
FP computes only what NA reads: hs and θ_src on the source side, and
θ_dst straight from the destination features
(``core.fusion.project_dst_coefficients``), with no destination table.
On every backend a forward runs only the relation passes whose output
reaches the logits (``common.live_relations``) and builds only the types
the next layer reads.  :func:`rgat_forward` also runs over a (lane,
model) mesh with this rank's pieces of the parameters, as HAN's
multi-lane layer does.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ...core.fusion import (
    NABackend,
    neighbor_aggregate,
    project_coefficients,
    project_dst_coefficients,
)
from ...dist.sharding import gather_leaf, sum_cotangent
from ...obs.trace import trace_span
from ...tree import tree_map
from .common import HGNNData, HGNNModel, glorot, live_relations


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


def _project_split(x, w, placement, a_src, a_dst, mesh):
    """:func:`project_coefficients` on this rank's columns of ``w`` (whole
    heads): the rank projects its columns of h and an all-gather over the
    model group rebuilds h, then θ runs replicated.  ``x``'s gradient is
    the sum of the ranks' parts (``sum_cotangent``)."""
    h = gather_leaf(sum_cotangent(x, mesh, "model") @ w, placement, mesh)
    h = h.reshape(x.shape[0], a_src.shape[0], -1)
    return h, torch.einsum("nhd,hd->nh", h, a_src), torch.einsum("nhd,hd->nh", h, a_dst)


def _project_src(x, w, a_src):
    """The source side's FP: ``(hs [N, H, Dh], theta_src [N, H])``, with no
    theta_dst (NA reads the destination side's alone)."""
    hs = (x @ w).reshape(x.shape[0], a_src.shape[0], -1)
    return hs, torch.einsum("nhd,hd->nh", hs, a_src)


def rgat_forward(params, data: HGNNData, *, backend: NABackend = NABackend.SEGMENT,
                 mesh=None, placements=None):
    """R-GAT logits ``[N_target, C]``.

    The model axis (DESIGN.md §5's lanes posture, as HAN's
    ``_han_embed_multilane``): with ``placements`` (``dist.param_shardings``
    of ``train.hgnn.hgnn_param_axes``) and ``mesh`` the params are this
    rank's pieces.  A model rank holds contiguous columns of each
    relation's ``w_src``/``w_dst`` (whole heads: the model axis must divide
    H) and rows of ``w_out``; it projects its columns and an all-gather
    over the model group rebuilds ``hs``.  θ (θ_dst from the gathered
    ``w_dst``, with no destination table, as in one process), NA, the
    relation mean, ELU and the ``self`` products then run replicated over
    the model group, and ``w_out`` is gathered before use.  Each gather's
    backward takes the rank's slice of the (replicated) cotangent, and the
    input of a split product sums the ranks' parts of its cotangent.  On KERNEL, #6
    projects inside its call from the whole ``w``, so the weights are
    gathered and FP is not split.  NA sees the same operands on every rank
    of a model group, so the group's logits, loss and gathered gradients
    are bitwise equal; against one process they agree within 1e-5 of each
    leaf's largest magnitude in float32 (the column-split products move
    bits).

    Liveness: a layer runs the relations into the types it must build
    (``live_relations``), and builds those types alone: the last layer
    the target, the one before the types the live relations read.  The
    schedule reads only the schema, so every rank of a mesh skips the same
    passes and their gathers.  A dead pass's parameters get no gradient
    (zeros in the train step, as under ``jax.grad``); the live passes and
    the logits keep their bits.  Counter:
    ``rgat_forward.relations_skipped``, the dead (relation, layer) passes
    of each forward.

    Spans (DESIGN.md §12): per live relation and layer, on lane
    ``sg/<relation>``, ``rgat/fp`` (both sides' FP) and
    ``rgat/na``; per layer ``rgat/mean`` (the relation mean, the ``self``
    products, ELU); last ``rgat/classifier``."""
    if placements is not None and mesh is None:
        raise ValueError("placements without a mesh")
    split_fp = placements is not None and backend is not NABackend.KERNEL

    def whole(x, placement):
        return x if placements is None else gather_leaf(x, placement, mesh)

    h = dict(data.features)
    schedule = live_relations(data.graphs, data.target_type, len(params["layers"]))
    for layer, (lp, (live, build)) in enumerate(zip(params["layers"], schedule)):
        rgat_forward.relations_skipped += len(data.graphs) - len(live)
        lpl = None if placements is None else placements["layers"][layer]
        agg: dict[str, list[torch.Tensor]] = {}
        for i in live:
            batch = data.graphs[i]
            rp = lp["rel"][f"g{i}"]
            rpl = dict.fromkeys(rp) if lpl is None else lpl["rel"][f"g{i}"]
            lane = f"sg/{batch.name}"
            # FP (relation-specific) fused with coefficient computation
            with trace_span("rgat/fp", stage="FP", lane=lane, layer=layer):
                a_src = whole(rp["a_src"], rpl["a_src"])
                a_dst = whole(rp["a_dst"], rpl["a_dst"])
                if backend is NABackend.KERNEL:
                    hs, th_s, _ = project_coefficients(h[batch.src_type],
                                                       whole(rp["w_src"], rpl["w_src"]),
                                                       a_src, a_dst, backend=backend)
                    _, _, th_d = project_coefficients(h[batch.dst_type],
                                                      whole(rp["w_dst"], rpl["w_dst"]),
                                                      a_src, a_dst, backend=backend)
                else:  # only what NA reads: hs, theta_src, theta_dst
                    if split_fp:
                        hs, th_s, _ = _project_split(h[batch.src_type], rp["w_src"],
                                                     rpl["w_src"], a_src, a_dst, mesh)
                    else:
                        hs, th_s = _project_src(h[batch.src_type], rp["w_src"], a_src)
                    th_d = project_dst_coefficients(h[batch.dst_type],
                                                    whole(rp["w_dst"], rpl["w_dst"]), a_dst)
            with trace_span("rgat/na", stage="NA", lane=lane, layer=layer):
                z = neighbor_aggregate(batch, th_s, th_d, hs, backend=backend)
                agg.setdefault(batch.dst_type, []).append(z.reshape(batch.num_dst, -1))
        with trace_span("rgat/mean", stage="FA", layer=layer):
            h_new = {}
            for t in [t for t in h if t in build]:
                if t in agg:
                    s = torch.stack(agg[t]).mean(dim=0)  # SF: mean over relations
                else:
                    s = h[t] @ whole(lp["self"][t], None if lpl is None else lpl["self"][t])
                h_new[t] = F.elu(s)
            h = h_new
    with trace_span("rgat/classifier"):
        w_out = whole(params["w_out"], None if placements is None else placements["w_out"])
        b_out = whole(params["b_out"], None if placements is None else placements["b_out"])
        return h[data.target_type] @ w_out + b_out


rgat_forward.relations_skipped = 0
RGAT = HGNNModel(name="R-GAT", init=init_rgat, forward=rgat_forward)
