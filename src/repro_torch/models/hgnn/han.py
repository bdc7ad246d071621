"""HAN — Heterogeneous graph Attention Network (Wang et al., WWW'19), the
counterpart of ``repro.models.hgnn.han``.

Table 2 semantics: type-specific FP, GAT neighbor attention per metapath
semantic graph, semantic attention fusion (LSF+GSF split per Alg. 2).
Metapath endpoints are all the target type, so FP projects the target
features exactly once and every semantic graph gathers from it.

Backends: SEGMENT and BLOCK (per-graph plain PyTorch, plain autograd),
KERNEL (one launch of kernel #5 per graph; no gradient), MULTIGRAPH (all
graphs' NA in one launch of kernel #1 forward and #2 backward) and
FUSED_FP (FP inside the launch: kernels #3 and #4).  With one lane,
``repro``'s ``han_forward_multilane`` is the same single multigraph launch
over the units in graph-major order, which is what MULTIGRAPH runs here.
:func:`han_forward_staged` is the staged baseline (Fig. 4(a)): each stage
on its own with a device barrier after it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ...core import stages
from ...core.fusion import (
    FusedFPInputs,
    NABackend,
    neighbor_aggregate,
    neighbor_aggregate_multi,
)
from .common import HGNNData, HGNNModel, glorot


def init_han(
    gen: torch.Generator,
    data: HGNNData,
    *,
    hidden: int = 64,
    heads: int = 8,
    att_dim: int = 128,
) -> dict:
    """HAN parameters (the reference's names and shapes), drawn from
    ``gen`` in a fixed order and placed on the data's device."""
    d_in = data.feature_dims[data.target_type]
    n_graphs = len(data.graphs)
    dev = data.features[data.target_type].device
    w_fp = glorot(gen, (d_in, heads * hidden))
    w_g = glorot(gen, (heads * hidden, att_dim))
    q = glorot(gen, (att_dim, 1))[:, 0]
    w_out = glorot(gen, (heads * hidden, data.num_classes))
    a_src, a_dst = [], []
    for _ in range(n_graphs):
        a_src.append(glorot(gen, (heads, hidden)))
        a_dst.append(glorot(gen, (heads, hidden)))
    params = {
        "w_fp": w_fp,
        "b_fp": torch.zeros(heads * hidden),
        "a_src": torch.stack(a_src),
        "a_dst": torch.stack(a_dst),
        "w_g": w_g,
        "b_g": torch.zeros(att_dim),
        "q": q,
        "w_out": w_out,
        "b_out": torch.zeros(data.num_classes),
    }
    return {k: v.to(dev) for k, v in params.items()}


def _fuse(z_all: torch.Tensor, params, n: int):
    """ELU, LSF per graph, then GSF: (fused [N, H·Dh], beta [G])."""
    valid_dst = torch.ones((n,), dtype=torch.bool, device=z_all.device)
    z_list, w_list = [], []
    for i in range(z_all.shape[0]):
        z = F.elu(z_all[i].reshape(n, -1))
        w_list.append(stages.local_semantic_fusion(
            z, params["w_g"], params["b_g"], params["q"], valid_dst))
        z_list.append(z)
    return stages.global_semantic_fusion(torch.stack(w_list), torch.stack(z_list))


def _han_embed(params, data: HGNNData, backend: NABackend):
    """FP -> per-graph (theta, NA, LSF) -> GSF."""
    x = data.features[data.target_type]
    heads = params["a_src"].shape[1]
    n = x.shape[0]

    if backend is NABackend.FUSED_FP:
        # FP happens inside the NA call: raw x goes to the fused kernels,
        # which project each (table, row tile) the units read once; the
        # unit tables and the kernels' topology index are built once per
        # data set, not per step
        fp = FusedFPInputs.shared(
            x, params["w_fp"], params["b_fp"], params["a_src"], params["a_dst"],
            index=data.shared_table_index())
        z_all = neighbor_aggregate_multi(data.graphs, None, None, None, backend=backend,
                                         unit_tables=data.unit_tables(), fp=fp)
        return _fuse(z_all, params, n)

    h = stages.feature_projection(x, params["w_fp"], params["b_fp"])
    hh = h.reshape(n, heads, -1)
    if backend is NABackend.MULTIGRAPH:
        # all relations' theta in one einsum, all relations' NA in ONE launch; the
        # unit tables and the backward's edge index are built once per data set
        th_s = torch.einsum("nhd,ghd->gnh", hh, params["a_src"])
        th_d = torch.einsum("nhd,ghd->gnh", hh, params["a_dst"])
        z_all = neighbor_aggregate_multi(data.graphs, th_s, th_d, hh, backend=backend,
                                         unit_tables=data.unit_tables(),
                                         index=data.multigraph_index())
        return _fuse(z_all, params, n)

    z_all = []
    for i, batch in enumerate(data.graphs):
        th_s, th_d = stages.attention_coefficients(hh, params["a_src"][i], params["a_dst"][i])
        z_all.append(neighbor_aggregate(batch, th_s, th_d, hh, backend=backend))
    return _fuse(torch.stack(z_all), params, n)


def han_forward(params, data: HGNNData, *, backend: NABackend = NABackend.SEGMENT):
    fused, _ = _han_embed(params, data, backend)
    return fused @ params["w_out"] + params["b_out"]


# --- staged execution (Fig. 4(a) baseline): one stage at a time ---


def _barrier(t: torch.Tensor) -> torch.Tensor:
    """The host waits for the device after a stage (a no-op on the CPU)."""
    if t.is_cuda:
        torch.cuda.synchronize(t.device)
    return t


def han_forward_staged(params, data: HGNNData):
    """Traditional staged execution: each stage on its own with a host
    barrier after it, mirroring DGL-on-GPU; NA on SEGMENT."""
    x = data.features[data.target_type]
    heads = params["a_src"].shape[1]
    n = x.shape[0]
    h = _barrier(stages.feature_projection(x, params["w_fp"], params["b_fp"]))
    hh = h.reshape(n, heads, -1)
    z_list = []
    for i, batch in enumerate(data.graphs):
        th_s, th_d = stages.attention_coefficients(hh, params["a_src"][i], params["a_dst"][i])
        _barrier(th_s)
        z = stages.segment_softmax_aggregate(*batch.edges, th_s, th_d, hh, batch.num_dst)
        z_list.append(_barrier(F.elu(z.reshape(batch.num_dst, -1))))
    valid = torch.ones((n,), dtype=torch.bool, device=x.device)
    w_list = [stages.local_semantic_fusion(z, params["w_g"], params["b_g"], params["q"], valid)
              for z in z_list]
    fused, _ = stages.global_semantic_fusion(torch.stack(w_list), torch.stack(z_list))
    return _barrier(fused @ params["w_out"] + params["b_out"])


HAN = HGNNModel(name="HAN", init=init_han, forward=han_forward)
