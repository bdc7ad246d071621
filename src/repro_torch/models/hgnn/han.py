"""HAN — Heterogeneous graph Attention Network (Wang et al., WWW'19), the
counterpart of ``repro.models.hgnn.han``.

Table 2 semantics: type-specific FP, GAT neighbor attention per metapath
semantic graph, semantic attention fusion (LSF+GSF split per Alg. 2).
Metapath endpoints are all the target type, so FP projects the target
features exactly once and every semantic graph gathers from it.

Backends: SEGMENT and BLOCK (per-graph plain PyTorch, plain autograd),
KERNEL (one launch of kernel #5 per graph; no gradient), MULTIGRAPH (all
graphs' NA in one launch of kernel #1 forward and #2 backward) and
FUSED_FP (FP inside the launch: kernels #3 and #4).
:func:`han_forward_multilane` runs the same layer over a multi-lane plan
(``core.multilane``): all units in lane-major order in one launch, or the
plan's lanes split over a ``torch.distributed`` lane group; the trainer
takes it.  MULTIGRAPH and FUSED_FP are that path over the data set's
one-lane plan (``HGNNData.plan``).  :func:`han_forward_staged` is the
staged baseline (Fig. 4(a)): each stage on its own with a device barrier
after it.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ...core import stages
from ...core.fusion import FusedFPInputs, NABackend, _pad_rows, neighbor_aggregate
from ...core.multilane import (
    MultiLanePlan,
    multilane_na,
    multilane_na_sharded,
    resolve_multilane_backend,
)
from ...dist.sharding import gather_leaf
from ...obs.trace import trace_span
from ...runtime import barrier
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
    if backend in (NABackend.MULTIGRAPH, NABackend.FUSED_FP):
        # all relations' NA in ONE launch (#1, and #2 backward; FUSED_FP: #3
        # and #4, FP inside the call) over the data set's one-lane plan, whose
        # unit tables and kernel indexes are built once, not per step
        return _han_embed_multilane(
            params, data, data.plan(),
            backend="kernel" if backend is NABackend.MULTIGRAPH else "fused_fp")

    x = data.features[data.target_type]
    heads = params["a_src"].shape[1]
    n = x.shape[0]
    h = stages.feature_projection(x, params["w_fp"], params["b_fp"])
    hh = h.reshape(n, heads, -1)
    z_all = []
    for i, batch in enumerate(data.graphs):
        th_s, th_d = stages.attention_coefficients(hh, params["a_src"][i], params["a_dst"][i])
        z_all.append(neighbor_aggregate(batch, th_s, th_d, hh, backend=backend))
    return _fuse(torch.stack(z_all), params, n)


def han_forward(params, data: HGNNData, *, backend: NABackend = NABackend.SEGMENT):
    fused, _ = _han_embed(params, data, backend)
    return fused @ params["w_out"] + params["b_out"]


def _han_embed_multilane(
    params,
    data: HGNNData,
    plan: MultiLanePlan,
    *,
    mesh=None,
    placements=None,
    backend: str = "reference",
):
    """The consolidated HAN layer over a lane-partitioned work-unit plan.

    One θ einsum for all relations and all NA units in one call, run
    through ``core.multilane``: one launch over all lanes' units on one
    device (``mesh=None``), or the plan's lanes split over the mesh's lane
    group.  ``backend="kernel"`` is kernel #1 forward and #2 backward;
    ``"fused_fp"`` projects inside the call (#3/#4) from the raw features.

    The model axis (DESIGN.md §5's lanes posture): with ``placements``
    (``dist.param_shardings`` of ``train.hgnn.hgnn_param_axes``) the params
    are this rank's pieces.  A model rank holds contiguous columns of
    ``w_fp``/``b_fp`` (whole heads: the model axis must divide H), projects
    its columns of h (FP's flops split over the model axis) and an
    all-gather over the model group rebuilds h; the ``heads``/``mlp``
    leaves (``a_src``, ``a_dst``, ``w_g``, ``w_out``) are gathered before
    use, and everything after FP (θ, NA over the lane group, ELU, LSF, GSF)
    runs replicated over the model group.  Each gather's backward takes
    the rank's slice of the (replicated) cotangent
    (``dist.sharding.gather_leaf``).  On ``fused_fp`` the kernel projects
    inside the call from the whole ``w``, so ``w_fp`` is gathered and FP is
    not split.

    Equivalence contract (the reference's): the forward is bit-identical
    across lane counts and backends on the card, since each unit is
    computed alone and lanes only move exact zeros through the placement
    and the all-reduce.  The backward's cross-unit sums (d_h_src, d_theta_src
    over all units that read a src vertex) run in the plan's unit order,
    so gradients agree to float32 tolerance across plans and are
    bit-deterministic for a fixed plan.  Under a model axis the ranks of a
    model group compute bitwise-equal logits, loss and replicated leaves
    (all read the same gathered operands), two runs at one mesh are
    bitwise equal, and against one process logits, loss and the gathered
    gradients agree within 1e-5 of each leaf's largest magnitude in
    float32 (TF32 off): the column-sliced GEMM and the gradient norm's
    order of summation may move bits.  A gradient that nearly cancels
    (b_g's: the semantic softmax's cotangent sums to zero over the graphs)
    moves further when the GEMM's bits move, by about its own float32
    error against float64.

    Spans (DESIGN.md §12): ``han/fp``, ``han/theta`` (off ``fused_fp``,
    which projects inside the NA call), the NA call's ``na/multilane`` and
    ``han/fusion`` (ELU, LSF, GSF); :func:`han_forward_multilane` adds
    ``han/classifier``.
    """
    x = data.features[data.target_type]
    n = x.shape[0]
    n_pad = plan.n_dst_blocks * plan.block  # shared src/dst vertex space
    backend = resolve_multilane_backend(backend)
    kw = {} if mesh is None else dict(mesh=mesh)
    na = multilane_na if mesh is None else multilane_na_sharded
    split_fp = placements is not None and backend != "fused_fp"
    if placements is not None:
        if mesh is None:
            raise ValueError("placements without a mesh")
        local = ("w_fp", "b_fp", "w_out") if split_fp else ("w_out",)  # w_out: the caller's
        params = {k: v if k in local else gather_leaf(v, placements[k], mesh)
                  for k, v in params.items()}
    heads = params["a_src"].shape[1]

    if backend == "fused_fp":
        fp = FusedFPInputs.shared(_pad_rows(x, n_pad), params["w_fp"], params["b_fp"],
                                  params["a_src"], params["a_dst"])
        z_all = na(plan, None, None, None, backend=backend, fp=fp, **kw)
    else:
        with trace_span("han/fp", stage="FP"):
            h = stages.feature_projection(x, params["w_fp"], params["b_fp"])
            if split_fp:  # this rank's columns of h, gathered as w_fp's columns are placed
                h = gather_leaf(h, placements["w_fp"], mesh)
            hh = h.reshape(n, heads, -1)
        with trace_span("han/theta", stage="theta"):
            th_s = torch.einsum("nhd,ghd->gnh", hh, params["a_src"])
            th_d = torch.einsum("nhd,ghd->gnh", hh, params["a_dst"])
            th_s = _pad_rows(th_s.transpose(0, 1), n_pad).transpose(0, 1).contiguous()
            th_d = _pad_rows(th_d.transpose(0, 1), n_pad).transpose(0, 1).contiguous()
            hs = _pad_rows(hh, n_pad).contiguous()
        z_all = na(plan, th_s, th_d, hs, backend=backend, **kw)
    with trace_span("han/fusion", stage="FA"):
        return _fuse(z_all[:, :n], params, n)


def han_forward_multilane(
    params,
    data: HGNNData,
    plan: MultiLanePlan,
    *,
    mesh=None,
    placements=None,
    backend: str = "reference",
):
    """HAN logits with NA dispatched through a multi-lane plan, over a
    (lane, model) mesh with ``placements`` (see ``_han_embed_multilane``)."""
    fused, _ = _han_embed_multilane(params, data, plan, mesh=mesh, placements=placements,
                                    backend=backend)
    with trace_span("han/classifier"):
        w_out = params["w_out"] if placements is None else gather_leaf(
            params["w_out"], placements["w_out"], mesh)
        return fused @ w_out + params["b_out"]


# --- staged execution (Fig. 4(a) baseline): one stage at a time ---


def _fp_stage(w, b, x):
    return stages.feature_projection(x, w, b)


def _coeff_stage(h, a_src, a_dst):
    return stages.attention_coefficients(h, a_src, a_dst)


def _na_stage(src, dst, valid, th_s, th_d, h, num_dst):
    z = stages.segment_softmax_aggregate(src, dst, valid, th_s, th_d, h, num_dst)
    return F.elu(z.reshape(num_dst, -1))


def _sf_stage(z_stack, w_g, b_g, q, w_out, b_out):
    n = z_stack.shape[1]
    valid = torch.ones((n,), dtype=torch.bool, device=z_stack.device)
    w_list = [stages.local_semantic_fusion(z_stack[p], w_g, b_g, q, valid)
              for p in range(z_stack.shape[0])]
    fused, _ = stages.global_semantic_fusion(torch.stack(w_list), z_stack)
    return fused @ w_out + b_out


def han_forward_staged(params, data: HGNNData):
    """Traditional staged execution: each stage on its own with a host
    barrier after it, mirroring DGL-on-GPU; NA on SEGMENT."""
    x = data.features[data.target_type]
    heads = params["a_src"].shape[1]
    h = barrier(_fp_stage(params["w_fp"], params["b_fp"], x))
    hh = h.reshape(x.shape[0], heads, -1)
    z_list = []
    for i, batch in enumerate(data.graphs):
        th_s, th_d = _coeff_stage(hh, params["a_src"][i], params["a_dst"][i])
        barrier(th_s)
        z_list.append(barrier(_na_stage(*batch.edges, th_s, th_d, hh, batch.num_dst)))
    return barrier(_sf_stage(torch.stack(z_list), params["w_g"], params["b_g"], params["q"],
                              params["w_out"], params["b_out"]))


HAN = HGNNModel(name="HAN", init=init_han, forward=han_forward)
