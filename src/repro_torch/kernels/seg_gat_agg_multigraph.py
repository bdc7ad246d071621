"""Multi-graph fused NA, forward and backward — the paper's multi-lane execution (§4.2):
one launch processes work units from *different* semantic graphs.

Work unit u is a (graph ``graph_id[u]``, dst-block row ``dst_row[u]``)
pair.  It sweeps its W src blocks ``col_index[u, w]`` (-1 = padding):

    logit[i, j, h] = LeakyReLU(theta_dst[g, row·B+i, h] + theta_src[g, col·B+j, h]
                               + edge_bias[g, h]),   masked by masks[u, w, i, j]

and emits the softmax-weighted sum of ``h_src[col·B+j]`` per dst row and
head, ``out [U·B, H, Dh]``, plus ``lse = m + log l`` ``[U·B, H]``.  A row
with no live edge gives exact zeros.

:func:`seg_gat_agg_multigraph_fwd` is the wrapper: CUDA tensors launch
the hand-written kernel ``csrc/seg_gat_agg_multigraph.cu``; CPU tensors
take :func:`seg_gat_agg_multigraph_plain`, the plain PyTorch version of
the same function (and the oracle the kernel is held against).

Both kernels visit the set mask entries of live slots (the edges) only.
The forward needs no index.  The backward (:func:`seg_gat_agg_multigraph_bwd`)
recomputes p from lse: CUDA tensors launch ``csrc/seg_gat_agg_multigraph_bwd.cu``
(a dst-major pass over the edges, then a src-major one, in fixed orders
over the topology's edge index, ``topology.Topology.edge_index``); CPU
tensors take :func:`seg_gat_agg_multigraph_bwd_plain`.
:func:`seg_gat_agg_multigraph` is the differentiable entry point: a
``torch.autograd.Function`` whose forward launches the forward kernel and
keeps ``out`` and ``lse``, and whose backward launches the backward
kernel.  Every entry takes ``topology=``, the checked unit tables
(``topology.Topology``), which a caller that runs many steps on one
topology builds once; None builds one in the call.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .topology import EDGE_BLOCKS, Topology, resolve

NEG_INF = -1e30
SUPPORTED_BLOCKS = (8, 16, 32)  # B that kernels #3 and #4 are instantiated for (64, 128: re-blocked)
SMEM_OPTIN = 232_448            # bytes of shared memory a block may opt into (sm_90)
MAX_HEADS = 32                  # #1, #2 and #5: lane h of a warp holds head h
_PLAIN_CHUNK_BYTES = 64 << 20   # working set of one chunk of units in the plain version
_NAME = "seg_gat_agg_multigraph"
_BWD_NAME = "seg_gat_agg_multigraph_bwd"


def _gather_unit_chunk(col_index, graph_id, dst_row, masks, theta_src, theta_dst,
                       h_tables, h_select, edge_bias, leaky_slope, u0, u1):
    """The operands of units [u0, u1) gathered over all their W·B src
    slots: (g, r, src, pre, logits, live, hs)."""
    W = col_index.shape[1]
    B = masks.shape[-1]
    n = u1 - u0
    lanes = torch.arange(B, device=h_tables.device)
    cols = col_index[u0:u1].long()
    g = graph_id[u0:u1].long()
    r = dst_row[u0:u1].long()
    src = (cols.clamp(min=0)[:, :, None] * B + lanes).reshape(n, W * B)
    td = theta_dst[g[:, None], r[:, None] * B + lanes]            # [n, B, H]
    ts = theta_src[g[:, None], src]                                # [n, W·B, H]
    hs = h_tables[h_select[g][:, None], src]                       # [n, W·B, H, Dh]
    live = masks[u0:u1].permute(0, 2, 1, 3).reshape(n, B, W * B)
    live = (live & (cols >= 0).repeat_interleave(B, dim=1)[:, None, :])[..., None]
    pre = td[:, :, None, :] + ts[:, None, :, :] + edge_bias[g][:, None, None, :]
    logits = torch.where(pre >= 0, pre, leaky_slope * pre)         # [n, B, W·B, H]
    return g, r, src, pre, logits, live, hs


def _chunk_units(U: int, per_unit_bytes: int) -> range:
    return range(0, U, max(1, _PLAIN_CHUNK_BYTES // max(per_unit_bytes, 1)))


def unit_softmax_aggregate(
    col_index: torch.Tensor,   # int32 [U, W]
    graph_id: torch.Tensor,    # int32 [U]
    dst_row: torch.Tensor,     # int32 [U]
    masks: torch.Tensor,       # bool  [U, W, B, B]
    theta_src: torch.Tensor,   # f32   [G, Ns_pad, H]
    theta_dst: torch.Tensor,   # f32   [G, Nd_pad, H]
    h_tables: torch.Tensor,    # f32   [T, Ns_pad, H, Dh]
    h_select: torch.Tensor,    # int   [G]  graph -> row of h_tables
    edge_bias: torch.Tensor,   # f32   [G, H]
    leaky_slope: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Exact softmax per work unit over all its W·B src slots, in chunks
    of units so that no more than ``_PLAIN_CHUNK_BYTES`` of gathered
    operands live at once.  Returns (out [U·B, H, Dh], lse [U·B, H])."""
    U, W = col_index.shape
    B = masks.shape[-1]
    H, Dh = h_tables.shape[-2:]
    dev = h_tables.device
    out = torch.empty((U * B, H, Dh), dtype=torch.float32, device=dev)
    lse = torch.empty((U * B, H), dtype=torch.float32, device=dev)
    h_select = h_select.long()
    chunks = _chunk_units(U, W * B * (H * Dh + 4 * B * H) * 4)
    for u0 in chunks:
        u1 = min(U, u0 + chunks.step)
        n = u1 - u0
        _, _, _, _, logits, live, hs = _gather_unit_chunk(
            col_index, graph_id, dst_row, masks, theta_src, theta_dst, h_tables, h_select,
            edge_bias, leaky_slope, u0, u1)
        logits = torch.where(live, logits, NEG_INF)
        m = logits.amax(dim=2)
        p = torch.where(live, torch.exp(logits - m[:, :, None, :]), 0.0)
        l = p.sum(dim=2)
        agg = torch.einsum("nbsh,nshf->nbhf", p, hs)
        out[u0 * B:u1 * B] = (agg / l.clamp(min=1e-9)[..., None]).reshape(n * B, H, Dh)
        lse[u0 * B:u1 * B] = (m + torch.log(l.clamp(min=1e-30))).reshape(n * B, H)
    return out, lse


def unit_softmax_aggregate_vjp(
    col_index, graph_id, dst_row, masks, theta_src, theta_dst, h_tables, h_select,
    edge_bias, leaky_slope: float, lse, delta, g_out,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The VJP of :func:`unit_softmax_aggregate`, recomputing p from
    ``lse`` chunk by chunk (no autograd activations are kept):
    ``p = exp(logit - lse)``, ``dp = g_out·h``, ``dpre = LeakyReLU'·p·(dp -
    delta)`` with ``delta = Σ g_out·out``.  Returns (d_theta_src,
    d_theta_dst, d_h_tables, d_edge_bias)."""
    U, W = col_index.shape
    B = masks.shape[-1]
    T, ns_pad, H, Dh = h_tables.shape
    dev = h_tables.device
    f32 = dict(dtype=torch.float32, device=dev)
    d_ths = torch.zeros(theta_src.shape, **f32)
    d_thd = torch.zeros(theta_dst.shape, **f32)
    d_h = torch.zeros(h_tables.shape, **f32)
    lanes = torch.arange(B, device=dev)
    h_select = h_select.long()
    chunks = _chunk_units(U, W * B * (2 * H * Dh + 8 * B * H) * 4)
    for u0 in chunks:
        u1 = min(U, u0 + chunks.step)
        n = u1 - u0
        g, r, src, pre, logits, live, hs = _gather_unit_chunk(
            col_index, graph_id, dst_row, masks, theta_src, theta_dst, h_tables, h_select,
            edge_bias, leaky_slope, u0, u1)
        ls = lse[u0 * B:u1 * B].reshape(n, B, 1, H)
        go = g_out[u0 * B:u1 * B].reshape(n, B, H, Dh)
        p = torch.where(live, torch.exp(logits - ls), 0.0)            # [n, B, W·B, H]
        dp = torch.einsum("nbhf,nshf->nbsh", go, hs)
        dlogit = p * (dp - delta[u0 * B:u1 * B].reshape(n, B, 1, H))
        dpre = torch.where(pre >= 0, dlogit, leaky_slope * dlogit)
        d_ths.index_put_((g[:, None].expand(n, W * B), src), dpre.sum(dim=1), accumulate=True)
        d_thd.index_put_((g[:, None].expand(n, B), r[:, None] * B + lanes), dpre.sum(dim=2),
                         accumulate=True)
        rows = (h_select[g][:, None] * ns_pad + src).reshape(-1)
        d_h.view(T * ns_pad, H, Dh).index_add_(
            0, rows, torch.einsum("nbsh,nbhf->nshf", p, go).reshape(-1, H, Dh))
    # the bias enters every logit of its graph: its gradient is the graph's dpre mass
    return d_ths, d_thd, d_h, d_thd.sum(dim=1)


def seg_gat_agg_multigraph_plain(
    col_index, graph_id, dst_row, masks, theta_src, theta_dst, h_src, edge_bias,
    *, leaky_slope: float = 0.2,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the kernel: (out [U·B, H, Dh], lse [U·B, H])."""
    G = theta_src.shape[0]
    return unit_softmax_aggregate(
        col_index, graph_id, dst_row, masks, theta_src, theta_dst,
        h_src[None], torch.zeros(G, dtype=torch.long, device=h_src.device),
        edge_bias, leaky_slope,
    )


def seg_gat_agg_multigraph_bwd_plain(
    col_index, graph_id, dst_row, masks, theta_src, theta_dst, h_src, edge_bias,
    out, lse, g_out, *, leaky_slope: float = 0.2,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the backward (the whole VJP of the JAX
    ``_multigraph_bwd``, scatters included): (d_theta_src, d_theta_dst,
    d_h_src, d_edge_bias)."""
    G = theta_src.shape[0]
    delta = (g_out * out).sum(dim=-1)
    d_ths, d_thd, d_h, d_bias = unit_softmax_aggregate_vjp(
        col_index, graph_id, dst_row, masks, theta_src, theta_dst, h_src[None],
        torch.zeros(G, dtype=torch.long, device=h_src.device), edge_bias, leaky_slope,
        lse, delta, g_out,
    )
    return d_ths, d_thd, d_h[0], d_bias


def check_smem(name: str, B: int, H: int, Dh: int, nbytes: int) -> None:
    """The block-size and shared-memory check of kernels #3 and #4, whose
    blocks hold whole B × B tiles."""
    if B not in SUPPORTED_BLOCKS:
        raise ValueError(f"{name}: block size B={B} not in {SUPPORTED_BLOCKS}")
    if nbytes > SMEM_OPTIN:
        raise ValueError(
            f"{name}: B={B}, H={H}, Dh={Dh} needs {nbytes} B of shared "
            f"memory per block, more than the {SMEM_OPTIN} B a block can have"
        )


def lane_groups(H: int, Dh: int) -> tuple[int, int | None]:
    """(V, NK): the instantiation of #1's, #2's and #5's kernels a row of
    H·Dh floats takes (csrc/edge_na.cuh): V floats a lane group (4 when
    Dh % 4 == 0, else 1) and NK in {1, 2, 4, 8}, the fewest groups a lane
    that cover the row; NK is None where more than 8 would be needed."""
    V = 4 if Dh % 4 == 0 else 1
    groups = -(-H * Dh // (32 * V))
    return V, next((nk for nk in (1, 2, 4, 8) if groups <= nk), None)


def check_edge_shape(name: str, B: int, H: int, Dh: int) -> None:
    """What #1, #2 and #5 take (csrc/edge_na.cuh): a warp holds one row of H·Dh
    floats in its lanes' registers, at most 8 groups a lane
    (:func:`lane_groups`), and lane h holds head h."""
    if B not in EDGE_BLOCKS:
        raise ValueError(f"{name}: block size B={B} not in {EDGE_BLOCKS}")
    if not 1 <= H <= MAX_HEADS:
        raise ValueError(f"{name}: H={H} heads, the kernel takes 1 to {MAX_HEADS}")
    V, nk = lane_groups(H, Dh)
    if nk is None:
        raise ValueError(f"{name}: H·Dh={H * Dh} is more than the {32 * 8 * V} floats a warp's "
                         f"registers hold at Dh={Dh}")


# -- the CUDA kernels -------------------------------------------------------------


def _kernel_fn():
    lib = build.load(_NAME)
    fn = lib.seg_gat_agg_multigraph_fwd
    fn.argtypes = [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def _bwd_kernel_fn():
    lib = build.load(_BWD_NAME)
    fn = lib.seg_gat_agg_multigraph_bwd
    fn.argtypes = [ctypes.c_void_p] * 19 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def launch(col_index, graph_id, dst_row, masks, theta_src, theta_dst, h_src,
           edge_bias, out, lse, leaky_slope: float, visits: torch.Tensor | None = None) -> None:
    """Launch the CUDA kernel on checked operands into ``out``/``lse``, on
    the current stream.  ``visits`` (int32 [1] on the card, or None) gains
    the set mask entries the kernel visited.  Counts one launch."""
    U, W = col_index.shape
    B = masks.shape[-1]
    ns_pad, H = theta_src.shape[1:]
    nd_pad = theta_dst.shape[1]
    Dh = h_src.shape[-1]
    masks, h_src = build.aligned(masks), build.aligned(h_src)
    lib, fn = _kernel_fn()
    with torch.cuda.device(h_src.device):
        err = fn(
            build.ptr(col_index), build.ptr(graph_id), build.ptr(dst_row), build.ptr(masks),
            build.ptr(theta_src), build.ptr(theta_dst), build.ptr(h_src), build.ptr(edge_bias),
            build.ptr(out), build.ptr(lse), None if visits is None else build.ptr(visits),
            U, W, B, ns_pad, nd_pad, H, Dh, leaky_slope, build.stream_of(h_src),
        )
    build.check_error(lib, _NAME, err)
    seg_gat_agg_multigraph_fwd.launches += 1


def launch_bwd(col_index, graph_id, dst_row, masks, theta_src, theta_dst, h_src, edge_bias,
               g_out, lse, delta, index: dict, leaky_slope: float):
    """Launch the backward kernel (passes A and B) on checked operands and
    the edge index of their topology (``Topology.edge_index``), on the
    current stream.  Returns (d_theta_src, d_theta_dst, d_h_src).  Counts
    one launch."""
    B = masks.shape[-1]
    G, ns_pad, H = theta_src.shape
    nd_pad = theta_dst.shape[1]
    Dh = h_src.shape[-1]
    dev = h_src.device
    f32 = dict(dtype=torch.float32, device=dev)
    h_src, g_out = build.aligned(h_src), build.aligned(g_out)
    p_e = torch.empty((index["E"], H), **f32)
    dpre_e = torch.empty((index["E"], H), **f32)
    d_h_src = torch.empty((ns_pad, H, Dh), **f32)
    d_theta_src = torch.empty((G, ns_pad, H), **f32)
    d_theta_dst = torch.empty((G, nd_pad, H), **f32)
    lib, fn = _bwd_kernel_fn()
    p = build.ptr
    with torch.cuda.device(dev):
        err = fn(
            *(p(t) for t in index["gdst"]),
            *(p(index[k]) for k in ("row_off", "e_src", "src_off", "src_edge", "src_row")),
            p(theta_src), p(theta_dst), p(h_src), p(edge_bias), p(g_out), p(lse), p(delta),
            p(p_e), p(dpre_e), p(d_h_src), p(d_theta_src), p(d_theta_dst),
            G, B, ns_pad, nd_pad, H, Dh, leaky_slope, build.stream_of(h_src),
        )
    build.check_error(lib, _BWD_NAME, err)
    seg_gat_agg_multigraph_bwd.launches += 1
    return d_theta_src, d_theta_dst, d_h_src


def _check_operands(topology, col_index, graph_id, dst_row, masks, theta_src, theta_dst, h_src,
                    edge_bias):
    """Check the operands' dtypes, shapes and devices for either direction,
    and hold ``topology`` to the unit tables (or build one from them, which
    checks their values: ``topology.resolve``).  Returns (topology,
    ``edge_bias``, zeros when None)."""
    dev = h_src.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{_NAME}: unsupported device {dev}")
    build.check_tensor("theta_src", theta_src, torch.float32, (None, None, None), dev)
    G, ns_pad, H = theta_src.shape
    build.check_tensor("theta_dst", theta_dst, torch.float32, (G, None, H), dev)
    build.check_tensor("h_src", h_src, torch.float32, (ns_pad, H, None), dev)
    if edge_bias is None:
        edge_bias = torch.zeros((G, H), dtype=torch.float32, device=dev)
    build.check_tensor("edge_bias", edge_bias, torch.float32, (G, H), dev)
    topology = resolve(topology, col_index, graph_id, dst_row, masks, n_graphs=G, ns_pad=ns_pad,
                       nd_pad=theta_dst.shape[1])
    if topology.device != dev:
        raise ValueError(f"{_NAME}: the topology is on {topology.device}, h_src on {dev}")
    return topology, edge_bias


def seg_gat_agg_multigraph_fwd(
    col_index: torch.Tensor,   # int32 [U, W]  src block columns (-1 pad, unique per row)
    graph_id: torch.Tensor,    # int32 [U]
    dst_row: torch.Tensor,     # int32 [U]     dst block row within the graph
    masks: torch.Tensor,       # bool  [U, W, B, B]
    theta_src: torch.Tensor,   # f32   [G, Ns_pad, H]
    theta_dst: torch.Tensor,   # f32   [G, Nd_pad, H]
    h_src: torch.Tensor,       # f32   [Ns_pad, H, Dh] (shared across graphs)
    edge_bias: torch.Tensor | None = None,  # f32 [G, H]
    *,
    leaky_slope: float = 0.2,
    topology: Topology | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-unit aggregates ``out [U·B, H, Dh]`` (the caller scatters by
    (graph_id, dst_row) — disjoint by construction) and ``lse [U·B, H]``.

    CUDA operands launch the kernel; CPU operands take the plain version.
    float32 only.  ``topology``: the ``Topology`` of the unit tables, held
    to them (None: built in the call, a host read)."""
    _, edge_bias = _check_operands(topology, col_index, graph_id, dst_row, masks, theta_src,
                                   theta_dst, h_src, edge_bias)
    if h_src.device.type == "cpu":
        return seg_gat_agg_multigraph_plain(
            col_index, graph_id, dst_row, masks, theta_src, theta_dst, h_src,
            edge_bias, leaky_slope=leaky_slope,
        )
    U, B, (H, Dh) = col_index.shape[0], masks.shape[-1], h_src.shape[1:]
    check_edge_shape(_NAME, B, H, Dh)
    out = torch.empty((U * B, H, Dh), dtype=torch.float32, device=h_src.device)
    lse = torch.empty((U * B, H), dtype=torch.float32, device=h_src.device)
    launch(col_index, graph_id, dst_row, masks, theta_src, theta_dst, h_src,
           edge_bias, out, lse, float(leaky_slope))
    return out, lse


def seg_gat_agg_multigraph_bwd(
    col_index, graph_id, dst_row, masks, theta_src, theta_dst, h_src, edge_bias,
    out: torch.Tensor,    # f32 [U·B, H, Dh]  the forward's output
    lse: torch.Tensor,    # f32 [U·B, H]      the forward's residual
    g_out: torch.Tensor,  # f32 [U·B, H, Dh]  cotangent of out
    *,
    leaky_slope: float = 0.2,
    topology: Topology | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The VJP of :func:`seg_gat_agg_multigraph_fwd`: (d_theta_src,
    d_theta_dst, d_h_src, d_edge_bias), bitwise repeatable on the card.

    CUDA operands launch the backward kernel over the topology's edge index
    (built on its first backward); CPU operands take the plain version.
    float32 only.  ``topology`` as in the forward."""
    dev = h_src.device
    topology, edge_bias = _check_operands(topology, col_index, graph_id, dst_row, masks,
                                          theta_src, theta_dst, h_src, edge_bias)
    U, B, H, Dh = col_index.shape[0], masks.shape[-1], theta_src.shape[2], h_src.shape[-1]
    build.check_tensor("out", out, torch.float32, (U * B, H, Dh), dev)
    build.check_tensor("lse", lse, torch.float32, (U * B, H), dev)
    build.check_tensor("g_out", g_out, torch.float32, (U * B, H, Dh), dev)
    if dev.type == "cpu":
        return seg_gat_agg_multigraph_bwd_plain(
            col_index, graph_id, dst_row, masks, theta_src, theta_dst, h_src, edge_bias,
            out, lse, g_out, leaky_slope=leaky_slope,
        )
    check_edge_shape(_BWD_NAME, B, H, Dh)
    delta = (g_out * out).sum(dim=-1)
    d_ths, d_thd, d_hs = launch_bwd(col_index, graph_id, dst_row, masks, theta_src, theta_dst,
                                    h_src, edge_bias, g_out, lse, delta, topology.edge_index(),
                                    float(leaky_slope))
    return d_ths, d_thd, d_hs, d_thd.sum(dim=1)


seg_gat_agg_multigraph_fwd.launches = 0
seg_gat_agg_multigraph_bwd.launches = 0


class MultigraphNA(torch.autograd.Function):
    """Forward kernel #1 keeping ``out`` and ``lse``; backward kernel #2,
    both on the unit tables of one checked ``Topology``."""

    @staticmethod
    def forward(ctx, topology, theta_src, theta_dst, h_src, edge_bias, leaky_slope):
        out, lse = seg_gat_agg_multigraph_fwd(*topology.units, theta_src, theta_dst, h_src,
                                              edge_bias, leaky_slope=leaky_slope,
                                              topology=topology)
        ctx.save_for_backward(theta_src, theta_dst, h_src, edge_bias, out, lse)
        ctx.leaky_slope = leaky_slope
        ctx.topology = topology
        return out

    @staticmethod
    def backward(ctx, g_out):
        *operands, out, lse = ctx.saved_tensors
        grads = seg_gat_agg_multigraph_bwd(*ctx.topology.units, *operands, out, lse,
                                           g_out.contiguous(), leaky_slope=ctx.leaky_slope,
                                           topology=ctx.topology)
        return (None, *grads, None)


def seg_gat_agg_multigraph(
    col_index, graph_id, dst_row, masks, theta_src, theta_dst, h_src,
    edge_bias: torch.Tensor | None = None, *, leaky_slope: float = 0.2,
    topology: Topology | None = None,
) -> torch.Tensor:
    """Differentiable per-unit aggregates ``[U·B, H, Dh]`` (the counterpart
    of ``repro``'s ``seg_gat_agg_multigraph``): gradients flow to
    theta_src, theta_dst, h_src and edge_bias through kernel #2.
    ``topology``: the ``Topology`` of the unit tables, built once per
    topology by the caller (None: built here), which both directions read."""
    topology, edge_bias = _check_operands(topology, col_index, graph_id, dst_row, masks,
                                          theta_src, theta_dst, h_src, edge_bias)
    return MultigraphNA.apply(topology, theta_src, theta_dst, h_src, edge_bias,
                              float(leaky_slope))


# -- the joint NA: one softmax over every relation into a row ----------------------
#
# Simple-HGN's NA (Lv et al., KDD'21): the vertices of every type in one
# table, and one work unit per dst block holding the slots of every
# relation into it, ragged (unit u's slots are [unit_off[u], unit_off[u+1])),
# each slot a (relation slot_rel[s], src block slot_col[s]) with its B × B
# mask.  Per dst row i and head:
#
#     logit[i, j] = LeakyReLU(theta_dst[i] + theta_src[j] + edge_bias[rel(i, j)])
#     p = softmax over every in-edge j of i, of every relation,   lse = m + log l
#     out[i] = Σ_j p[i, j] h_src[j]                                   (no prior layers)
#     out[i] = (1 - beta) Σ_j p[i, j] h_src[j] + beta Σ_j alpha[i, j] h_src[j]
#
# with alpha = Σ_k coef[k] p^k the prior layers' attention (``JointPriors``),
# recomputed on each edge from their (theta_src, theta_dst, bias, lse) and
# detached.  CUDA tensors launch ``multigraph_fwd_kernel_joint`` (#1's
# library) and ``edge_pass_a_joint`` + ``edge_pass_b`` (#2's); CPU tensors
# take the plain versions below, over the same edge list.

_JOINT_FWD = "seg_gat_agg_multigraph_joint_fwd"
_JOINT_BWD = "seg_gat_agg_multigraph_joint_bwd"
MAX_PRIORS = 4  # csrc/edge_na.cuh: kMaxPriors


class JointPriors:
    """The prior layers of a joint NA call, detached: ``theta_src [K, ns,
    H]``, ``theta_dst [K, nd, H]``, ``bias [K, R, H]``, ``lse [K, nd, H]``
    and ``coef``, K floats: alpha = Σ_k coef[k] p^k."""

    def __init__(self, theta_src, theta_dst, bias, lse, coef):
        self.theta_src = theta_src.detach().contiguous()
        self.theta_dst = theta_dst.detach().contiguous()
        self.bias = bias.detach().contiguous()
        self.lse = lse.detach().contiguous()
        self.coef = tuple(float(c) for c in coef)

    @property
    def K(self) -> int:
        return len(self.coef)


def _leaky(pre, slope):
    return torch.where(pre >= 0, pre, slope * pre)


def _joint_logits(index, theta_src, theta_dst, edge_bias, slope):
    row, src, rel = (index[k].long() for k in ("e_row", "e_src", "e_rel"))
    pre = theta_dst[row] + theta_src[src] + edge_bias[rel]  # [E, H]
    return row, src, rel, pre, _leaky(pre, slope)


def _prior_alpha(index, priors: JointPriors, slope):
    row, src, rel = (index[k].long() for k in ("e_row", "e_src", "e_rel"))
    a = 0.0
    for k, c in enumerate(priors.coef):
        lg = _leaky(priors.theta_dst[k][row] + priors.theta_src[k][src] + priors.bias[k][rel], slope)
        a = a + c * torch.exp(lg - priors.lse[k][row])
    return a


def seg_gat_agg_multigraph_joint_plain(index, theta_src, theta_dst, h_src, edge_bias,
                                       priors: JointPriors | None = None, *, beta: float = 0.0,
                                       leaky_slope: float = 0.2):
    """Plain PyTorch version of the joint forward over the index's edge
    list: (out [U·B, H, Dh], lse [U·B, H], soft), ``soft`` the softmax
    part (``out`` itself without prior layers)."""
    rows = index["U"] * index["B"]
    H, Dh = h_src.shape[1:]
    row, src, _, _, lg = _joint_logits(index, theta_src, theta_dst, edge_bias, leaky_slope)
    f32 = dict(dtype=torch.float32, device=h_src.device)
    m = torch.full((rows, H), NEG_INF, **f32).scatter_reduce(
        0, row[:, None].expand_as(lg), lg, "amax")
    p = torch.exp(lg - m[row])
    l = torch.zeros((rows, H), **f32).index_add_(0, row, p)
    hs = h_src[src]
    soft = torch.zeros((rows, H, Dh), **f32).index_add_(0, row, p[..., None] * hs)
    soft = soft / l.clamp(min=1e-9)[..., None]
    lse = m + torch.log(l.clamp(min=1e-30))
    if priors is None or priors.K == 0:
        return soft, lse, soft
    a = _prior_alpha(index, priors, leaky_slope)
    pa = torch.zeros((rows, H, Dh), **f32).index_add_(0, row, a[..., None] * hs)
    return (1 - beta) * soft + beta * pa, lse, soft


def seg_gat_agg_multigraph_joint_bwd_plain(index, theta_src, theta_dst, h_src, edge_bias,
                                           soft, lse, g_out, priors: JointPriors | None = None,
                                           *, beta: float = 0.0, leaky_slope: float = 0.2):
    """Plain PyTorch version of the joint backward: (d_theta_src,
    d_theta_dst, d_h_src, d_edge_bias), the prior attention detached."""
    gs = 1.0 - beta if priors is not None and priors.K else 1.0
    row, src, rel, pre, lg = _joint_logits(index, theta_src, theta_dst, edge_bias, leaky_slope)
    p = torch.exp(lg - lse[row])
    delta = gs * (g_out * soft).sum(dim=-1)
    dp = gs * (g_out[row] * h_src[src]).sum(dim=-1)
    dlogit = p * (dp - delta[row])
    dpre = torch.where(pre >= 0, dlogit, leaky_slope * dlogit)
    coeff = p if gs == 1.0 else (1 - beta) * p + beta * _prior_alpha(index, priors, leaky_slope)
    d_h = torch.zeros_like(h_src).index_add_(0, src, coeff[..., None] * g_out[row])
    d_ths = torch.zeros_like(theta_src).index_add_(0, src, dpre)
    d_thd = torch.zeros_like(theta_dst).index_add_(0, row, dpre)
    d_bias = torch.zeros_like(edge_bias).index_add_(0, rel, dpre)
    return d_ths, d_thd, d_h, d_bias


def _prior_args(priors: JointPriors | None):
    """The prior operands as the C functions take them: four pointers, the
    host array of coefficients, K."""
    if priors is None or priors.K == 0:
        return (None,) * 5 + (0,)
    coef = (ctypes.c_float * priors.K)(*priors.coef)
    return (build.ptr(priors.theta_src), build.ptr(priors.theta_dst), build.ptr(priors.bias),
            build.ptr(priors.lse), ctypes.cast(coef, ctypes.c_void_p), priors.K)


def _check_joint(index, theta_src, theta_dst, h_src, edge_bias, priors):
    dev = h_src.device
    if index["masks"].device != dev:
        raise ValueError(f"{_JOINT_FWD}: the index is on {index['masks'].device}, h_src on {dev}")
    ns, R, rows = index["ns_pad"], index["R"], index["U"] * index["B"]
    build.check_tensor("h_src", h_src, torch.float32, (ns, None, None), dev)
    H, Dh = h_src.shape[1:]
    build.check_tensor("theta_src", theta_src, torch.float32, (ns, H), dev)
    build.check_tensor("theta_dst", theta_dst, torch.float32, (None, H), dev)
    build.check_tensor("edge_bias", edge_bias, torch.float32, (R, H), dev)
    nd = theta_dst.shape[0]
    if nd < rows:
        raise ValueError(f"{_JOINT_FWD}: theta_dst has {nd} rows, the units {rows}")
    if priors is not None and priors.K:
        K = priors.K
        if K > MAX_PRIORS:
            raise ValueError(f"{_JOINT_FWD}: {K} prior layers, at most {MAX_PRIORS}")
        build.check_tensor("priors.theta_src", priors.theta_src, torch.float32, (K, ns, H), dev)
        build.check_tensor("priors.theta_dst", priors.theta_dst, torch.float32, (K, nd, H), dev)
        build.check_tensor("priors.bias", priors.bias, torch.float32, (K, R, H), dev)
        build.check_tensor("priors.lse", priors.lse, torch.float32, (K, nd, H), dev)
    if dev.type == "cuda":
        check_edge_shape(_JOINT_FWD, index["B"], H, Dh)
    elif dev.type != "cpu":
        raise ValueError(f"{_JOINT_FWD}: unsupported device {dev}")
    return nd, H, Dh


def seg_gat_agg_multigraph_joint_fwd(index, theta_src, theta_dst, h_src, edge_bias,
                                     priors: JointPriors | None = None, *, beta: float = 0.0,
                                     leaky_slope: float = 0.2):
    """The joint forward over ``topology.joint_index``'s units: (out [U·B, H,
    Dh], lse [U·B, H], soft), ``soft`` the softmax part the backward's
    delta reads (``out`` itself without prior layers).  CUDA operands
    launch the kernel, CPU operands take the plain version.  float32."""
    nd, H, Dh = _check_joint(index, theta_src, theta_dst, h_src, edge_bias, priors)
    if h_src.device.type == "cpu":
        return seg_gat_agg_multigraph_joint_plain(index, theta_src, theta_dst, h_src, edge_bias,
                                                  priors, beta=beta, leaky_slope=leaky_slope)
    rows = index["U"] * index["B"]
    f32 = dict(dtype=torch.float32, device=h_src.device)
    out = torch.empty((rows, H, Dh), **f32)
    lse = torch.empty((rows, H), **f32)
    has_prior = priors is not None and priors.K > 0
    soft = torch.empty((rows, H, Dh), **f32) if has_prior else out
    h_src = build.aligned(h_src)
    lib = build.load(_NAME)
    fn = lib.seg_gat_agg_multigraph_joint_fwd
    fn.restype = ctypes.c_int
    p = build.ptr
    with torch.cuda.device(h_src.device):
        err = fn(
            *(p(index[k]) for k in ("unit_off", "slot_col", "slot_rel", "masks")),
            p(theta_src), p(theta_dst), p(h_src), p(edge_bias), *_prior_args(priors),
            ctypes.c_float(beta), p(out), p(lse), p(soft) if has_prior else None,
            *(ctypes.c_int(v) for v in (index["U"], index["B"], index["ns_pad"], nd, index["R"],
                                        H, Dh)),
            ctypes.c_float(leaky_slope), build.stream_of(h_src))
    build.check_error(lib, _JOINT_FWD, err)
    seg_gat_agg_multigraph_joint_fwd.launches += 1
    seg_gat_agg_multigraph_joint_fwd.prior_layers += priors.K if has_prior else 0
    return out, lse, soft


def seg_gat_agg_multigraph_joint_bwd(index, theta_src, theta_dst, h_src, edge_bias, soft, lse,
                                     g_out, priors: JointPriors | None = None, *,
                                     beta: float = 0.0, leaky_slope: float = 0.2):
    """The VJP of :func:`seg_gat_agg_multigraph_joint_fwd` in ``out``:
    (d_theta_src, d_theta_dst, d_h_src, d_edge_bias), bitwise repeatable on
    the card (no atomics; the relation sums run in a fixed order).  The
    prior layers' attention carries no gradient."""
    nd, H, Dh = _check_joint(index, theta_src, theta_dst, h_src, edge_bias, priors)
    rows, dev = index["U"] * index["B"], h_src.device
    for name, t, shape in (("soft", soft, (rows, H, Dh)), ("lse", lse, (rows, H)),
                           ("g_out", g_out, (rows, H, Dh))):
        build.check_tensor(name, t, torch.float32, shape, dev)
    if dev.type == "cpu":
        return seg_gat_agg_multigraph_joint_bwd_plain(index, theta_src, theta_dst, h_src,
                                                      edge_bias, soft, lse, g_out, priors,
                                                      beta=beta, leaky_slope=leaky_slope)
    has_prior = priors is not None and priors.K > 0
    gs = 1.0 - beta if has_prior else 1.0
    delta = (g_out * soft).sum(dim=-1)
    if has_prior:
        delta = gs * delta
    ns, R = index["ns_pad"], index["R"]
    f32 = dict(dtype=torch.float32, device=dev)
    h_src, g_out = build.aligned(h_src), build.aligned(g_out)
    p_e = torch.empty((index["E"], H), **f32)
    dpre_e = torch.empty((index["E"], H), **f32)
    d_h = torch.empty((ns, H, Dh), **f32)
    d_ths_rel = torch.empty((R, ns, H), **f32)
    d_thd = (torch.empty if nd == rows else torch.zeros)((nd, H), **f32)
    lib = build.load(_BWD_NAME)
    fn = lib.seg_gat_agg_multigraph_joint_bwd
    fn.restype = ctypes.c_int
    p = build.ptr
    with torch.cuda.device(dev):
        err = fn(
            *(p(index[k]) for k in ("row_off", "e_src", "e_rel", "src_off", "src_edge",
                                    "src_row")),
            p(theta_src), p(theta_dst), p(h_src), p(edge_bias), *_prior_args(priors),
            ctypes.c_float(beta), p(g_out), p(lse), p(delta), p(p_e), p(dpre_e), p(d_h),
            p(d_ths_rel), p(d_thd),
            *(ctypes.c_int(v) for v in (rows, ns, nd, R, H, Dh)),
            ctypes.c_float(leaky_slope), build.stream_of(h_src))
    build.check_error(lib, _JOINT_BWD, err)
    seg_gat_agg_multigraph_joint_bwd.launches += 1
    seg_gat_agg_multigraph_joint_fwd.prior_layers += priors.K if has_prior else 0
    return d_ths_rel.sum(dim=0), d_thd, d_h, d_ths_rel.sum(dim=1)


seg_gat_agg_multigraph_joint_fwd.launches = 0
seg_gat_agg_multigraph_joint_fwd.prior_layers = 0  # prior layers recomputed, forward and backward
seg_gat_agg_multigraph_joint_bwd.launches = 0


class JointNA(torch.autograd.Function):
    """The joint forward keeping the softmax part and ``lse``; the joint
    backward.  Returns (out, lse), ``lse`` without a gradient (a later
    layer's prior)."""

    @staticmethod
    def forward(ctx, theta_src, theta_dst, h_src, edge_bias, index, priors, beta, leaky_slope):
        out, lse, soft = seg_gat_agg_multigraph_joint_fwd(
            index, theta_src, theta_dst, h_src, edge_bias, priors, beta=beta,
            leaky_slope=leaky_slope)
        ctx.save_for_backward(theta_src, theta_dst, h_src, edge_bias, soft, lse)
        ctx.index, ctx.priors, ctx.beta, ctx.leaky_slope = index, priors, beta, leaky_slope
        ctx.mark_non_differentiable(lse)
        return out, lse

    @staticmethod
    def backward(ctx, g_out, _g_lse):
        theta_src, theta_dst, h_src, edge_bias, soft, lse = ctx.saved_tensors
        grads = seg_gat_agg_multigraph_joint_bwd(
            ctx.index, theta_src, theta_dst, h_src, edge_bias, soft, lse, g_out.contiguous(),
            ctx.priors, beta=ctx.beta, leaky_slope=ctx.leaky_slope)
        return (*grads, None, None, None, None)


def seg_gat_agg_multigraph_joint(index, theta_src, theta_dst, h_src, edge_bias,
                                 priors: JointPriors | None = None, *, beta: float = 0.0,
                                 leaky_slope: float = 0.2):
    """Differentiable joint NA over ``topology.joint_index``'s units: (out [U·B,
    H, Dh], lse [U·B, H]); gradients flow to theta_src, theta_dst, h_src and
    edge_bias through the joint backward (#2's library)."""
    return JointNA.apply(theta_src.contiguous(), theta_dst.contiguous(), h_src.contiguous(),
                         edge_bias.contiguous(), index, priors, float(beta), float(leaky_slope))
