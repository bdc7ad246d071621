"""Multi-graph fused NA forward — the paper's multi-lane execution (§4.2):
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
"""
from __future__ import annotations

import ctypes

import torch

from . import build

NEG_INF = -1e30
SUPPORTED_BLOCKS = (8, 16, 32)  # the kernel is instantiated for these B
SMEM_OPTIN = 232_448            # bytes of shared memory a block may opt into (sm_90)
_PLAIN_CHUNK_BYTES = 64 << 20   # working set of one chunk of units in the plain version
_NAME = "seg_gat_agg_multigraph"


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
    per_unit = W * B * (H * Dh + 4 * B * H) * 4
    chunk = max(1, _PLAIN_CHUNK_BYTES // max(per_unit, 1))
    lanes = torch.arange(B, device=dev)
    h_select = h_select.long()
    for u0 in range(0, U, chunk):
        u1 = min(U, u0 + chunk)
        n = u1 - u0
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
        logits = torch.where(pre >= 0, pre, leaky_slope * pre)
        logits = torch.where(live, logits, NEG_INF)                    # [n, B, W·B, H]
        m = logits.amax(dim=2)
        p = torch.where(live, torch.exp(logits - m[:, :, None, :]), 0.0)
        l = p.sum(dim=2)
        agg = torch.einsum("nbsh,nshf->nbhf", p, hs)
        out[u0 * B:u1 * B] = (agg / l.clamp(min=1e-9)[..., None]).reshape(n * B, H, Dh)
        lse[u0 * B:u1 * B] = (m + torch.log(l.clamp(min=1e-30))).reshape(n * B, H)
    return out, lse


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


def smem_bytes(B: int, H: int, Dh: int) -> int:
    """Dynamic shared memory of one block (mirrors the .cu layout)."""
    return 4 * (B * H * Dh + H * B * B + 5 * B * H) + B * B


def _kernel_fn():
    lib = build.load(_NAME)
    fn = lib.seg_gat_agg_multigraph_fwd
    fn.argtypes = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def launch(col_index, graph_id, dst_row, masks, theta_src, theta_dst, h_src,
           edge_bias, out, lse, leaky_slope: float) -> None:
    """Launch the CUDA kernel on checked operands into ``out``/``lse``, on
    the current stream.  Counts one launch."""
    U, W = col_index.shape
    B = masks.shape[-1]
    ns_pad, H = theta_src.shape[1:]
    nd_pad = theta_dst.shape[1]
    Dh = h_src.shape[-1]
    lib, fn = _kernel_fn()
    with torch.cuda.device(h_src.device):
        err = fn(
            build.ptr(col_index), build.ptr(graph_id), build.ptr(dst_row), build.ptr(masks),
            build.ptr(theta_src), build.ptr(theta_dst), build.ptr(h_src), build.ptr(edge_bias),
            build.ptr(out), build.ptr(lse),
            U, W, B, ns_pad, nd_pad, H, Dh, leaky_slope, build.stream_of(h_src),
        )
    build.check_error(lib, _NAME, err)
    seg_gat_agg_multigraph_fwd.launches += 1


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
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-unit aggregates ``out [U·B, H, Dh]`` (the caller scatters by
    (graph_id, dst_row) — disjoint by construction) and ``lse [U·B, H]``.

    CUDA operands launch the kernel; CPU operands take the plain version.
    float32 only."""
    dev = h_src.device
    build.check_tensor("col_index", col_index, torch.int32, (None, None), dev)
    U, W = col_index.shape
    build.check_tensor("masks", masks, torch.bool, (U, W, None, None), dev)
    B = masks.shape[-1]
    build.check_tensor("masks", masks, torch.bool, (U, W, B, B), dev)
    build.check_tensor("graph_id", graph_id, torch.int32, (U,), dev)
    build.check_tensor("dst_row", dst_row, torch.int32, (U,), dev)
    build.check_tensor("theta_src", theta_src, torch.float32, (None, None, None), dev)
    G, ns_pad, H = theta_src.shape
    build.check_tensor("theta_dst", theta_dst, torch.float32, (G, None, H), dev)
    build.check_tensor("h_src", h_src, torch.float32, (ns_pad, H, None), dev)
    Dh = h_src.shape[-1]
    if edge_bias is None:
        edge_bias = torch.zeros((G, H), dtype=torch.float32, device=dev)
    build.check_tensor("edge_bias", edge_bias, torch.float32, (G, H), dev)
    nd_pad = theta_dst.shape[1]
    if ns_pad % B or nd_pad % B:
        raise ValueError(f"Ns_pad={ns_pad} and Nd_pad={nd_pad} must be multiples of B={B}")
    build.check_range("col_index", col_index, -1, ns_pad // B)
    build.check_range("graph_id", graph_id, 0, G)
    build.check_range("dst_row", dst_row, 0, nd_pad // B)

    if dev.type == "cpu":
        return seg_gat_agg_multigraph_plain(
            col_index, graph_id, dst_row, masks, theta_src, theta_dst, h_src,
            edge_bias, leaky_slope=leaky_slope,
        )
    if dev.type != "cuda":
        raise ValueError(f"{_NAME}: unsupported device {dev}")
    if B not in SUPPORTED_BLOCKS:
        raise ValueError(f"{_NAME}: block size B={B} not in {SUPPORTED_BLOCKS}")
    if smem_bytes(B, H, Dh) > SMEM_OPTIN:
        raise ValueError(
            f"{_NAME}: B={B}, H={H}, Dh={Dh} needs {smem_bytes(B, H, Dh)} B of shared "
            f"memory per block, more than the {SMEM_OPTIN} B a block can have"
        )
    out = torch.empty((U * B, H, Dh), dtype=torch.float32, device=dev)
    lse = torch.empty((U * B, H), dtype=torch.float32, device=dev)
    launch(col_index, graph_id, dst_row, masks, theta_src, theta_dst, h_src,
           edge_bias, out, lse, float(leaky_slope))
    return out, lse


seg_gat_agg_multigraph_fwd.launches = 0
