"""Stage-fusion megakernel forward: FP+NA in one launch (paper Alg. 2).

The multigraph NA of ``seg_gat_agg_multigraph`` with the FP stage pulled
inside: the kernel streams **raw** feature tiles, projects them on chip
through the unit's weight table ``W[wsel[gid]]``, takes the attention
coefficients from the projected tile while it is on chip, and feeds it
straight into the online-softmax aggregation.  Projected features never
go to device memory.  The dst tile of a unit is projected once and its
theta_dst kept for the whole sweep; each live src slot's tile is
projected where it is used.

:func:`seg_gat_agg_fused_fp_fwd` is the wrapper: CUDA tensors launch the
hand-written kernel ``csrc/seg_gat_agg_fused_fp.cu``; CPU tensors take
:func:`seg_gat_agg_fused_fp_plain`, which projects every vertex once and
then aggregates (the plain version, and the oracle the kernel is held
against).
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .seg_gat_agg_multigraph import SMEM_OPTIN, SUPPORTED_BLOCKS, unit_softmax_aggregate

K_TILE = 32  # Din columns staged per step of the K-tiled projection, as in the .cu source
_NAME = "seg_gat_agg_fused_fp"


def seg_gat_agg_fused_fp_plain(
    col_index, graph_id, dst_row, wsel, masks, x, w, b, a_src, a_dst, edge_bias,
    *, leaky_slope: float = 0.2,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: project once, then aggregate.
    Returns (out [U·B, H, Dh], lse [U·B, H])."""
    G, H, Dh = a_src.shape
    T, n = w.shape[0], x.shape[0]
    h_all = (torch.einsum("nd,tdk->tnk", x, w) + b[:, None, :]).reshape(T, n, H, Dh)
    hg = h_all[wsel.long()]                          # [G, N, H, Dh]
    ths = torch.einsum("gnhd,ghd->gnh", hg, a_src)
    thd = torch.einsum("gnhd,ghd->gnh", hg, a_dst)
    return unit_softmax_aggregate(
        col_index, graph_id, dst_row, masks, ths, thd, h_all, wsel, edge_bias, leaky_slope,
    )


def smem_bytes(B: int, H: int, Dh: int) -> int:
    """Dynamic shared memory of one block (mirrors the .cu layout)."""
    return 4 * (2 * B * H * Dh + H * B * B + K_TILE * B + 5 * B * H) + B * B


def _kernel_fn():
    lib = build.load(_NAME)
    fn = lib.seg_gat_agg_fused_fp_fwd
    fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 6 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def launch(col_index, graph_id, dst_row, wsel, masks, x, w, b, a_src, a_dst,
           edge_bias, out, lse, leaky_slope: float) -> None:
    """Launch the CUDA kernel on checked operands into ``out``/``lse``, on
    the current stream.  Counts one launch."""
    U, W = col_index.shape
    B = masks.shape[-1]
    H, Dh = a_src.shape[1:]
    din = w.shape[1]
    lib, fn = _kernel_fn()
    with torch.cuda.device(x.device):
        err = fn(
            build.ptr(col_index), build.ptr(graph_id), build.ptr(dst_row), build.ptr(wsel),
            build.ptr(masks), build.ptr(x), build.ptr(w), build.ptr(b),
            build.ptr(a_src), build.ptr(a_dst), build.ptr(edge_bias),
            build.ptr(out), build.ptr(lse),
            U, W, B, din, H, Dh, leaky_slope, build.stream_of(x),
        )
    build.check_error(lib, _NAME, err)
    seg_gat_agg_fused_fp_fwd.launches += 1


def seg_gat_agg_fused_fp_fwd(
    col_index: torch.Tensor,   # int32 [U, W]  src block columns (-1 pad, unique per row)
    graph_id: torch.Tensor,    # int32 [U]
    dst_row: torch.Tensor,     # int32 [U]     dst block row within the graph
    wsel: torch.Tensor,        # int32 [G]     graph -> weight-table row
    masks: torch.Tensor,       # bool  [U, W, B, B]
    x: torch.Tensor,           # f32   [N_pad, Din]  raw features, shared src/dst space
    w: torch.Tensor,           # f32   [T, Din, H·Dh] (or [Din, H·Dh] shared)
    b: torch.Tensor,           # f32   [T, H·Dh]      (or [H·Dh] shared)
    a_src: torch.Tensor,       # f32   [G, H, Dh]
    a_dst: torch.Tensor,       # f32   [G, H, Dh]
    edge_bias: torch.Tensor | None = None,  # f32 [G, H]
    *,
    leaky_slope: float = 0.2,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused FP+NA: per-unit aggregates ``out [U·B, H, Dh]`` (same contract
    as ``seg_gat_agg_multigraph_fwd``) and ``lse [U·B, H]``.  ``x`` must
    cover every block index in ``col_index``/``dst_row`` (N_pad = n_blocks·B).

    CUDA operands launch the kernel; CPU operands take the plain version.
    float32 only."""
    dev = x.device
    if w.dim() == 2:
        w = w[None]
    if b.dim() == 1:
        b = b[None]
    build.check_tensor("col_index", col_index, torch.int32, (None, None), dev)
    U, W = col_index.shape
    build.check_tensor("masks", masks, torch.bool, (U, W, None, None), dev)
    B = masks.shape[-1]
    build.check_tensor("masks", masks, torch.bool, (U, W, B, B), dev)
    build.check_tensor("graph_id", graph_id, torch.int32, (U,), dev)
    build.check_tensor("dst_row", dst_row, torch.int32, (U,), dev)
    build.check_tensor("a_src", a_src, torch.float32, (None, None, None), dev)
    G, H, Dh = a_src.shape
    build.check_tensor("a_dst", a_dst, torch.float32, (G, H, Dh), dev)
    build.check_tensor("wsel", wsel, torch.int32, (G,), dev)
    build.check_tensor("x", x, torch.float32, (None, None), dev)
    n_pad, din = x.shape
    build.check_tensor("w", w, torch.float32, (None, din, H * Dh), dev)
    T = w.shape[0]
    build.check_tensor("b", b, torch.float32, (T, H * Dh), dev)
    if edge_bias is None:
        edge_bias = torch.zeros((G, H), dtype=torch.float32, device=dev)
    build.check_tensor("edge_bias", edge_bias, torch.float32, (G, H), dev)
    if n_pad % B:
        raise ValueError(f"x has {n_pad} rows, not a multiple of B={B}")
    build.check_range("col_index", col_index, -1, n_pad // B)
    build.check_range("graph_id", graph_id, 0, G)
    build.check_range("dst_row", dst_row, 0, n_pad // B)
    build.check_range("wsel", wsel, 0, T)

    if dev.type == "cpu":
        return seg_gat_agg_fused_fp_plain(
            col_index, graph_id, dst_row, wsel, masks, x, w, b, a_src, a_dst,
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
    launch(col_index, graph_id, dst_row, wsel, masks, x, w, b, a_src, a_dst,
           edge_bias, out, lse, float(leaky_slope))
    return out, lse


seg_gat_agg_fused_fp_fwd.launches = 0
