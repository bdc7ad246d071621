"""Single-graph fused NA forward (kernel #5) — the per-graph ``KERNEL``
backend of R-GAT and S-HGN.

One semantic graph in block CSR: dst-block row r sweeps its W src blocks
``col_index[r, w]`` (-1 = padding):

    logit[i, j, h] = LeakyReLU(theta_dst[r·B+i, h] + theta_src[col·B+j, h] + edge_bias[h]),
                     masked by masks[r, w, i, j]

and emits the softmax-weighted sum of ``h_src[col·B+j]`` per dst row and
head, ``out [R·B, H, Dh]``.  A row with no live edge gives exact zeros.

:func:`seg_gat_agg` is the wrapper: CUDA tensors launch the hand-written
kernel ``csrc/seg_gat_agg.cu``; CPU tensors take :func:`seg_gat_agg_plain`,
the plain PyTorch version of the same function (and the oracle the kernel
is held against).  The kernel is the multigraph forward's edge walk at one
graph (``csrc/edge_na.cuh``: a warp a dst row visits the set mask entries
of live slots only), so it takes every B in ``EDGE_BLOCKS`` and gives #1's
bits at G = 1.  Like the JAX package's kernel it has no gradient: an
operand that requires one raises, and MULTIGRAPH (kernels #1/#2 at G = 1)
is the differentiable per-graph route.

The wrapper takes ``topology=``, the graph's checked unit tables
(``topology.Topology.one_graph``), held to ``col_index`` and ``masks`` with
no device read while they are its own, unchanged tensors: KERNEL's
dispatch keeps one per graph (``core.fusion.SemanticGraphBatch.topology``).
A call without one checks the columns in the call (a host sync).
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .seg_gat_agg_multigraph import check_edge_shape
from .topology import Topology, resolve

_NAME = "seg_gat_agg"


def seg_gat_agg_plain(
    col_index, masks, theta_src, theta_dst, h_src, *, leaky_slope: float = 0.2,
    edge_bias: torch.Tensor | float = 0.0,
) -> torch.Tensor:
    """Plain PyTorch version of the kernel: the block-CSR online softmax of
    ``core.stages.block_softmax_aggregate``.  Returns [R·B, H, Dh]."""
    from ..core.stages import block_softmax_aggregate

    return block_softmax_aggregate(col_index, masks, theta_src, theta_dst, h_src,
                                   leaky_slope=leaky_slope, edge_bias=edge_bias)


def _kernel_fn():
    lib = build.load(_NAME)
    fn = lib.seg_gat_agg_fwd
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib, fn


def launch(col_index, masks, theta_src, theta_dst, h_src, edge_bias, out,
           leaky_slope: float, visits: torch.Tensor | None = None) -> None:
    """Launch the CUDA kernel on checked operands into ``out``, on the
    current stream.  ``visits`` (int32 [1] on the card, or None) gains the
    set mask entries the kernel visited.  Counts one launch."""
    R, W = col_index.shape
    B = masks.shape[-1]
    H, Dh = h_src.shape[1:]
    masks, h_src = build.aligned(masks), build.aligned(h_src)
    lib, fn = _kernel_fn()
    p = build.ptr
    with torch.cuda.device(h_src.device):
        err = fn(p(col_index), p(masks), p(theta_src), p(theta_dst), p(h_src), p(edge_bias),
                 p(out), None if visits is None else p(visits), R, W, B, H, Dh, leaky_slope,
                 build.stream_of(h_src))
    build.check_error(lib, _NAME, err)
    seg_gat_agg.launches += 1


def bias_vector(edge_bias, H: int, dev: torch.device) -> torch.Tensor:
    """``edge_bias`` (a number, a 0-d or an [H] tensor) as a contiguous
    float32 [H] tensor on ``dev``; never read on the host.  The one rule
    for a graph's bias: ``core.fusion.neighbor_aggregate`` applies it for
    every backend."""
    if not isinstance(edge_bias, torch.Tensor):
        return torch.full((H,), float(edge_bias), dtype=torch.float32, device=dev)
    if edge_bias.dtype != torch.float32 or edge_bias.device != dev:
        raise TypeError(f"edge_bias: expected float32 on {dev}, got {edge_bias.dtype} on "
                        f"{edge_bias.device}")
    if edge_bias.dim() == 0:
        return edge_bias.expand(H).contiguous()
    build.check_tensor("edge_bias", edge_bias, torch.float32, (H,), dev)
    return edge_bias


def seg_gat_agg(
    col_index: torch.Tensor,   # int32 [R, W]  src block columns (-1 pad, unique per row)
    masks: torch.Tensor,       # bool  [R, W, B, B]
    theta_src: torch.Tensor,   # f32   [Ns_pad, H]
    theta_dst: torch.Tensor,   # f32   [R·B, H]
    h_src: torch.Tensor,       # f32   [Ns_pad, H, Dh]
    *,
    leaky_slope: float = 0.2,
    edge_bias: torch.Tensor | float = 0.0,  # a number, or f32 [H]
    topology: Topology | None = None,
) -> torch.Tensor:
    """The attention-aggregated features ``[R·B, H, Dh]`` of one graph (the
    counterpart of ``repro.kernels.seg_gat_agg``).

    CUDA operands launch the kernel; CPU operands take the plain version.
    float32 only; no gradient.  ``topology``: the graph's
    ``Topology.one_graph``, held to ``col_index`` and ``masks``; None builds
    one in the call."""
    dev = h_src.device
    operands = (theta_src, theta_dst, h_src, edge_bias)
    if torch.is_grad_enabled() and any(isinstance(t, torch.Tensor) and t.requires_grad
                                       for t in operands):
        raise NotImplementedError(
            "seg_gat_agg (kernel #5, the KERNEL backend) has no gradient, like the JAX "
            "package's Pallas kernel: train through NABackend.MULTIGRAPH, the differentiable "
            "per-graph route (kernels #1/#2 at G = 1), or BLOCK")
    build.check_tensor("col_index", col_index, torch.int32, (None, None), dev)
    R, W = col_index.shape
    build.check_tensor("masks", masks, torch.bool, (R, W, None, None), dev)
    B = masks.shape[-1]
    build.check_tensor("masks", masks, torch.bool, (R, W, B, B), dev)
    build.check_tensor("theta_src", theta_src, torch.float32, (None, None), dev)
    ns_pad, H = theta_src.shape
    build.check_tensor("theta_dst", theta_dst, torch.float32, (R * B, H), dev)
    build.check_tensor("h_src", h_src, torch.float32, (ns_pad, H, None), dev)
    Dh = h_src.shape[-1]
    resolve(topology, col_index, None, None, masks, n_graphs=1, ns_pad=ns_pad, nd_pad=R * B)
    bias = bias_vector(edge_bias, H, dev)
    if dev.type == "cpu":
        return seg_gat_agg_plain(col_index, masks, theta_src, theta_dst, h_src,
                                 leaky_slope=leaky_slope, edge_bias=bias)
    if dev.type != "cuda":
        raise ValueError(f"{_NAME}: unsupported device {dev}")
    check_edge_shape(_NAME, B, H, Dh)
    out = torch.empty((R * B, H, Dh), dtype=torch.float32, device=dev)
    launch(col_index, masks, theta_src, theta_dst, h_src, bias, out, float(leaky_slope))
    return out


seg_gat_agg.launches = 0
