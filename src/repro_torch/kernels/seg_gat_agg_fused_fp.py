"""Stage-fusion megakernel, forward and backward: FP+NA in one call (paper Alg. 2).

The multigraph NA of ``seg_gat_agg_multigraph`` with the FP stage pulled
inside: the call takes **raw** features and the weight tables, projects
``h = x·W[t] + b[t]`` (t = ``wsel[graph]``), takes the attention
coefficients from the float32 h and feeds it into the online-softmax
aggregation.

On the card each call runs two kernels back to back, counted as one
launch.  Phase P projects every (weight table, 128-row tile) that a live
unit reads exactly once (:func:`row_tiles`, from the topology alone) into
a workspace ``h [T, N_pad, H·Dh]`` in device memory: on the tensor cores
by split TF32 (kernel #6's product, ``csrc/split_tf32_gemm.cuh``) or, on
the widths that route does not take, on the CUDA cores (:func:`route`).
Phase A runs the NA sweep per unit, copying its B × H·Dh tiles from h.
Unlike the TPU kernel, which re-projects a src tile for every (unit, slot)
and keeps h in VMEM, projected features do go to device memory: a src
tile is read by hundreds of units spread over every SM, and only L2 (50
MB; h is 10.1 MB at HAN's full-IMDB shape) is shared by all of them.

:func:`seg_gat_agg_fused_fp_fwd` is the wrapper: CUDA tensors launch
``csrc/seg_gat_agg_fused_fp.cu``; CPU tensors take
:func:`seg_gat_agg_fused_fp_plain`, which projects every vertex once and
then aggregates (the plain version, and the oracle the kernel is held
against).

The backward (:func:`seg_gat_agg_fused_fp_bwd`) recomputes h by phase P
and p from ``lse``: CUDA tensors launch ``csrc/seg_gat_agg_fused_fp_bwd.cu``
(per-live-slot and per-unit projection-space partials, then deterministic
segmented sums by weight table and by graph); the chain through h is two
plain products.  CPU tensors take :func:`seg_gat_agg_fused_fp_bwd_plain`.
:func:`seg_gat_agg_fused_fp` is the differentiable entry point (a
``torch.autograd.Function`` around kernels #3 and #4).  Every entry takes
``topology=``, the checked unit tables (``topology.Topology``), which a
caller that runs many steps on one batch set builds once; both directions
read its fused index (``Topology.fused_index``: the row tiles, the
backward's CSRs).

The .cu files instantiate B = 8, 16 and 32 (``SUPPORTED_BLOCKS``).  A
larger block (64 or 128, as ``EDGE_BLOCKS``) is re-blocked on the host to
B' = 32 before the launch (:func:`reblock`, kept on the fused index): each unit
becomes B/32 sub-units whose slots are its non-empty 32 × 32 sub-masks.
The output rows keep their place, so ``out``, ``lse`` and the VJP are
those of the B-unit layout; the online softmax takes a row's entries in
another order, so B = 128 agrees with MULTIGRAPH and with the plain
version within float32 tolerance, not bit for bit.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .fused_fp_coeff import BLOCK_M, split_error, split_k, split_scratch
from .seg_gat_agg_multigraph import (
    SUPPORTED_BLOCKS,
    check_smem,
    unit_softmax_aggregate,
    unit_softmax_aggregate_vjp,
)
from .topology import Topology, csr, resolve

ROW_TILE = BLOCK_M  # rows of x a tile of phase P covers (csrc/fused_fp_project.cuh: kRowTile)
ROUTES = ("wgmma", "cuda_cores")  # phase P's projection: tensor cores, CUDA cores
_ROUTE_CODE = {"wgmma": 0, "cuda_cores": 1}
KERNEL_BLOCK = max(SUPPORTED_BLOCKS)  # a larger B is re-blocked to this one (:func:`reblock`)
_NAME = "seg_gat_agg_fused_fp"
_BWD_NAME = "seg_gat_agg_fused_fp_bwd"


def _project(x, w, b, wsel, a_src, a_dst):
    """Project every vertex once per weight table: (h_all [T, N, H, Dh],
    theta_src [G, N, H], theta_dst [G, N, H], h per graph [G, N, H, Dh])."""
    G, H, Dh = a_src.shape
    T, n = w.shape[0], x.shape[0]
    h_all = (torch.einsum("nd,tdk->tnk", x, w) + b[:, None, :]).reshape(T, n, H, Dh)
    hg = h_all[wsel.long()]
    return (h_all, torch.einsum("gnhd,ghd->gnh", hg, a_src),
            torch.einsum("gnhd,ghd->gnh", hg, a_dst), hg)


def seg_gat_agg_fused_fp_plain(
    col_index, graph_id, dst_row, wsel, masks, x, w, b, a_src, a_dst, edge_bias,
    *, leaky_slope: float = 0.2,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version: project once, then aggregate.
    Returns (out [U·B, H, Dh], lse [U·B, H])."""
    h_all, ths, thd, _ = _project(x, w, b, wsel, a_src, a_dst)
    return unit_softmax_aggregate(
        col_index, graph_id, dst_row, masks, ths, thd, h_all, wsel, edge_bias, leaky_slope,
    )


def _chain_projection(x, w, dh_t, need_dx: bool):
    """Through ``h = x·W[t] + b[t]``: (d_x or None, d_w, d_b) from the
    projection-space gradient ``dh_t [T, N, H·Dh]``."""
    d_w = torch.matmul(x.t(), dh_t)                    # [T, Din, H·Dh]
    d_x = torch.matmul(dh_t, w.transpose(1, 2)).sum(dim=0) if need_dx else None
    return d_x, d_w, dh_t.sum(dim=1)


def seg_gat_agg_fused_fp_bwd_plain(
    col_index, graph_id, dst_row, wsel, masks, x, w, b, a_src, a_dst, edge_bias,
    out, lse, g_out, *, leaky_slope: float = 0.2, need_dx: bool = True,
):
    """Plain PyTorch version of the backward (the whole VJP of the JAX
    ``_fused_bwd``): project once, take the multigraph VJP on the projected
    tables, then chain through the attention vectors and the projection.
    Returns (d_x or None, d_w, d_b, d_a_src, d_a_dst, d_edge_bias)."""
    T = w.shape[0]
    n = x.shape[0]
    h_all, ths, thd, hg = _project(x, w, b, wsel, a_src, a_dst)
    delta = (g_out * out).sum(dim=-1)
    d_ths, d_thd, d_h, d_bias = unit_softmax_aggregate_vjp(
        col_index, graph_id, dst_row, masks, ths, thd, h_all, wsel, edge_bias, leaky_slope,
        lse, delta, g_out,
    )
    # theta = <h, a> per graph: back into the graph's table and into a
    d_hg = d_ths[..., None] * a_src[:, None] + d_thd[..., None] * a_dst[:, None]
    d_h = d_h.index_add(0, wsel.long(), d_hg)
    d_a_src = torch.einsum("gnh,gnhd->ghd", d_ths, hg)
    d_a_dst = torch.einsum("gnh,gnhd->ghd", d_thd, hg)
    d_x, d_w, d_b = _chain_projection(x, w, d_h.reshape(T, n, -1), need_dx)
    return d_x, d_w, d_b, d_a_src, d_a_dst, d_bias


def smem_bytes(B: int, H: int, Dh: int) -> int:
    """Dynamic shared memory of one block of the forward's phase A (mirrors
    the .cu layout)."""
    return 4 * (2 * B * H * Dh + H * B * B + 5 * B * H) + B * B


def bwd_smem_bytes(B: int, H: int, Dh: int) -> int:
    """Dynamic shared memory of one block of the backward's pass 1 (mirrors
    the .cu layout)."""
    return 4 * (2 * B * H * Dh + 2 * H * B * B + H * Dh + 6 * B * H) + B * B


def route(H: int, Dh: int) -> str:
    """Which kernel projects in phase P on the card: ``"wgmma"`` (split TF32
    on the tensor cores, kernel #6's product) wherever that kernel takes
    the width, H·Dh a multiple of 8 (``csrc/fused_fp_project.cuh``), else
    ``"cuda_cores"`` (float32 FMAs)."""
    return "wgmma" if (H * Dh) % 8 == 0 else "cuda_cores"


def row_tiles(col_index, graph_id, dst_row, wsel, n_pad: int, block: int) -> torch.Tensor:
    """The tiles phase P projects: int32 ids ``t·R + r`` (R = ceil(N_pad /
    ROW_TILE) row tiles a table), sorted, each once.  Tile (t, r) is listed
    iff a live unit reads a block of rows ``r·ROW_TILE ..`` through table t:
    the src block of one of its live slots, or its dst block (a unit with
    no live slot reads nothing).  Depends on the topology only."""
    per = ROW_TILE // block
    R = -(-n_pad // ROW_TILE)
    live = col_index >= 0
    table = wsel.long()[graph_id.long()]
    src = table[:, None].expand_as(col_index)[live] * R + col_index.long()[live] // per
    unit_live = live.any(dim=1)
    dst = table[unit_live] * R + dst_row.long()[unit_live] // per
    return torch.unique(torch.cat([src, dst])).int().contiguous()


def tile_rows(tiles, n_pad: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The rows phase P writes for the listed ``tiles``: (table, row), two
    int64 tensors, tile by tile."""
    R = -(-n_pad // ROW_TILE)
    ids = tiles.long()
    rows = (ids % R)[:, None] * ROW_TILE + torch.arange(ROW_TILE, device=ids.device)
    keep = rows < n_pad
    return (ids // R)[:, None].expand_as(rows)[keep], rows[keep]


def projection_split_error(h, tiles, x, w, b) -> float:
    """``fused_fp_coeff.split_error`` of phase P's workspace ``h [T, N_pad,
    C]`` (:func:`launch` returns it) over the rows of the listed ``tiles``
    (:func:`tile_rows`), table by table, against ``x·W[t] + b[t]``: what
    ``SPLIT_ERROR_MAX`` holds the wgmma route to."""
    table, rows = tile_rows(tiles, x.shape[0])
    err = 0.0
    for t in torch.unique(table).tolist():
        r = rows[table == t]
        err = max(err, split_error(h[t, r], x[r], w[t], b[t]))
    return err


def live_slots(col_index: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(pos [P], pair_of int32 [U, W]): the flat (unit, slot) position of
    every live slot in order, and each slot's number among them (-1 for
    padding).  The backward writes partials for live slots only."""
    live = (col_index >= 0).reshape(-1)
    pos = live.nonzero().squeeze(1)
    pair_of = torch.full((live.numel(),), -1, dtype=torch.int32, device=col_index.device)
    pair_of[pos] = torch.arange(pos.numel(), dtype=torch.int32, device=col_index.device)
    return pos, pair_of.reshape(col_index.shape)


def bwd_index(col_index, graph_id, dst_row, wsel, n_graphs: int, n_tables: int,
              nblk: int) -> dict:
    """The live-slot numbering and the two CSRs the backward reduces over:
    the slots (rows 0..P-1 of the partial buffer) and units (rows P..P+U-1)
    by (weight table, block), and the units by graph.  Depends on the
    topology only."""
    W = col_index.shape[1]
    pos, pair_of = live_slots(col_index)
    pcol = col_index.reshape(-1)[pos].long()
    table = wsel.long()[graph_id.long()]
    keys = torch.cat([table[pos // W] * nblk + pcol, table * nblk + dst_row.long()])
    return dict(n_live=int(pos.numel()), pair_of=pair_of,
                table=csr(keys, n_tables * nblk), graph=csr(graph_id, n_graphs))


def reblock(col_index, graph_id, dst_row, masks, block: int = KERNEL_BLOCK):
    """The units of ``masks``' block B (a multiple of ``block``) as units of
    ``block``: (col_index, graph_id, dst_row, masks) with U·n units, n =
    B / block.  Unit u becomes the sub-units (u, i), i < n, in that order:
    ``dst_row' = n·dst_row + i``, its graph copied, and as slots the
    non-empty ``block × block`` sub-masks ``masks[u, w, i·block:, k·block:]``
    of u's live slots, at ``col' = n·col + k``, in (w, k) order, compacted
    and padded with -1 to the widest sub-unit's count (at least one slot, so
    that a sub-unit with no set entry writes its rows as an empty row).  Row
    r of sub-unit (u, i) is row ``u·B + i·block + r`` of the B layout: the
    kernels' ``out`` and ``lse`` are laid out as at B.  One host sync."""
    U, W = col_index.shape
    B = masks.shape[-1]
    if B % block:
        raise ValueError(f"{_NAME}: block size B={B} is not a multiple of {block}")
    n = B // block
    dev = col_index.device
    sub = masks.reshape(U, W, n, block, n, block)
    # [U·n, W·n]: sub-unit (u, i), slot (w, k)
    live = (sub.any(dim=5).any(dim=3) & (col_index >= 0)[:, :, None, None])
    live = live.permute(0, 2, 1, 3).reshape(U * n, W * n)
    width = max(1, int(live.sum(dim=1).max())) if live.numel() else 1
    order = torch.argsort((~live).to(torch.int8), dim=1, stable=True)[:, :width]
    keep = torch.gather(live, 1, order)
    sub_unit = torch.arange(U * n, device=dev)
    u, i = (sub_unit // n)[:, None], (sub_unit % n)[:, None]
    w, k = order // n, order % n
    col = torch.where(keep, col_index.long()[u, w] * n + k, -1).int()
    sub_masks = sub[u, w, i, :, k, :] & keep[:, :, None, None]
    row = dst_row.long().repeat_interleave(n) * n + sub_unit % n
    return (col.contiguous(), graph_id.repeat_interleave(n).contiguous(),
            row.int().contiguous(), sub_masks.contiguous())


def _projection_scratch(route_: str, n_tiles: int, T: int, n_pad: int, din: int, C: int,
                        device) -> tuple:
    """Phase P's workspace ``h [T, N_pad, C]`` and, on the wgmma route, its
    scratch (``fused_fp_coeff.split_scratch`` over the listed tiles' rows).
    Returns (h, scratch, S, the four scratch addresses)."""
    h = torch.empty((T, n_pad, C), dtype=torch.float32, device=device)
    if route_ == "cuda_cores" or n_tiles == 0:
        return h, None, 1, (0, 0, 0, 0)
    S = split_k(n_tiles * ROW_TILE, din, C)
    scratch, addresses = split_scratch(n_tiles * ROW_TILE, din, C, T, S, device)
    return h, scratch, S, addresses


def _kernel_fn():
    lib = build.load(_NAME)
    fn = lib.seg_gat_agg_fused_fp_fwd
    fn.argtypes = ([ctypes.c_void_p] * 19 + [ctypes.c_int] * 12
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib, fn


def _bwd_kernel_fn():
    lib = build.load(_BWD_NAME)
    fn = lib.seg_gat_agg_fused_fp_bwd
    fn.argtypes = ([ctypes.c_void_p] * 33 + [ctypes.c_int] * 14
                   + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return lib, fn


def launch(col_index, graph_id, dst_row, wsel, masks, x, w, b, a_src, a_dst,
           edge_bias, out, lse, leaky_slope: float, index: dict) -> torch.Tensor:
    """Launch phase P (on :func:`route`) and phase A on checked operands,
    the unit tables of their topology's fused index ``index``
    (``Topology.fused_index``), into ``out``/``lse``, on the current
    stream.  Returns phase P's
    workspace ``h [T, N_pad, H·Dh]``: the rows of the listed tiles hold
    ``x·W[t] + b[t]``, the others are undefined.  Counts one launch, in
    total and by projection route."""
    U, W = col_index.shape
    B = masks.shape[-1]
    H, Dh = a_src.shape[1:]
    T, din = w.shape[:2]
    n_pad = x.shape[0]
    route_ = route(H, Dh)
    tiles = index["tiles"]
    L = int(tiles.numel())
    # h and the scratch buffer stay referenced until the launch is enqueued
    h, scratch, S, (wt, part, chains, tickets) = _projection_scratch(
        route_, L, T, n_pad, din, H * Dh, x.device)
    lib, fn = _kernel_fn()
    p = build.ptr
    with torch.cuda.device(x.device):
        err = fn(
            p(col_index), p(graph_id), p(dst_row), p(wsel), p(masks), p(x), p(w), p(b),
            p(a_src), p(a_dst), p(edge_bias), p(tiles), p(h), wt, part, chains, tickets,
            p(out), p(lse),
            U, W, B, T, n_pad, din, H, Dh, L, -(-n_pad // ROW_TILE), _ROUTE_CODE[route_], S,
            leaky_slope, build.stream_of(x),
        )
    build.check_error(lib, _NAME, err)
    seg_gat_agg_fused_fp_fwd.launches += 1
    seg_gat_agg_fused_fp_fwd.launches_by_route[route_] += 1
    return h


def launch_bwd(col_index, graph_id, dst_row, wsel, masks, x, w, b, a_src, a_dst, edge_bias,
               g_out, lse, delta, index: dict, leaky_slope: float):
    """Launch the backward (phase P on :func:`route`, then pass 1 and its
    reductions) on checked operands as :func:`launch` takes them, ``index``
    with its backward part, on the current stream.  Returns (dh_t [T, N_pad, H·Dh], d_a_src, d_a_dst,
    d_edge_bias).  Counts one launch, in total and by projection route."""
    U, W = col_index.shape
    B = masks.shape[-1]
    G, H, Dh = a_src.shape
    T, din = w.shape[:2]
    n_pad = x.shape[0]
    route_ = route(H, Dh)
    n_live = index["n_live"]
    tiles = index["tiles"]
    L = int(tiles.numel())
    f32 = dict(dtype=torch.float32, device=x.device)
    h, scratch, S, (wt, part, chains, tickets) = _projection_scratch(
        route_, L, T, n_pad, din, H * Dh, x.device)
    dh_part = torch.empty((n_live + U, B, H * Dh), **f32)
    dthd_units = torch.empty((U, B * H), **f32)
    das_units = torch.empty((U, H * Dh), **f32)
    dad_units = torch.empty((U, H * Dh), **f32)
    dh_t = torch.empty((T, n_pad, H * Dh), **f32)
    d_a_src = torch.empty((G, H, Dh), **f32)
    d_a_dst = torch.empty((G, H, Dh), **f32)
    dthd_g = torch.empty((G, B, H), **f32)
    lib, fn = _bwd_kernel_fn()
    p = build.ptr
    with torch.cuda.device(x.device):
        err = fn(
            p(col_index), p(index["pair_of"]), p(graph_id), p(dst_row), p(wsel), p(masks),
            p(x), p(w), p(b), p(a_src), p(a_dst), p(edge_bias), p(g_out), p(lse), p(delta),
            p(tiles), p(h), wt, part, chains, tickets,
            p(dh_part), p(dthd_units), p(das_units), p(dad_units),
            *(p(t) for key in ("table", "graph") for t in index[key]),
            p(dh_t), p(d_a_src), p(d_a_dst), p(dthd_g),
            U, W, n_live, B, G, T, n_pad, din, H, Dh, L, -(-n_pad // ROW_TILE),
            _ROUTE_CODE[route_], S, leaky_slope, build.stream_of(x),
        )
    build.check_error(lib, _BWD_NAME, err)
    seg_gat_agg_fused_fp_bwd.launches += 1
    seg_gat_agg_fused_fp_bwd.launches_by_route[route_] += 1
    return dh_t, d_a_src, d_a_dst, dthd_g.sum(dim=1)


def _check_operands(topology, col_index, graph_id, dst_row, wsel, masks, x, w, b, a_src, a_dst,
                    edge_bias, *, backward: bool):
    """Check the operands of either direction and hold ``topology`` to the
    unit tables (or build one from them: ``topology.resolve``), over one
    table of ``x``'s rows.  Returns (w, b, edge_bias, the topology's fused
    index for ``wsel``), a shared table taken as T = 1, zeros for a None
    bias."""
    dev = x.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{_NAME}: unsupported device {dev}")
    if w.dim() == 2:
        w = w[None]
    if b.dim() == 1:
        b = b[None]
    build.check_tensor("a_src", a_src, torch.float32, (None, None, None), dev)
    G, H, Dh = a_src.shape
    build.check_tensor("a_dst", a_dst, torch.float32, (G, H, Dh), dev)
    build.check_tensor("x", x, torch.float32, (None, None), dev)
    n_pad, din = x.shape
    build.check_tensor("w", w, torch.float32, (None, din, H * Dh), dev)
    T = w.shape[0]
    build.check_tensor("b", b, torch.float32, (T, H * Dh), dev)
    if edge_bias is None:
        edge_bias = torch.zeros((G, H), dtype=torch.float32, device=dev)
    build.check_tensor("edge_bias", edge_bias, torch.float32, (G, H), dev)
    topology = resolve(topology, col_index, graph_id, dst_row, masks, n_graphs=G, ns_pad=n_pad,
                       nd_pad=n_pad)
    if topology.device != dev:
        raise ValueError(f"{_NAME}: the topology is on {topology.device}, x on {dev}")
    return w, b, edge_bias, topology.fused_index(wsel, T, backward=backward)


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
    topology: Topology | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused FP+NA: per-unit aggregates ``out [U·B, H, Dh]`` (same contract
    as ``seg_gat_agg_multigraph_fwd``) and ``lse [U·B, H]``.  ``x`` must
    cover every block index in ``col_index``/``dst_row`` (N_pad = n_blocks·B).

    CUDA operands launch the kernel (B above 32 re-blocked to 32,
    :func:`reblock`); CPU operands take the plain version.  float32 only.
    ``topology``: the ``Topology`` of the unit tables at Ns_pad = Nd_pad =
    N_pad, held to them (None: built in the call, a host read)."""
    w, b, edge_bias, index = _check_operands(topology, col_index, graph_id, dst_row, wsel, masks,
                                             x, w, b, a_src, a_dst, edge_bias, backward=False)
    if x.device.type == "cpu":
        return seg_gat_agg_fused_fp_plain(
            col_index, graph_id, dst_row, wsel, masks, x, w, b, a_src, a_dst,
            edge_bias, leaky_slope=leaky_slope,
        )
    U, B, (H, Dh) = col_index.shape[0], masks.shape[-1], a_src.shape[1:]
    kb = index["units"][3].shape[-1]
    check_smem(_NAME, kb, H, Dh, smem_bytes(kb, H, Dh))
    out = torch.empty((U * B, H, Dh), dtype=torch.float32, device=x.device)
    lse = torch.empty((U * B, H), dtype=torch.float32, device=x.device)
    launch(*index["units"][:3], wsel, index["units"][3], x, w, b, a_src, a_dst,
           edge_bias, out, lse, float(leaky_slope), index)
    return out, lse


def seg_gat_agg_fused_fp_bwd(
    col_index, graph_id, dst_row, wsel, masks, x, w, b, a_src, a_dst, edge_bias,
    out: torch.Tensor,    # f32 [U·B, H, Dh]  the forward's output
    lse: torch.Tensor,    # f32 [U·B, H]      the forward's residual
    g_out: torch.Tensor,  # f32 [U·B, H, Dh]  cotangent of out
    *,
    leaky_slope: float = 0.2,
    need_dx: bool = True,
    topology: Topology | None = None,
):
    """The VJP of :func:`seg_gat_agg_fused_fp_fwd`: (d_x or None, d_w
    [T, Din, H·Dh], d_b [T, H·Dh], d_a_src, d_a_dst, d_edge_bias), bitwise
    repeatable on the card.  ``need_dx=False`` skips the ``d_x`` product.

    CUDA operands launch the backward kernel (B above 32 re-blocked to 32,
    :func:`reblock`); CPU operands take the plain version.  float32 only.
    ``topology`` as in the forward."""
    dev = x.device
    w, b, edge_bias, index = _check_operands(topology, col_index, graph_id, dst_row, wsel, masks,
                                             x, w, b, a_src, a_dst, edge_bias,
                                             backward=dev.type == "cuda")
    U, B, H, Dh = col_index.shape[0], masks.shape[-1], *a_src.shape[1:]
    build.check_tensor("out", out, torch.float32, (U * B, H, Dh), dev)
    build.check_tensor("lse", lse, torch.float32, (U * B, H), dev)
    build.check_tensor("g_out", g_out, torch.float32, (U * B, H, Dh), dev)
    if dev.type == "cpu":
        return seg_gat_agg_fused_fp_bwd_plain(
            col_index, graph_id, dst_row, wsel, masks, x, w, b, a_src, a_dst, edge_bias,
            out, lse, g_out, leaky_slope=leaky_slope, need_dx=need_dx,
        )
    kb = index["units"][3].shape[-1]
    check_smem(_BWD_NAME, kb, H, Dh, bwd_smem_bytes(kb, H, Dh))
    delta = (g_out * out).sum(dim=-1)
    dh_t, d_a_src, d_a_dst, d_bias = launch_bwd(
        *index["units"][:3], wsel, index["units"][3], x, w, b, a_src, a_dst, edge_bias,
        g_out, lse, delta, index, float(leaky_slope))
    d_x, d_w, d_b = _chain_projection(x, w, dh_t, need_dx)
    return d_x, d_w, d_b, d_a_src, d_a_dst, d_bias


seg_gat_agg_fused_fp_fwd.launches = 0
seg_gat_agg_fused_fp_fwd.launches_by_route = dict.fromkeys(ROUTES, 0)
seg_gat_agg_fused_fp_bwd.launches = 0
seg_gat_agg_fused_fp_bwd.launches_by_route = dict.fromkeys(ROUTES, 0)


class FusedFPNA(torch.autograd.Function):
    """Forward kernel #3 keeping ``out`` and ``lse``; backward kernel #4,
    both on the unit tables of one checked ``Topology``."""

    @staticmethod
    def forward(ctx, topology, wsel, x, w, b, a_src, a_dst, edge_bias, leaky_slope):
        col_index, graph_id, dst_row, masks = topology.units
        out, lse = seg_gat_agg_fused_fp_fwd(
            col_index, graph_id, dst_row, wsel, masks, x, w, b, a_src, a_dst, edge_bias,
            leaky_slope=leaky_slope, topology=topology)
        ctx.save_for_backward(wsel, x, w, b, a_src, a_dst, edge_bias, out, lse)
        ctx.leaky_slope = leaky_slope
        ctx.topology = topology
        return out

    @staticmethod
    def backward(ctx, g_out):
        wsel, *operands, out, lse = ctx.saved_tensors
        col_index, graph_id, dst_row, masks = ctx.topology.units
        grads = seg_gat_agg_fused_fp_bwd(col_index, graph_id, dst_row, wsel, masks, *operands,
                                         out, lse, g_out.contiguous(),
                                         leaky_slope=ctx.leaky_slope,
                                         need_dx=ctx.needs_input_grad[2], topology=ctx.topology)
        return (None, None, *grads, None)


def seg_gat_agg_fused_fp(
    col_index, graph_id, dst_row, wsel, masks, x, w, b, a_src, a_dst,
    edge_bias: torch.Tensor | None = None, *, leaky_slope: float = 0.2,
    topology: Topology | None = None,
) -> torch.Tensor:
    """Differentiable fused FP+NA ``[U·B, H, Dh]`` (the counterpart of
    ``repro``'s ``seg_gat_agg_fused_fp``): gradients flow to x, w, b,
    a_src, a_dst and edge_bias through kernel #4.  A 2-D ``w`` / 1-D ``b``
    is one shared table.  ``topology``: the ``Topology`` of the unit tables,
    built once by a caller that runs many steps on it (None: built here),
    which both directions read."""
    if w.dim() == 2:
        w = w[None]
    if b.dim() == 1:
        b = b[None]
    if edge_bias is None:
        G, H, _ = a_src.shape
        edge_bias = torch.zeros((G, H), dtype=torch.float32, device=x.device)
    topology = resolve(topology, col_index, graph_id, dst_row, masks, n_graphs=a_src.shape[0],
                       ns_pad=x.shape[0], nd_pad=x.shape[0])
    return FusedFPNA.apply(topology, wsel, x, w, b, a_src, a_dst, edge_bias, float(leaky_slope))
