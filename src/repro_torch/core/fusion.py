"""NA execution paths of the port (the counterpart of ``repro.core.fusion``).

Five interchangeable NA backends with identical semantics:

* ``SEGMENT``    — two-pass segment softmax over a dst-sorted padded edge
  list (``stages.segment_softmax_aggregate``, plain PyTorch): the staged
  baseline, one semantic graph at a time.
* ``BLOCK``      — plain PyTorch block-CSR online softmax, one semantic
  graph at a time (``stages.block_softmax_aggregate``, the oracle).
* ``KERNEL``     — the per-graph kernel #5 (``kernels/seg_gat_agg``): one
  launch per semantic graph, forward only (no gradient, as in the JAX
  package; an operand that requires one raises).  R-GAT's and S-HGN's
  inference path, whose FP+θ of each relation also runs on a kernel there:
  :func:`project_coefficients` launches kernel #6
  (``kernels/fused_fp_coeff``) once per projected side.
* ``MULTIGRAPH`` — ALL semantic graphs of a step in one launch of the
  multigraph kernel (``kernels/seg_gat_agg_multigraph``): the paper's
  multi-lane datapath; for one graph it is the differentiable per-graph
  route (kernels #1/#2 at G = 1).
* ``FUSED_FP``   — the multigraph launch with the FP stage pulled inside
  (``kernels/seg_gat_agg_fused_fp``): raw features and per-graph weight
  tables go in (paper Alg. 2).  On the card each (table, row tile) a live
  unit reads is projected once into an L2-sized workspace that the NA
  sweep reads, where the reference keeps h' out of device memory (DESIGN.md
  §10; the port's reason is in the kernel module).  Takes
  ``fp=FusedFPInputs`` in place of the theta/h operands.

On CUDA tensors the kernel backends launch the hand-written kernels; on
CPU tensors the kernel wrappers take their plain PyTorch versions.
MULTIGRAPH and FUSED_FP go through the kernels' ``torch.autograd.Function``s,
which keep the forward's ``lse`` residual for the backward kernel.  Under
``torch.no_grad()`` (serving), or when no operand requires grad, the
Function runs the same single forward launch, its output has no
``grad_fn`` and the residual is freed on return.  SEGMENT and BLOCK are
differentiable by plain autograd.
"""
from __future__ import annotations

import dataclasses
import enum
import functools

import numpy as np
import torch

from ..graphs.formats import to_block_csr, to_padded_edges
from ..graphs.hetgraph import HetGraph, SemanticGraph
from ..kernels.fused_fp_coeff import fused_fp_coeff
from ..kernels.seg_gat_agg import bias_vector, seg_gat_agg
from ..kernels.seg_gat_agg_fused_fp import seg_gat_agg_fused_fp
from ..kernels.seg_gat_agg_multigraph import (
    JointPriors,
    seg_gat_agg_multigraph,
    seg_gat_agg_multigraph_joint,
)
from ..kernels.topology import JOINT_TABLES, Topology, hold, joint_index
from ..obs.trace import trace_span, tracing_enabled
from . import stages


class NABackend(enum.Enum):
    SEGMENT = "segment"
    BLOCK = "block"
    KERNEL = "kernel"
    MULTIGRAPH = "multigraph"
    FUSED_FP = "fused_fp"


# materialized-path equivalent of the fused backend (serving's FP-cache-hit
# bypass: the projected table already exists, so re-projecting inside the
# kernel would waste the cache)
_FUSED_TO_MULTIGRAPH = {NABackend.FUSED_FP: NABackend.MULTIGRAPH}


@dataclasses.dataclass
class SemanticGraphBatch:
    """Device-resident formats for one semantic graph: its block CSR, and
    its padded edge list built at first use."""

    name: str
    src_type: str
    dst_type: str
    num_src: int
    num_dst: int
    num_edges: int
    path_types: tuple[str, ...]
    col_index: torch.Tensor  # int32 [R, W]  (-1 = padding)
    masks: torch.Tensor      # bool  [R, W, B, B]
    block: int
    graph: SemanticGraph = dataclasses.field(repr=False)  # host edges

    @property
    def num_dst_pad(self) -> int:
        return int(self.col_index.shape[0]) * self.block

    @property
    def num_src_pad(self) -> int:
        return -(-self.num_src // self.block) * self.block

    def row_edge_counts(self) -> np.ndarray:
        """#edges per dst-block row (workload units for lane scheduling)."""
        return self.masks.sum(dim=(1, 2, 3)).cpu().numpy().astype(np.int64)

    @functools.cached_property
    def edges(self) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """The dst-sorted padded edge list ``(src, dst, valid)`` (int32,
        int32, bool [E_pad]) on the batch's device, read by SEGMENT and mean
        NA only: built the first time one of them runs, then kept."""
        pe = to_padded_edges(self.graph)
        dev = self.col_index.device
        return (torch.as_tensor(pe.src, device=dev), torch.as_tensor(pe.dst, device=dev),
                torch.as_tensor(pe.valid, device=dev))

    @functools.cached_property
    def topology(self) -> Topology:
        """The batch's own block CSR as the checked work units of one graph
        (``kernels.topology.Topology.one_graph``), read by KERNEL (#5) and
        the per-graph MULTIGRAPH path (#1/#2 at G = 1; R-GAT runs it per
        relation, layer and step): built the first time one of them runs,
        then kept, with the edge index #2 builds on it."""
        return Topology.one_graph(self.col_index, self.masks, ns_pad=self.num_src_pad)


def batch_semantic_graph(
    sg: SemanticGraph,
    *,
    block: int = 128,
    device: str | torch.device = "cpu",
) -> SemanticGraphBatch:
    with trace_span("setup/block_csr", graph=sg.name):
        bc = to_block_csr(sg, block=block)
    return SemanticGraphBatch(
        name=sg.name,
        src_type=sg.src_type,
        dst_type=sg.dst_type,
        num_src=sg.num_src,
        num_dst=sg.num_dst,
        num_edges=sg.num_edges,
        path_types=sg.path_types,
        col_index=torch.as_tensor(bc.col_index, device=device),
        masks=torch.as_tensor(bc.masks, device=device),
        block=block,
        graph=sg,
    )


@dataclasses.dataclass
class FusedFPInputs:
    """Operands of the FUSED_FP backend: raw features plus the projection
    and attention parameters the megakernel applies on chip.

    ``w``/``b`` are stacked per weight *table* and ``wsel`` maps each
    semantic graph to its table — graphs sharing a projection (HAN: all of
    them) share one table.
    """

    x: torch.Tensor       # [N, Din]       raw features (shared src/dst space)
    w: torch.Tensor       # [T, Din, H*Dh] per-table projection weights
    b: torch.Tensor       # [T, H*Dh]
    a_src: torch.Tensor   # [G, H, Dh]
    a_dst: torch.Tensor   # [G, H, Dh]
    wsel: torch.Tensor    # int32 [G]      graph -> weight-table row

    @classmethod
    def shared(cls, x, w, b, a_src, a_dst) -> "FusedFPInputs":
        """All graphs project through ONE weight table (HAN's layout)."""
        return cls(
            x=x,
            w=w[None] if w.dim() == 2 else w,
            b=b[None] if b.dim() == 1 else b,
            a_src=a_src,
            a_dst=a_dst,
            wsel=torch.zeros((a_src.shape[0],), dtype=torch.int32, device=x.device),
        )


def _graph_names(batches: list[SemanticGraphBatch]) -> list[str] | None:
    """A span's ``graph_names``, built only while a tracer is enabled."""
    return [bb.name for bb in batches] if tracing_enabled() else None


def _pad_rows(x: torch.Tensor, n: int) -> torch.Tensor:
    if x.shape[0] == n:
        return x
    if x.shape[0] > n:
        raise ValueError(f"{x.shape[0]} rows do not fit in {n}")
    return torch.cat([x, x.new_zeros((n - x.shape[0], *x.shape[1:]))])


def unit_topology(batches: list[SemanticGraphBatch]) -> Topology:
    """The checked ``Topology`` of these batches' :func:`build_unit_tables`,
    padded as :func:`neighbor_aggregate_multi` pads θ and h: what its
    ``topology=`` takes."""
    b0 = batches[0]
    return Topology(*build_unit_tables(batches), n_graphs=len(batches), ns_pad=b0.num_src_pad,
                    nd_pad=b0.num_dst_pad)


def build_unit_tables(batches: list[SemanticGraphBatch]):
    """Stack the block-CSR rows of several semantic graphs into the flat
    (col_index, graph_id, dst_row, masks) work-unit layout of the
    multigraph kernels: one unit per (graph, dst-block row), col widths
    padded to the max across graphs.  Requires all graphs to share the dst
    vertex space and block size (HAN's metapath graphs do).  Runs on the
    batches' device."""
    if not batches:
        raise ValueError("no semantic graphs")
    b = batches[0].block
    n_rows = int(batches[0].col_index.shape[0])
    dev = batches[0].col_index.device
    for bb in batches:
        if bb.block != b or int(bb.col_index.shape[0]) != n_rows:
            raise ValueError("semantic graphs must share the block size and dst vertex space")

    w_max = max(int(bb.col_index.shape[1]) for bb in batches)
    g_n = len(batches)
    col = torch.full((g_n, n_rows, w_max), -1, dtype=torch.int32, device=dev)
    masks = torch.zeros((g_n, n_rows, w_max, b, b), dtype=torch.bool, device=dev)
    for i, bb in enumerate(batches):
        wg = int(bb.col_index.shape[1])
        col[i, :, :wg] = bb.col_index
        masks[i, :, :wg] = bb.masks
    gid = torch.arange(g_n, dtype=torch.int32, device=dev).repeat_interleave(n_rows)
    row = torch.arange(n_rows, dtype=torch.int32, device=dev).repeat(g_n)
    return (
        col.reshape(g_n * n_rows, w_max),
        gid,
        row,
        masks.reshape(g_n * n_rows, w_max, b, b),
    )


def fused_fp_rows(batches: list[SemanticGraphBatch]) -> int:
    """Rows of the padded raw-feature table FUSED_FP streams: the src and dst
    block rows of the batches, whichever reach further."""
    b0 = batches[0]
    return max(b0.num_src_pad, b0.num_dst_pad)


def project_coefficients(
    x: torch.Tensor,      # [N, Din]
    w: torch.Tensor,      # [Din, H*Dh]
    a_src: torch.Tensor,  # [H, Dh]
    a_dst: torch.Tensor,  # [H, Dh]
    *,
    backend: NABackend = NABackend.SEGMENT,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """FP of one vertex table fused with its attention coefficients (paper
    Alg. 2 lines 7-8): ``(h [N, H, Dh], theta_src [N, H], theta_dst [N, H])``
    with h = x @ w and theta = <h, a> per head.

    KERNEL launches kernel #6 with a zero bias (no gradient); every other
    backend is the plain product and two einsums, differentiable by
    autograd."""
    heads = a_src.shape[0]
    if backend is NABackend.KERNEL:
        h, th_s, th_d = fused_fp_coeff(x.contiguous(), w.contiguous(), x.new_zeros(w.shape[1]),
                                       a_src.contiguous(), a_dst.contiguous())
        return h.reshape(x.shape[0], heads, -1), th_s, th_d
    h = (x @ w).reshape(x.shape[0], heads, -1)
    return h, torch.einsum("nhd,hd->nh", h, a_src), torch.einsum("nhd,hd->nh", h, a_dst)


def project_dst_coefficients(
    x: torch.Tensor,  # [N, Din]
    w: torch.Tensor,  # [Din, H*Dh]
    a: torch.Tensor,  # [H, Dh]
) -> torch.Tensor:
    """theta [N, H] of a side whose projection NA never reads (R-GAT's
    destination table): <x w, a> per head, taken as x @ v with v = <w, a>
    per head [Din, H], so no [N, H*Dh] table is made or kept for the
    backward.  Plain products, differentiable by autograd (``w`` and ``a``
    get their gradients through ``v``).

    Counter: ``project_dst_coefficients.calls``, one a call."""
    project_dst_coefficients.calls += 1
    v = torch.einsum("khd,hd->kh", w.reshape(w.shape[0], a.shape[0], -1), a)
    return x @ v


project_dst_coefficients.calls = 0


def neighbor_aggregate(
    batch: SemanticGraphBatch,
    theta_src: torch.Tensor,  # [Ns, H]
    theta_dst: torch.Tensor,  # [Nd, H]
    h_src: torch.Tensor,      # [Ns, H, Dh]
    *,
    backend: NABackend = NABackend.SEGMENT,
    leaky_slope: float = 0.2,
    edge_bias: torch.Tensor | float = 0.0,
) -> torch.Tensor:
    """Attention NA of one semantic graph with the chosen backend.
    Returns [num_dst, H, Dh].

    MULTIGRAPH runs the graph alone through :func:`neighbor_aggregate_multi`
    (kernels #1/#2 at G = 1, differentiable); KERNEL launches kernel #5
    and has no gradient; SEGMENT and BLOCK are plain PyTorch.
    ``edge_bias`` is a number, a 0-d or an [H] tensor."""
    edge_bias = bias_vector(edge_bias, theta_src.shape[-1], h_src.device)
    if backend is NABackend.MULTIGRAPH:
        return neighbor_aggregate_multi(
            [batch], theta_src[None], theta_dst[None], h_src,
            backend=backend, leaky_slope=leaky_slope, edge_bias=edge_bias[None],
            topology=batch.topology,
        )[0]
    if backend is NABackend.SEGMENT:
        return stages.segment_softmax_aggregate(
            *batch.edges, theta_src, theta_dst, h_src,
            batch.num_dst, leaky_slope=leaky_slope, edge_bias=edge_bias,
        )
    if backend not in (NABackend.BLOCK, NABackend.KERNEL):
        raise ValueError(f"neighbor_aggregate takes one graph; {backend} runs through "
                         "neighbor_aggregate_multi")
    th_s = _pad_rows(theta_src, batch.num_src_pad)
    hs = _pad_rows(h_src, batch.num_src_pad)
    th_d = _pad_rows(theta_dst, batch.num_dst_pad)
    if backend is NABackend.BLOCK:
        out = stages.block_softmax_aggregate(
            batch.col_index, batch.masks, th_s, th_d, hs,
            leaky_slope=leaky_slope, edge_bias=edge_bias,
        )
    else:
        out = seg_gat_agg(
            batch.col_index, batch.masks, th_s.contiguous(), th_d.contiguous(),
            hs.contiguous(), leaky_slope=leaky_slope, edge_bias=edge_bias,
            topology=batch.topology,
        )
    return out[: batch.num_dst]


def neighbor_aggregate_multi(
    batches: list[SemanticGraphBatch],
    theta_src: torch.Tensor | None,  # [G, Ns, H]   (None with FUSED_FP)
    theta_dst: torch.Tensor | None,  # [G, Nd, H]   (None with FUSED_FP)
    h_src: torch.Tensor | None,      # [Ns, H, Dh]  (None with FUSED_FP)
    *,
    backend: NABackend = NABackend.MULTIGRAPH,
    leaky_slope: float = 0.2,
    edge_bias: torch.Tensor | None = None,  # [G, H]
    fp: FusedFPInputs | None = None,
    topology: Topology | None = None,
) -> torch.Tensor:
    """NA for ALL semantic graphs of a step at once.  Returns
    [G, num_dst, H, Dh].

    MULTIGRAPH and FUSED_FP are one kernel launch for the whole step
    (forward, and under autograd one backward launch); SEGMENT, BLOCK and
    KERNEL are a per-graph loop of :func:`neighbor_aggregate` with the same
    semantics (KERNEL: one launch of kernel #5 per graph).  With FUSED_FP,
    pass ``fp=FusedFPInputs(...)`` and leave theta_src/theta_dst/h_src as
    None.  ``topology`` (:func:`unit_topology` of these batches, or a
    batch's own ``topology`` at G = 1) may be passed so that a caller that
    runs many steps on one batch set checks and indexes its unit tables
    once; None builds it in the call.

    Spans (obs.trace, DESIGN.md §12): the multigraph backends emit one
    ``stage=NA`` span for the whole launch; the per-graph loop emits one
    ``na/<graph>`` span per semantic graph on its own ``sg/<graph>`` lane
    row.
    """
    if backend in (NABackend.SEGMENT, NABackend.BLOCK, NABackend.KERNEL):
        outs = []
        for i, bb in enumerate(batches):
            with trace_span(
                f"na/{bb.name}", stage="NA", lane=f"sg/{bb.name}",
                graph=bb.name, backend=backend.value, edges=bb.num_edges,
            ) as sp:
                z = neighbor_aggregate(
                    bb, theta_src[i], theta_dst[i], h_src[: bb.num_src],
                    backend=backend, leaky_slope=leaky_slope,
                    edge_bias=0.0 if edge_bias is None else edge_bias[i],
                )
                outs.append(sp.sync(z))
        return torch.stack(outs)

    b0 = batches[0]
    nd = b0.num_dst
    nd_pad = b0.num_dst_pad
    ns_pad = b0.num_src_pad
    g_n = len(batches)
    if backend not in (NABackend.FUSED_FP, NABackend.MULTIGRAPH):
        raise ValueError(f"unknown NA backend {backend}")
    if backend is NABackend.FUSED_FP:
        if fp is None:
            raise ValueError(
                "FUSED_FP takes fp=FusedFPInputs (raw features + weight tables) "
                "in place of theta_src/theta_dst/h_src"
            )
        if b0.num_src != b0.num_dst:
            raise ValueError(
                "fused FP+NA streams ONE raw-feature table for both src and dst "
                "tiles; src and dst must share the vertex space"
            )
    topology = unit_topology(batches) if topology is None else topology
    col, gid, row, masks = topology.units
    if backend is NABackend.FUSED_FP:
        x_pad = _pad_rows(fp.x, fused_fp_rows(batches)).contiguous()
        operands = (col, gid, row, fp.wsel, masks, x_pad, fp.w, fp.b, fp.a_src, fp.a_dst,
                    edge_bias)
        with trace_span(
            "na/fused_fp", stage="NA", backend=backend.value, graphs=g_n,
            units=int(col.shape[0]), fused_fp=True, graph_names=_graph_names(batches),
        ) as sp:
            # [G*R*B, H, Dh] — units are g-major, rows in order
            out = sp.sync(seg_gat_agg_fused_fp(*operands, leaky_slope=leaky_slope,
                                               topology=topology))
        return out.reshape(g_n, nd_pad, *out.shape[1:])[:, :nd]

    th_s = _pad_rows(theta_src.transpose(0, 1), ns_pad).transpose(0, 1).contiguous()
    th_d = _pad_rows(theta_dst.transpose(0, 1), nd_pad).transpose(0, 1).contiguous()
    hs = _pad_rows(h_src, ns_pad).contiguous()
    operands = (col, gid, row, masks, th_s, th_d, hs, edge_bias)
    with trace_span(
        "na/multigraph", stage="NA", backend=backend.value, graphs=g_n,
        units=int(col.shape[0]), graph_names=_graph_names(batches),
    ) as sp:
        # [G*R*B, H, Dh] — units are g-major, rows in order
        out = sp.sync(seg_gat_agg_multigraph(*operands, leaky_slope=leaky_slope,
                                             topology=topology))
    return out.reshape(g_n, nd_pad, *out.shape[1:])[:, :nd]


def mean_aggregate(batch: SemanticGraphBatch, h_src: torch.Tensor) -> torch.Tensor:
    """Mean NA (R-GCN) over the batch's edge list.  Returns [num_dst, ...]."""
    return stages.segment_mean_aggregate(*batch.edges, h_src, batch.num_dst)


# -- NA over every relation at once (Simple-HGN) ------------------------------------


@dataclasses.dataclass
class JointGraph:
    """Every relation of a heterogeneous graph over ONE table of vertices,
    for NA with one softmax over all in-edges of a vertex, of every
    relation (Simple-HGN).  Type ``t``'s vertices are rows
    ``offsets[t] + [0, counts[t])`` of the table (``num_rows`` rows, each
    type's range padded to a multiple of ``block``); edge type
    ``edge_types[relation]`` picks each relation's attention bias (several
    relations may share one: HGB's self-loops).  Work units are the dst
    blocks of the table, each holding the slots of every relation into it,
    ragged (``kernels.topology.joint_index``)."""

    types: tuple[str, ...]
    counts: dict[str, int]
    offsets: dict[str, int]
    num_rows: int
    block: int
    edge_types: dict[str, int]
    num_edges: int
    unit_off: torch.Tensor  # int32 [num_rows / block + 1]
    slot_col: torch.Tensor  # int32 [S]
    slot_rel: torch.Tensor  # int32 [S]
    masks: torch.Tensor     # bool  [S, B, B]
    _indexes: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)

    @property
    def num_edge_types(self) -> int:
        return max(self.edge_types.values()) + 1

    @property
    def num_units(self) -> int:
        return self.num_rows // self.block

    def units_of(self, vtype: str) -> int:
        """The units that cover ``vtype``, which must come first in the
        table (its blocks are then a prefix of the units)."""
        if self.offsets[vtype] != 0:
            raise ValueError(f"{vtype!r} is not the table's first type")
        return -(-self.counts[vtype] // self.block)

    def index(self, n_units: int) -> dict:
        """The joint NA's topology index of units [0, n_units), checked and
        built the first time it is asked for, then kept and held to the
        graph's tables (``kernels.topology.hold``)."""
        tables = (self.unit_off, self.slot_col, self.slot_rel, self.masks)
        if n_units not in self._indexes:
            with trace_span("setup/joint_index", units=n_units):
                self._indexes[n_units] = joint_index(*tables, n_units, self.num_rows,
                                                     self.num_edge_types)
        index = self._indexes[n_units]
        hold("joint index", index["held"], dict(zip(JOINT_TABLES, tables)))
        return index


def build_joint_graph(g: HetGraph, edge_types: dict[str, int], *, block: int = 8,
                      device: str | torch.device = "cpu") -> JointGraph:
    """The :class:`JointGraph` of every relation of ``g`` (the vertex
    types in ``g``'s order), built on ``device``: a slot per distinct (dst
    block, edge type, src block), sorted in that order."""
    dev = torch.device(device)
    types = tuple(g.vertex_counts)
    counts = {t: int(n) for t, n in g.vertex_counts.items()}
    offsets, at = {}, 0
    for t in types:
        offsets[t] = at
        at += -(-counts[t] // block) * block
    n_blocks = at // block
    with trace_span("setup/joint_graph", relations=len(g.relations)):
        src, dst, rel = [], [], []
        for name, r in g.relations.items():
            src.append(torch.as_tensor(r.src_ids, device=dev).long() + offsets[r.src_type])
            dst.append(torch.as_tensor(r.dst_ids, device=dev).long() + offsets[r.dst_type])
            rel.append(torch.full_like(src[-1], edge_types[name]))
        src, dst, rel = torch.cat(src), torch.cat(dst), torch.cat(rel)
        n_types = max(edge_types.values()) + 1
        key = (dst // block * n_types + rel) * n_blocks + src // block
        uniq, inv = torch.unique(key, return_inverse=True)
        unit_off = torch.zeros(n_blocks + 1, dtype=torch.long, device=dev)
        unit_off[1:] = torch.cumsum(torch.bincount(uniq // (n_types * n_blocks),
                                                   minlength=n_blocks), 0)
        masks = torch.zeros((uniq.numel(), block, block), dtype=torch.bool, device=dev)
        masks[inv, dst % block, src % block] = True
    return JointGraph(
        types=types, counts=counts, offsets=offsets, num_rows=at, block=block,
        edge_types=dict(edge_types), num_edges=int(src.numel()),
        unit_off=unit_off.int(), slot_col=(uniq % n_blocks).int(),
        slot_rel=(uniq // n_blocks % n_types).int(), masks=masks)


def neighbor_aggregate_joint(
    jg: JointGraph,
    theta_src: torch.Tensor,  # [num_rows, H]
    theta_dst: torch.Tensor,  # [num_rows, H]
    h_src: torch.Tensor,      # [num_rows, H, Dh]
    edge_bias: torch.Tensor,  # [num_edge_types, H]
    *,
    n_units: int | None = None,
    priors: JointPriors | None = None,
    beta: float = 0.0,
    backend: NABackend = NABackend.MULTIGRAPH,
    leaky_slope: float = 0.2,
) -> tuple[torch.Tensor, torch.Tensor]:
    """NA with one softmax over every in-edge of each dst row of units
    [0, ``n_units``) (all units by default), of every relation, and the
    prior layers' attention mixed in by ``beta`` (Simple-HGN's residual
    attention).  Returns (out [n_units·B, H, Dh], lse [n_units·B, H]).

    MULTIGRAPH only: the joint instantiations of kernels #1/#2 on the card,
    their plain versions on the CPU; one launch a call, and under autograd
    one backward launch.  Span: ``na/joint``."""
    if backend is not NABackend.MULTIGRAPH:
        raise ValueError(f"the joint NA runs on MULTIGRAPH, not {backend}")
    n_units = jg.num_units if n_units is None else n_units
    index = jg.index(n_units)
    with trace_span("na/joint", stage="NA", backend=backend.value, units=n_units,
                    edges=index["E"], priors=0 if priors is None else priors.K) as sp:
        out, lse = seg_gat_agg_multigraph_joint(index, theta_src, theta_dst, h_src, edge_bias,
                                                priors, beta=beta, leaky_slope=leaky_slope)
        return sp.sync(out), lse
