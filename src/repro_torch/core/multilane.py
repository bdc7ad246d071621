"""Independency-aware parallel execution (paper §4.2) — multi-lane NA, the
counterpart of ``repro.core.multilane``.

Work units are (semantic graph, dst-block row) pairs: each dst vertex
lives in exactly one unit, so units are independent until the GSF
barrier, the independency the paper exploits.  Units are assigned to lanes
by the workload-aware scheduler (``scheduling.lane_assignment``); on one
card the lanes run as one launch over all their units in lane-major order,
and across cards the lane axis is split over a ``torch.distributed`` lane
group (:func:`multilane_na_sharded`): "adding hardware resources to further
improve performance" (paper §4.2.1) becomes adding ranks to the lane group.

The plan holds the reference's tables ([L, U, W] columns, [L, U, W, B, B]
masks, [L, U] graph, row and valid) on the host, lanes padded with dead
units (graph 0, row 0, every slot -1).  The kernels read only the valid
units, flattened in lane order and moved to the device
(:meth:`MultiLanePlan.units`): a dead unit would add its zero
to d_theta_dst[0, 0:B] through #2's (graph, dst block) sums and take a key
in #4's table CSR.  Each unit's output rows are placed into the
``[G, Nd_pad, H, Dh]`` result by a gather with a host-built index whose
backward is the gather by the inverse permutation: deterministic in both
directions, no atomics.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from ..kernels.seg_gat_agg_fused_fp import seg_gat_agg_fused_fp
from ..kernels.seg_gat_agg_multigraph import seg_gat_agg_multigraph, unit_softmax_aggregate
from ..kernels.topology import Topology
from ..obs.trace import trace_span
from .fusion import FusedFPInputs, SemanticGraphBatch, _pad_rows
from .scheduling import LanePlan, lane_assignment, naive_lane_assignment

MULTILANE_BACKENDS = ("reference", "kernel", "kernel_interpret", "fused_fp", "fused_fp_interpret")

# the reference's interpreter spellings: the port has no interpreter, the
# tensor's device picks the code (CUDA: the kernels; CPU: their plain versions)
_SPELLINGS = {"kernel_interpret": "kernel", "fused_fp_interpret": "fused_fp"}


def resolve_multilane_backend(backend: str) -> str:
    """The port's name of a multilane backend: ``kernel_interpret`` and
    ``fused_fp_interpret`` are spellings of ``kernel`` and ``fused_fp``.
    Nothing is degraded: on a CUDA tensor the kernels run or raise."""
    if backend not in MULTILANE_BACKENDS:
        raise ValueError(f"backend={backend!r}, expected one of {MULTILANE_BACKENDS}")
    return _SPELLINGS.get(backend, backend)


@dataclasses.dataclass
class LaneUnits:
    """The valid units of a block of lanes, flattened in lane-major order
    as the kernels read them, with their checked topology (built at first
    use, then kept) and where each unit's rows land."""

    col_index: torch.Tensor  # int32 [n, W]
    graph_id: torch.Tensor   # int32 [n]
    dst_row: torch.Tensor    # int32 [n]
    masks: torch.Tensor      # bool  [n, W, B, B]
    place: torch.Tensor      # int64 [G·R]: the unit of (g, r), n where another block holds it
    take: torch.Tensor       # int64 [n]: g·R + r of each unit (place's inverse)
    _topologies: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)

    @property
    def count(self) -> int:
        return int(self.col_index.shape[0])

    def topology(self, n_graphs: int, ns_pad: int, nd_pad: int) -> Topology:
        """The ``Topology`` of these units at these extents, which the
        kernels of both directions take: built (checked) the first time,
        then kept with the indexes the kernels build on it."""
        key = (n_graphs, ns_pad, nd_pad)
        if key not in self._topologies:
            self._topologies[key] = Topology(self.col_index, self.graph_id, self.dst_row,
                                             self.masks, n_graphs=n_graphs, ns_pad=ns_pad,
                                             nd_pad=nd_pad)
        return self._topologies[key]

    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for t in
                   (self.col_index, self.graph_id, self.dst_row, self.masks, self.place, self.take))


@dataclasses.dataclass
class MultiLanePlan:
    """Static multi-lane execution plan.

    Shapes: L lanes × U units/lane (padded) × W block slots × B×B masks.
    The padded tables are host arrays (the reference's, byte for byte);
    what the kernels read is on ``device``: :meth:`units`.
    """

    col_index: np.ndarray  # int32 [L, U, W]
    masks: np.ndarray      # bool  [L, U, W, B, B]
    graph_id: np.ndarray   # int32 [L, U]
    dst_row: np.ndarray    # int32 [L, U]
    valid: np.ndarray      # bool  [L, U]
    block: int
    num_graphs: int
    n_dst_blocks: int        # per graph (shared dst space)
    lane_plan: LanePlan | None  # host-side scheduling metadata
    device: torch.device
    _units: dict = dataclasses.field(default_factory=dict, repr=False, compare=False)

    @property
    def num_lanes(self) -> int:
        return int(self.col_index.shape[0])

    def nbytes(self) -> int:
        """Host bytes of the plan's padded [L, U, ...] tables."""
        return sum(a.nbytes for a in
                   (self.col_index, self.masks, self.graph_id, self.dst_row, self.valid))

    def units(self, lanes: tuple[int, int] | None = None) -> LaneUnits:
        """The valid units of lanes ``[l0, l1)`` (all lanes when None) in
        lane-major order, on the plan's device: built the first time, then
        kept on the plan, so that no step rebuilds them or their
        topology."""
        l0, l1 = (0, self.num_lanes) if lanes is None else lanes
        if not 0 <= l0 <= l1 <= self.num_lanes:
            raise ValueError(f"lanes [{l0}, {l1}) outside the plan's {self.num_lanes}")
        if (l0, l1) not in self._units:
            valid = self.valid[l0:l1].reshape(-1)  # leave out the dead units
            col, gid, row, masks = (a[l0:l1].reshape(-1, *a.shape[2:])[valid] for a in
                                    (self.col_index, self.graph_id, self.dst_row, self.masks))
            n = col.shape[0]
            take = gid.astype(np.int64) * self.n_dst_blocks + row
            place = np.full(self.num_graphs * self.n_dst_blocks, n, np.int64)
            place[take] = np.arange(n)
            self._units[(l0, l1)] = LaneUnits(*(torch.from_numpy(a).to(self.device) for a in
                                                (col, gid, row, masks, place, take)))
        return self._units[(l0, l1)]


def build_multilane_plan(
    batches: list[SemanticGraphBatch],
    num_lanes: int,
    *,
    balanced: bool = True,
) -> MultiLanePlan:
    """Partition the block rows of all semantic graphs onto lanes.

    Requires all graphs to share the dst/src vertex space (HAN's metapath
    graphs do); col widths are padded to the max across graphs.  The
    tables are built on the host from CPU copies of the batches; the
    kernels' unit tables go to the batches' device (:meth:`MultiLanePlan.units`)."""
    if not batches:
        raise ValueError("no semantic graphs")
    b = batches[0].block
    n_rows = int(batches[0].col_index.shape[0])
    for bb in batches:
        if bb.block != b or int(bb.col_index.shape[0]) != n_rows:
            raise ValueError("semantic graphs must share the block size and dst vertex space")

    row_costs = [bb.row_edge_counts() for bb in batches]
    plan = (
        lane_assignment(row_costs, num_lanes)
        if balanced
        else naive_lane_assignment(row_costs, num_lanes)
    )

    # unit u goes to slot `slot[u]` of its lane, in unit order within the lane
    slot = np.zeros(plan.unit_graph.shape[0], np.int64)
    for lane in range(num_lanes):
        on_lane = np.nonzero(plan.unit_lane == lane)[0]
        slot[on_lane] = np.arange(on_lane.size)
    u_max = max(1, int(np.bincount(plan.unit_lane, minlength=num_lanes).max(initial=0)))
    w_max = max(int(bb.col_index.shape[1]) for bb in batches)

    col = np.full((num_lanes, u_max, w_max), -1, np.int32)
    masks = np.zeros((num_lanes, u_max, w_max, b, b), bool)
    gid = np.zeros((num_lanes, u_max), np.int32)
    drow = np.zeros((num_lanes, u_max), np.int32)
    valid = np.zeros((num_lanes, u_max), bool)
    for g, bb in enumerate(batches):
        on_g = plan.unit_graph == g
        lane, j, r = plan.unit_lane[on_g], slot[on_g], plan.unit_row[on_g]
        wg = int(bb.col_index.shape[1])
        col[lane, j, :wg] = bb.col_index.cpu().numpy()[r]
        masks[lane, j, :wg] = bb.masks.cpu().numpy()[r]
        gid[lane, j] = g
        drow[lane, j] = r
        valid[lane, j] = True
    return MultiLanePlan(
        col_index=col,
        masks=masks,
        graph_id=gid,
        dst_row=drow,
        valid=valid,
        block=b,
        num_graphs=len(batches),
        n_dst_blocks=n_rows,
        lane_plan=plan,
        device=batches[0].col_index.device,
    )


class _PlaceUnits(torch.autograd.Function):
    """Unit rows ``[n, K]`` → ``[G·R, K]``: row j is unit ``place[j]``'s,
    zeros where ``place[j] == n`` (a unit of another lane block).  The
    backward gathers by ``take``, the inverse permutation: both directions
    are gathers, with no accumulation."""

    @staticmethod
    def forward(ctx, rows, place, take):
        ctx.save_for_backward(take)
        if take.numel() < place.numel():
            rows = torch.cat([rows, rows.new_zeros((1, rows.shape[1]))])
        return rows.index_select(0, place)

    @staticmethod
    def backward(ctx, grad):
        (take,) = ctx.saved_tensors
        return grad.index_select(0, take), None, None


def multilane_na(
    plan: MultiLanePlan,
    theta_src: torch.Tensor | None,  # [G, Ns_pad, H]   (None with fused_fp)
    theta_dst: torch.Tensor | None,  # [G, Nd_pad, H]   (None with fused_fp)
    h_src: torch.Tensor | None,      # [Ns_pad, H, Dh]  (None with fused_fp)
    *,
    edge_bias: torch.Tensor | None = None,  # [G, H]
    leaky_slope: float = 0.2,
    backend: str = "reference",
    fp: FusedFPInputs | None = None,
    lanes: tuple[int, int] | None = None,
) -> torch.Tensor:
    """Run NA for all semantic graphs across lanes.

    Returns z [G, Nd_pad, H, Dh] (``Nd_pad = n_dst_blocks · block``).

    ``backend`` selects the executor of the plan's valid units, taken in
    lane-major order:
      * ``"reference"`` — the plain per-unit softmax
        (``kernels.seg_gat_agg_multigraph.unit_softmax_aggregate``),
        differentiable by autograd;
      * ``"kernel"`` — ONE ``seg_gat_agg_multigraph`` call over all the
        units: kernel #1 forward and, under autograd, one #2 launch
        backward, on the units' topology kept on the plan;
      * ``"fused_fp"`` — ONE ``seg_gat_agg_fused_fp`` call (#3, and #4
        under autograd): pass ``fp=FusedFPInputs`` (raw features, padded
        here to the plan's rows, and the projection/attention params) and
        leave the theta/h operands None; on the units' topology kept on
        the plan;
      * ``"kernel_interpret"`` / ``"fused_fp_interpret"`` — spellings of
        the two above (:func:`resolve_multilane_backend`).
    On CUDA tensors the kernels launch; on CPU tensors their wrappers run
    the plain versions.  ``lanes=(l0, l1)`` runs only those lanes' units
    and leaves the other rows zero (:func:`multilane_na_sharded`).
    Every unit is computed alone, so the output is the same for any lane
    count and order.
    """
    backend = resolve_multilane_backend(backend)
    if backend == "fused_fp":
        if fp is None:
            raise ValueError("backend='fused_fp' needs fp=FusedFPInputs")
        g_n, h_dim, dh = fp.a_src.shape
        dev = fp.x.device
    else:
        g_n, _, h_dim = theta_src.shape
        dh = h_src.shape[-1]
        dev = h_src.device
    if g_n != plan.num_graphs:
        raise ValueError(f"operands have {g_n} graphs, the plan {plan.num_graphs}")
    if edge_bias is None:
        edge_bias = torch.zeros((g_n, h_dim), dtype=torch.float32, device=dev)

    B = plan.block
    lu = plan.units(lanes)
    with trace_span(
        "na/multilane", stage="NA", backend=backend, lanes=plan.num_lanes,
        units=int(plan.col_index.shape[1]), graphs=g_n,
    ) as sp:
        if lu.count == 0:  # lanes with no unit (a naive plan's idle lanes)
            flat = torch.zeros((0, h_dim, dh), dtype=torch.float32, device=dev)
        elif backend == "reference":
            flat, _ = unit_softmax_aggregate(
                lu.col_index, lu.graph_id, lu.dst_row, lu.masks, theta_src, theta_dst,
                h_src[None], torch.zeros(g_n, dtype=torch.long, device=dev), edge_bias,
                leaky_slope,
            )
        elif backend == "fused_fp":
            x = _pad_rows(fp.x, max(fp.x.shape[0], plan.n_dst_blocks * B)).contiguous()
            flat = seg_gat_agg_fused_fp(
                lu.col_index, lu.graph_id, lu.dst_row, fp.wsel, lu.masks, x, fp.w, fp.b,
                fp.a_src, fp.a_dst, edge_bias, leaky_slope=leaky_slope,
                topology=lu.topology(g_n, x.shape[0], x.shape[0]),
            )
        else:
            flat = seg_gat_agg_multigraph(
                lu.col_index, lu.graph_id, lu.dst_row, lu.masks, theta_src, theta_dst, h_src,
                edge_bias, leaky_slope=leaky_slope,
                topology=lu.topology(g_n, theta_src.shape[1], theta_dst.shape[1]),
            )  # [n·B, H, Dh]
        out = _PlaceUnits.apply(flat.reshape(lu.count, B * h_dim * dh), lu.place, lu.take)
        return sp.sync(out.reshape(g_n, plan.n_dst_blocks * B, h_dim, dh))


# -- the lane axis over a torch.distributed group -----------------------------


class _LaneSum(torch.autograd.Function):
    """All-reduce SUM of each rank's partial output over the lane group;
    the backward is the identity (every rank holds the same cotangent,
    since what follows runs replicated).  The replicated inputs ride along
    so that each of them gets a (zero) gradient here on every rank: a rank
    whose lanes hold no unit still reaches their all-reduce in
    :class:`_Replicated`'s backward."""

    @staticmethod
    def forward(ctx, partial, group, *replicated):
        ctx.shapes = [(r.shape, r.dtype, r.device) for r in replicated]
        out = partial.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
        return out

    @staticmethod
    def backward(ctx, grad):
        zeros = [torch.zeros(s, dtype=d, device=v) for s, d, v in ctx.shapes]
        return (grad, None, *zeros)


class _Replicated(torch.autograd.Function):
    """An input replicated over the lane group: identity forward; the
    backward all-reduces its gradient, so each rank ends with the sum over
    every rank's units (Megatron's conjugate of :class:`_LaneSum`)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, op=dist.ReduceOp.SUM, group=ctx.group)
        return grad, None


def lane_group(mesh, lane_axes: tuple[str, ...] = ("lane",)):
    """The calling rank's lane group on ``mesh``: the process group of the
    mesh dimension ``lane_axes`` names, or of those dimensions flattened,
    major first (``("pod", "lane")`` on a multi-pod mesh)."""
    if len(lane_axes) == 1:
        return mesh.get_group(lane_axes[0])
    return mesh[tuple(lane_axes)]._flatten().get_group()


def multilane_na_sharded(
    plan: MultiLanePlan,
    theta_src: torch.Tensor | None,  # [G, Ns_pad, H]   (None with fused_fp)
    theta_dst: torch.Tensor | None,  # [G, Nd_pad, H]   (None with fused_fp)
    h_src: torch.Tensor | None,      # [Ns_pad, H, Dh]  (None with fused_fp)
    *,
    mesh,
    lane_axes: tuple[str, ...] = ("lane",),
    edge_bias: torch.Tensor | None = None,  # [G, H]
    leaky_slope: float = 0.2,
    backend: str = "reference",
    fp: FusedFPInputs | None = None,
) -> torch.Tensor:
    """``multilane_na`` with the plan's lane axis split over the ``lane``
    dimension of a ``torch.distributed`` device mesh (``launch.mesh.make_lane_mesh``):
    on a (lane, model) mesh, the calling rank's lane group (its column of
    the mesh; one rank at a lane size of 1), so every model rank of a lane
    runs the same lanes.  ``lane_axes`` names the mesh dimensions the lanes
    ride (``dist.lane_axes(rules)``; :func:`lane_group`).

    Rank r of the lane group runs :func:`multilane_na` on its contiguous
    block of lanes against the replicated operands and leaves the other
    rows zero; an all-reduce SUM over the group combines the ranks, adding
    exact zeros, so the output equals the one-process result bit for bit.
    Autograd: the all-reduce's backward is the identity, and the
    replicated inputs (θs, θd and h, or ``fp``'s x, w, b, a_src and a_dst,
    and ``edge_bias``) pass through an identity whose backward all-reduces their gradient.
    The plan's lane count must be a multiple of the group size."""
    group = lane_group(mesh, lane_axes)
    n_shards = dist.get_world_size(group)
    if plan.num_lanes % n_shards:
        raise ValueError(f"the plan's {plan.num_lanes} lanes do not split over {n_shards} ranks")
    per = plan.num_lanes // n_shards
    rank = dist.get_rank(group)
    lanes = (rank * per, (rank + 1) * per)
    backend = resolve_multilane_backend(backend)

    def rep(t):
        return _Replicated.apply(t, group) if t is not None and t.requires_grad else t

    if backend == "fused_fp":
        if fp is None:
            raise ValueError("backend='fused_fp' needs fp=FusedFPInputs")
        g_n = fp.a_src.shape[0]
        fp = dataclasses.replace(fp, x=rep(fp.x), w=rep(fp.w), b=rep(fp.b),
                                 a_src=rep(fp.a_src), a_dst=rep(fp.a_dst))
        tied = [t for t in (fp.x, fp.w, fp.b, fp.a_src, fp.a_dst) if t.requires_grad]
    else:
        g_n = theta_src.shape[0]
        theta_src, theta_dst, h_src = rep(theta_src), rep(theta_dst), rep(h_src)
        tied = [t for t in (theta_src, theta_dst, h_src) if t.requires_grad]
    edge_bias = rep(edge_bias)
    if edge_bias is not None and edge_bias.requires_grad:
        tied.append(edge_bias)
    with trace_span(
        "na/multilane_sharded", stage="NA", backend=backend, shards=n_shards,
        lanes=plan.num_lanes, graphs=g_n, fused_fp=backend == "fused_fp",
    ) as sp:
        partial = multilane_na(plan, theta_src, theta_dst, h_src, edge_bias=edge_bias,
                               leaky_slope=leaky_slope, backend=backend, fp=fp, lanes=lanes)
        return sp.sync(_LaneSum.apply(partial, group, *tied))
