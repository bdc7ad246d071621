"""Production-scale dry run of the paper's own technique, the counterpart of
``repro.launch.hgnn_dryrun``: multi-lane HGNN NA + LSF + GSF with the lanes
split over the ``lane`` dimension of the production mesh (one lane group a
mesh column: the accelerator's scale-up, paper §4.2, mapped onto a pod).

    PYTHONPATH=src python -m repro_torch.launch.hgnn_dryrun --vertices 65536
    PYTHONPATH=src python -m repro_torch.launch.hgnn_dryrun --schedule aligned --multi-pod

It needs no card.  One process brings up a ``fake`` process group of the
production mesh's 256 ranks (512 with ``--multi-pod``; ``launch.mesh.
make_lane_mesh`` with no sizes) and, under ``FakeTensorMode``, runs rank
0's program on fake tensors of the real shapes and dtypes, which hold no
data (fake CPU tensors: indexing a fake ``cuda`` tensor needs a CUDA
build of torch, which a host with no card may not have): rank 0's work
units (built directly at their shapes, every unit valid, as the
reference's ``abstract_plan``: the whole plan's host tables would take
6.4 GB of masks at the default size), the θs, h and the HAN
semantic-attention params.  ``launch.opstats`` counts its products' FLOPs
and its collectives' bytes, ``MemTracker`` its peak memory:

* ``--schedule balanced``: ``core.multilane.multilane_na_sharded`` over
  the lane group (one all-reduce of the output), then the LSF + GSF tail;
* ``--schedule aligned``: the port of the reference's
  ``aligned_lane_step_builder``: all graphs of a dst row on one lane, a
  lane-local GSF, one all-reduce of the G partial importances.

Departures, recorded in ROADMAP Queue 3: ``--executor spmd`` names XLA's
partitioner, which eager PyTorch has not, so both executors run the
explicit lane-group executor (``executor`` in the output says
``shard_map``); the kernel backends (``kernel``, ``fused_fp`` and their
``_interpret`` spellings, which the port reads as the same) raise
``SystemExit``: the kernels launch only on real CUDA tensors (on the dry
run's fake ones the wrappers would run their plain versions and count
those), as the reference's compile only for a TPU.  The rooflines use
the H100 SXM data sheet (989 TFLOP/s bf16, 3.35 TB/s; NVLink 4 at 450
GB/s a direction); a 16-wide mesh axis spans two 8-card nodes, so
``collective_s`` is a lower bound.
"""
from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch
import torch.distributed as dist

from ..core import stages
from ..core.multilane import LaneUnits, MultiLanePlan, lane_group, multilane_na_sharded
from ..dist.sharding import lane_axes, make_rules
from ..kernels.seg_gat_agg_multigraph import unit_softmax_aggregate
from ..obs import disable_tracing, enable_tracing, trace_span
from .mesh import make_lane_mesh
from .opstats import analyze, span_attrs

PEAK_FLOPS = 989e12     # H100 SXM, dense bf16
PEAK_HBM_BYTES = 3.35e12
LINK_BYTES_S = 450e9    # NVLink 4, one direction
CARD = "NVIDIA H100 80GB HBM3 (SXM, data sheet), 700 W"
NODE_CARDS = 8
BLOCK = 128
KERNEL_BACKENDS = ("kernel", "kernel_interpret", "fused_fp", "fused_fp_interpret")


def abstract_units(n: int, w: int, block: int, graphs: int, rows: int) -> LaneUnits:
    """A rank's ``n`` work units as empty tensors of their shapes (fake ones
    under ``FakeTensorMode``): columns, graphs, rows and masks, and where
    their rows land in the ``[G·R]`` output (``place``, ``take``)."""
    def empty(shape, dtype):
        return torch.empty(shape, dtype=dtype)

    return LaneUnits(col_index=empty((n, w), torch.int32), graph_id=empty((n,), torch.int32),
                     dst_row=empty((n,), torch.int32),
                     masks=empty((n, w, block, block), torch.bool),
                     place=empty((graphs * rows,), torch.int64), take=empty((n,), torch.int64))


def abstract_plan(lanes: int, units: int, w: int, block: int, graphs: int, rows: int,
                  rank_lanes: tuple[int, int]) -> MultiLanePlan:
    """The reference's ``abstract_plan``: a plan of ``lanes`` × ``units`` valid
    units whose host tables are zero-stride views (their shapes, no bytes),
    holding the units of ``rank_lanes`` (the calling rank's block of lanes)
    as :func:`abstract_units`."""
    def host(shape, dtype):
        return np.broadcast_to(np.zeros((), dtype), shape)

    plan = MultiLanePlan(
        col_index=host((lanes, units, w), np.int32),
        masks=host((lanes, units, w, block, block), np.bool_),
        graph_id=host((lanes, units), np.int32), dst_row=host((lanes, units), np.int32),
        valid=host((lanes, units), np.bool_), block=block, num_graphs=graphs,
        n_dst_blocks=rows, lane_plan=None, device=torch.device("cpu"))
    n = (rank_lanes[1] - rank_lanes[0]) * units
    plan._units[rank_lanes] = abstract_units(n, w, block, graphs, rows)
    return plan


def sf_tail(z: torch.Tensor, w_g: torch.Tensor, q: torch.Tensor):
    """LSF per graph, then GSF, over the whole (replicated) NA output
    ``z [G, N, H, Dh]`` (the reference's ``_sf_tail``)."""
    g, n = z.shape[:2]
    zf = z.reshape(g, n, -1)
    valid = torch.ones((n,), dtype=torch.bool, device=z.device)
    b_g = torch.zeros((w_g.shape[1],), dtype=w_g.dtype, device=z.device)
    w_p = torch.stack([stages.local_semantic_fusion(zf[p], w_g, b_g, q, valid)
                       for p in range(g)])
    return stages.global_semantic_fusion(w_p, zf)


def aligned_lane_step(col_index, masks, row_ids, th_s, th_d, h_src, w_g, q, *, group,
                      ns_pad: int):
    """The reference's ``aligned_lane_step_builder`` step on this rank's lanes:
    all G graphs of a dst row on one lane (``col_index [L, U_r, G, W]``,
    ``masks [L, U_r, G, W, B, B]``, ``row_ids [L, U_r]``), the NA of every
    (row, graph) unit, the LSF partial importances summed on the lane and
    all-reduced over the lane group (only the G scalars cross lanes), and
    the GSF combine lane-local.  Returns (fused [L, U_r, B, H·Dh], beta [G])."""
    lanes, ur, g, w = col_index.shape
    block = masks.shape[-1]
    h_dim, dh = h_src.shape[-2:]
    n = lanes * ur * g
    gid = torch.arange(g, dtype=torch.int32, device=h_src.device).repeat(lanes * ur)
    row = row_ids.reshape(-1).repeat_interleave(g)
    bias = torch.zeros((g, h_dim), dtype=torch.float32, device=h_src.device)
    z, _ = unit_softmax_aggregate(col_index.reshape(n, w), gid, row,
                                  masks.reshape(n, w, block, block), th_s, th_d,
                                  h_src.float()[None],
                                  torch.zeros(g, dtype=torch.long, device=h_src.device), bias,
                                  0.2)
    zf = z.reshape(lanes, ur, g, block, h_dim * dh)
    s = torch.tanh(zf @ w_g) @ q  # [L, U_r, G, B]
    partial = s.sum(dim=(0, 1, 3))
    dist.all_reduce(partial, op=dist.ReduceOp.SUM, group=group)
    beta = torch.softmax(partial / ns_pad, dim=0)
    fused = torch.einsum("g,lugbd->lubd", beta, zf)  # lane-local GSF
    return fused, beta


def parse_args(argv: list[str] | None = None
               ) -> tuple[argparse.ArgumentParser, argparse.Namespace]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--vertices", type=int, default=1_048_576)
    ap.add_argument("--graphs", type=int, default=3)
    ap.add_argument("--heads", type=int, default=8)
    ap.add_argument("--dh", type=int, default=64)
    ap.add_argument("--width", type=int, default=16, help="blocks per row")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--schedule", choices=("balanced", "aligned"), default="balanced")
    ap.add_argument(
        "--executor", choices=("spmd", "shard_map"), default="spmd",
        help="balanced schedule only: the reference's partitioner-placed or explicit "
             "executor; the port has no partitioner and runs the explicit lane-group "
             "executor for both")
    ap.add_argument(
        "--na-backend", choices=("reference",) + KERNEL_BACKENDS, default="reference",
        help="balanced schedule only: the per-unit NA executor; the kernel backends launch "
             "only on real CUDA tensors and are refused here")
    ap.add_argument("--din", type=int, default=256,
                    help="fused_fp backends only: raw feature width (refused with them)")
    ap.add_argument("--out", default="artifacts/dryrun/hgnn_multilane.json")
    ap.add_argument(
        "--trace", default=None, metavar="PATH",
        help="write a Chrome-trace JSON of the dry run (the run's span carries the "
             "opstats collective-bytes and dot-FLOP attributes)")
    return ap, ap.parse_args(argv)


def run(args: argparse.Namespace) -> dict:
    """Rank 0's program under ``FakeTensorMode`` over a fake process group of
    the production mesh's ranks; the result dict (the reference's keys)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed._tools.mem_tracker import MemTracker
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if args.na_backend in KERNEL_BACKENDS:
        raise SystemExit(
            f"--na-backend {args.na_backend}: the kernels launch only on real CUDA tensors, "
            f"and a dry run holds fake ones (the reference's compile likewise needs a TPU); "
            f"use --na-backend reference")
    if dist.is_initialized():
        raise RuntimeError("the dry run brings up its own fake process group; one is "
                           "initialised already")
    lanes = 32 * 16 if args.multi_pod else 16 * 16  # one lane per chip
    rows = args.vertices // BLOCK
    g, h_dim, dh, w = args.graphs, args.heads, args.dh, args.width
    ns_pad = rows * BLOCK
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=lanes)
    try:
        mesh = make_lane_mesh(multi_pod=args.multi_pod, device_type="cpu")
        axes = lane_axes(make_rules(multi_pod=args.multi_pod, parallelism="lanes"))
        group = lane_group(mesh, axes)
        shards = dist.get_world_size(group)
        per = lanes // shards  # rank 0's lanes: [0, per)
        with FakeTensorMode():
            def fake(shape, dtype=torch.float32):
                return torch.empty(shape, dtype=dtype)

            th_s, th_d = fake((g, ns_pad, h_dim)), fake((g, rows * BLOCK, h_dim))
            h_src = fake((ns_pad, h_dim, dh), torch.bfloat16)
            w_g, q = fake((h_dim * dh, 128)), fake((128,))  # HAN's semantic attention
            if args.schedule == "aligned":
                units = rows // lanes
                inputs = (fake((per, units, g, w), torch.int32),
                          fake((per, units, g, w, BLOCK, BLOCK), torch.bool),
                          fake((per, units), torch.int32), th_s, th_d, h_src, w_g, q)

                def program():
                    return aligned_lane_step(*inputs, group=group, ns_pad=ns_pad)
            else:
                units = rows * g // lanes
                plan = abstract_plan(lanes, units, w, BLOCK, g, rows, (0, per))
                lu = plan.units((0, per))
                inputs = (lu.col_index, lu.graph_id, lu.dst_row, lu.masks, lu.place, lu.take,
                          th_s, th_d, h_src, w_g, q)

                def program():
                    z = multilane_na_sharded(plan, th_s, th_d, h_src.float(), mesh=mesh,
                                             lane_axes=axes, backend=args.na_backend)
                    return sf_tail(z, w_g, q)

            arg_bytes = sum(t.numel() * t.element_size() for t in inputs)
            tracker = MemTracker()
            with trace_span("dryrun/run", stage="run", schedule=args.schedule,
                            executor="shard_map", backend=args.na_backend, lanes=lanes) as sp:
                with tracker:
                    stats = analyze(program)
                sp.annotate(**span_attrs(stats, schedule=args.schedule))
            peak = sum(v["Total"] for v in tracker.get_tracker_snapshot("peak").values())
    finally:
        dist.destroy_process_group()
    flops = stats.dot_flops
    return dict(
        status="ok",
        schedule=args.schedule,
        executor="shard_map",  # the explicit lane-group executor, for --executor spmd too
        mesh="pod2x16x16" if args.multi_pod else "pod16x16",
        lanes=lanes, units_per_lane=units, vertices=args.vertices, graphs=g,
        mem_per_device_gib=(arg_bytes + peak) / 2**30,
        dot_flops_per_device=flops,
        collective_bytes=stats.collective_bytes,
        compute_s=flops / PEAK_FLOPS,
        collective_s=stats.total_collective_bytes / LINK_BYTES_S,
        dense_block_positions=lanes * units * w * BLOCK * BLOCK,
        collective_count=stats.collective_count,
        lane_group=shards,
    )


def main(argv: list[str] | None = None) -> dict:
    ap, args = parse_args(argv)
    if args.schedule == "aligned" and args.executor != "spmd":
        ap.error("--executor shard_map only applies to --schedule balanced")
    if args.schedule == "aligned" and args.na_backend != "reference":
        ap.error("--na-backend only applies to --schedule balanced")
    tracer = enable_tracing(sync=False) if args.trace else None  # nothing to synchronise
    try:
        result = run(args)
    finally:
        if tracer is not None:
            tracer.export_chrome_trace(args.trace)
            disable_tracing()
    print(f"[hgnn_dryrun] shape-only counts of rank 0's program on fake tensors, not card "
          f"times; rooflines for {CARD}: {PEAK_FLOPS:.3g} FLOP/s bf16, {PEAK_HBM_BYTES:.3g} B/s "
          f"HBM, {LINK_BYTES_S:.3g} B/s a link direction (NVLink 4); the {result['lane_group']}-"
          f"rank lane group spans {max(1, result['lane_group'] // NODE_CARDS)} {NODE_CARDS}-card "
          f"nodes, so collective_s is a lower bound")
    if args.executor == "spmd":
        print("[hgnn_dryrun] --executor spmd: eager PyTorch has no SPMD partitioner; the "
              "explicit lane-group executor ran (multilane_na_sharded)")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(result, f, indent=1)
    print(json.dumps(result, indent=1))
    if args.trace:
        print(f"wrote {args.trace}")
    return result


if __name__ == "__main__":
    main()
