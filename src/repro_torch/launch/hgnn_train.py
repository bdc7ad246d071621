"""HGNN training launcher of the port: HAN or R-GAT, on one card or over a
lane group of ranks, and Simple-HGN on one card.

    PYTHONPATH=src python -m repro_torch.launch.hgnn_train --dataset imdb \\
        --scale 1.0 --feat-scale 1.0 --hidden 64 --heads 8 --plan-lanes 16
    PYTHONPATH=src python -m repro_torch.launch.hgnn_train --model R-GAT \\
        --dataset imdb --scale 1.0 --feat-scale 1.0 --hidden 64 --heads 4 --steps 20
    PYTHONPATH=src python -m repro_torch.launch.hgnn_train --device cpu --steps 5 --plan-lanes 4
    PYTHONPATH=src python -m repro_torch.launch.hgnn_train --model Simple-HGN --block 8 \
        --dataset imdb --scale 1.0 --feat-scale 1.0 --hidden 64 --heads 8 --steps 20
    PYTHONPATH=src python -m repro_torch.launch.hgnn_train --steps 20 --trace t.json --metrics m.json
    torchrun --nproc-per-node 4 -m repro_torch.launch.hgnn_train --lanes 4 --plan-lanes 16
    torchrun --nproc-per-node 4 -m repro_torch.launch.hgnn_train --lanes 2 --model-split 2 \
        --plan-lanes 16

Builds the named Table-5 HetGraph, its target-type semantic graphs in the
similarity schedule's order (FP reuse), synthetic labels with planted
structure, and trains node classification with AdamW through the
fault-tolerant ``train_loop``: atomic checkpoints in the reference's
layout (``--ckpt``), counter-based data state, ``--crash-at`` fault
injection.

HAN takes the reference launcher's path: a ``MultiLanePlan`` of
``--plan-lanes`` lanes (default ``--lanes``) built by the workload-aware
scheduler, and ``han_forward_multilane`` over it.  ``--backend kernel``
(the default) is one launch of kernel #1 over all the plan's units a
step and one of #2 in the backward; ``reference`` is the plain per-unit
softmax; ``kernel_interpret`` is a spelling of ``kernel``.  ``--lanes``
is the lane axis of the mesh, the ranks of a ``torch.distributed`` group
(``torchrun --nproc-per-node``), over which the plan's lanes are split
(``--plan-lanes`` a multiple of ``--lanes``).  ``--model-split M`` adds
the mesh's model axis (``lanes · M`` ranks), under the reference's
``lanes`` rules (``dist.make_rules(parallelism="lanes")``): each model
rank holds its columns of ``w_fp``/``b_fp`` and its heads of the ``heads``
and ``mlp`` leaves, and its slices of the AdamW moments; FP's flops split
over the model axis, the rest runs replicated over it
(``han_forward_multilane``); M must divide ``--heads``.  Checkpoints hold
the logical leaves and restore on any (lanes, model) mesh (elastic
restart); one rank of the mesh writes them, and logs.  R-GAT's
relation-specific projections keep it off the plan: it runs kernels
#1/#2 once per semantic graph and layer (MULTIGRAPH at G = 1), BLOCK on
``reference``, replicated over the lane axis; under ``--model-split M``
each model rank holds its columns of every relation's ``w_src``/``w_dst``
and its rows of ``w_out`` (``rgat_forward`` with ``placements``), M
dividing ``--heads``.  Simple-HGN (HGB's graph: every relation, its
reverse and a self-loop a vertex, one table of every vertex) runs the
joint #1 once a layer and the joint #2 once in the backward, one softmax
over every relation into a vertex; ``--lanes`` and ``--model-split``
raise for it, and so does ``--backend reference``.  ``--device`` defaults to ``cuda`` and raises on a
host without a card; ``--device cpu`` runs the kernels' plain versions.

``--trace PATH`` traces the whole run with synchronising spans into a
Chrome-trace JSON; for HAN it first runs one per-stage characterization
pass (``obs/characterize.py``: FP, θ, NA and FA, one lane row per
semantic graph).  ``--metrics PATH`` writes the metrics registry (the
step-time histogram, the loss and grad-norm gauges, the characterization's
stage histogram) as JSON.  Under a mesh one rank alone characterizes
and writes both files.
"""
from __future__ import annotations

import argparse
import json
import os

import torch
import torch.distributed as dist

from ..checkpoint import logical_state, reshard_to, writes_checkpoints
from ..core.fusion import NABackend
from ..core.multilane import build_multilane_plan, resolve_multilane_backend
from ..core.scheduling import similarity_schedule
from ..data import SyntheticHGNNData
from ..dist import make_rules, param_shardings
from ..graphs import (
    build_semantic_graphs,
    dataset_metapaths,
    dataset_target,
    synthetic_hetgraph,
    synthetic_labels,
)
from ..models.hgnn import (
    MODELS,
    han_forward_multilane,
    prepare_data,
    prepare_simple_hgn,
    simple_hgn_graph,
)
from ..obs import disable_tracing, enable_tracing, get_registry
from ..obs.characterize import characterize_hgnn
from ..optim import AdamWConfig
from ..runtime import resolve_device
from ..train import (
    hgnn_train_state_axes,
    init_hgnn_train_state,
    make_hgnn_train_step,
    train_loop,
)
from ..tree import tree_leaves
from .mesh import make_lane_mesh

DATASETS = ("acm", "imdb", "dblp")
BACKENDS = ("reference", "kernel", "kernel_interpret")
# R-GAT's per-relation path: the kernel backends run #1/#2 per graph and layer
_PER_GRAPH = {"reference": NABackend.BLOCK, "kernel": NABackend.MULTIGRAPH,
              "kernel_interpret": NABackend.MULTIGRAPH}

# model.init keyword vocabularies differ (HAN takes att_dim, R-GAT layers)
_INIT_KW = {
    "HAN": lambda hidden, heads: dict(hidden=hidden, heads=heads, att_dim=2 * hidden),
    "R-GAT": lambda hidden, heads: dict(hidden=hidden, heads=heads, layers=2),
    "Simple-HGN": lambda hidden, heads: dict(hidden=hidden, heads=heads, layers=2,
                                             edge_dim=hidden),
}


def build_problem(
    dataset: str,
    *,
    scale: float = 0.1,
    feat_scale: float = 0.1,
    block: int = 128,
    max_edges: int = 400_000,
    seed: int = 0,
    device: str | torch.device = "cuda",
):
    """Synthesize the Table-5 HetG and its device-resident training data,
    semantic graphs ordered by the similarity schedule (FP reuse)."""
    dev = resolve_device(device)
    g = synthetic_hetgraph(dataset, scale=scale, feat_scale=feat_scale, seed=seed)
    target, ncls = dataset_target(dataset)
    labels = synthetic_labels(g, dataset, seed=seed)
    sgs = build_semantic_graphs(g, dataset_metapaths(dataset), max_edges=max_edges)
    order, _ = similarity_schedule(sgs, g.vertex_counts)
    data = prepare_data(g, [sgs[i] for i in order], target, ncls, labels, block=block,
                        device=dev)
    return g, data


def build_simple_hgn_problem(dataset: str, *, scale: float = 0.1, feat_scale: float = 0.1,
                             block: int = 128, seed: int = 0,
                             device: str | torch.device = "cuda"):
    """The Table-5 HetG as Simple-HGN trains on it (HGB's graph: every
    relation, its reverse and a self-loop a vertex) and its device-resident
    training data."""
    g = synthetic_hetgraph(dataset, scale=scale, feat_scale=feat_scale, seed=seed)
    target, ncls = dataset_target(dataset)
    labels = synthetic_labels(g, dataset, seed=seed)
    full, edge_types = simple_hgn_graph(g)
    return g, prepare_simple_hgn(full, edge_types, target, ncls, labels, block=block,
                                 device=resolve_device(device))


def run_training(
    *,
    dataset: str = "acm",
    model_name: str = "HAN",
    steps: int = 100,
    lanes: int = 1,
    model_split: int = 1,
    plan_lanes: int | None = None,
    backend: str = "kernel",
    hidden: int = 16,
    heads: int = 4,
    lr: float = 5e-3,
    batch: int = 0,  # labeled minibatch size; 0 = full batch
    block: int = 128,
    scale: float = 0.1,
    feat_scale: float = 0.1,
    max_edges: int = 400_000,
    seed: int = 0,
    ckpt_dir: str | None = None,
    ckpt_every: int = 50,
    resume: bool = True,
    crash_at: int | None = None,
    log_every: int = 10,
    log=print,
    trace: str | None = None,        # Chrome-trace JSON output path
    metrics_out: str | None = None,  # metrics-registry snapshot path
    registry=None,
    device: str | torch.device = "cuda",
):
    """Train HAN, R-GAT or Simple-HGN (one card) on one dataset under the
    lanes posture: one process, or one per rank of a (``lanes``, ``model_split``) mesh (an
    initialised ``torch.distributed`` group).  Returns ``(state, history,
    meta)``: the state holds this rank's pieces of the sharded leaves;
    meta records the model, the resolved backend, the mesh, the plan's
    lanes and sizes, and the characterization's result (None without
    ``trace``).

    ``trace=`` enables synchronising spans for the whole run and writes a
    Chrome-trace/Perfetto JSON on exit.  For HAN it also runs the
    per-stage characterization pass (``obs/characterize.py``, BLOCK)
    before the steady state, so the timeline carries FP/theta/NA/FA stage
    times with one lane row per semantic graph.  ``metrics_out=``
    snapshots ``registry`` (default: the process-wide one) to JSON.
    Under a mesh one rank (``writes_checkpoints``) alone logs,
    characterizes and writes (and logs each file it wrote).
    """
    if backend not in BACKENDS:
        raise ValueError(f"backend={backend!r}, expected one of {BACKENDS}")
    if model_name not in _INIT_KW:
        raise ValueError(f"model_name={model_name!r}, expected one of {sorted(_INIT_KW)}")
    if model_split > 1 and heads % model_split:
        raise ValueError(f"heads={heads} must be a multiple of model_split={model_split}: "
                         "a model rank holds whole heads")
    if model_name == "Simple-HGN" and (lanes > 1 or model_split > 1):
        raise ValueError("Simple-HGN trains on one card: --lanes and --model-split are out of "
                         "its scope (its joint NA has no lane or model split)")
    if model_name == "Simple-HGN" and backend == "reference":
        raise ValueError("Simple-HGN trains on the kernel backend (the joint #1/#2; their plain "
                         "versions on the CPU)")
    n_plan_lanes = plan_lanes or lanes
    if n_plan_lanes % lanes:
        raise ValueError(f"plan_lanes={n_plan_lanes} must be a multiple of lanes={lanes}")
    dev = resolve_device(device)
    mesh = make_lane_mesh(lanes, model_split, device_type=dev.type)
    if mesh is not None and dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    reporter = writes_checkpoints(mesh)  # one rank logs, characterizes and writes
    if not reporter:
        log = lambda *_: None  # noqa: E731
    reg = registry if registry is not None else get_registry()
    if model_name == "Simple-HGN":
        g, data = build_simple_hgn_problem(dataset, scale=scale, feat_scale=feat_scale,
                                           block=block, seed=seed, device=dev)
    else:
        g, data = build_problem(dataset, scale=scale, feat_scale=feat_scale, block=block,
                                max_edges=max_edges, seed=seed, device=dev)
    model = MODELS[model_name]
    n_target = g.vertex_counts[data.target_type]
    opt = AdamWConfig(lr=lr, weight_decay=0.0)
    pipeline = SyntheticHGNNData(num_vertices=n_target,
                                 batch_size=batch if batch > 0 else n_target, seed=seed)
    # the logical state, the same on every rank (one seed), then this rank's slices
    state = init_hgnn_train_state(model, torch.Generator().manual_seed(seed), data, opt,
                                  **_INIT_KW[model_name](hidden, heads))
    n_params = sum(p.numel() for p in tree_leaves(state.params))
    rules, axes = make_rules(parallelism="lanes"), hgnn_train_state_axes(state, opt)
    placements = None if mesh is None else param_shardings(mesh, rules, axes)
    state = reshard_to(state, mesh=mesh, rules=rules, axes=axes)
    param_placements = None if placements is None else placements.params
    if model_name == "HAN":
        # one NA call for all relations a step, over the plan's units in lane
        # order, the plan's lanes split over the mesh's lane group
        plan = build_multilane_plan(data.graphs, n_plan_lanes)
        na_backend = resolve_multilane_backend(backend)
        forward_fn = lambda p: han_forward_multilane(  # noqa: E731
            p, data, plan, mesh=mesh, placements=param_placements,
            backend=na_backend)
    elif model_name == "Simple-HGN":
        # one table of every vertex: the joint #1 once a layer, #2 once under autograd
        plan = None
        na_backend = NABackend.MULTIGRAPH.value
        forward_fn = lambda p: model.forward(p, data, backend=NABackend.MULTIGRAPH)  # noqa: E731
    else:
        # per-relation projections: the kernels once per relation and layer,
        # replicated on every lane rank, FP split over the model axis
        plan = None
        nab = _PER_GRAPH[backend]
        na_backend = nab.value
        forward_fn = lambda p: model.forward(  # noqa: E731
            p, data, backend=nab, mesh=mesh, placements=param_placements)
    log(f"[hgnn_train] {model_name}/{dataset} params={n_params / 1e6:.2f}M "
        f"edges={data.joint.num_edges if data.joint else sum(b.num_edges for b in data.graphs)} "
        f"mesh=lane{lanes}xmodel{model_split} "
        f"plan_lanes={None if plan is None else plan.num_lanes} device={dev} "
        f"backend={na_backend}")
    step_fn = make_hgnn_train_step(forward_fn, data, opt, mesh=mesh,
                                   placements=param_placements)
    tracer = enable_tracing(sync=True) if trace and reporter else None
    # the logical params, gathered on every rank (a collective) for the reporter
    char_params = (logical_state(state.params, mesh, param_placements)
                   if trace and model_name == "HAN" else None)
    char = None
    try:
        if tracer is not None and model_name == "HAN":
            # per-stage pass (paper §3 measured): FP/theta/NA/FA spans, one
            # lane row per semantic graph; the steps below yield whole-step spans
            char = characterize_hgnn(char_params, data, backend=NABackend.BLOCK, registry=reg)
            log("[characterize] "
                + " ".join(f"{k}={v:.0f}us" for k, v in char["stage_us"].items()))
        state, history = train_loop(
            state=state, train_step=step_fn, data=pipeline, steps=steps,
            ckpt_dir=ckpt_dir, ckpt_every=ckpt_every, resume=resume,
            crash_at=crash_at, log_every=log_every, log=log, registry=reg, mesh=mesh,
            placements=placements,
        )
    finally:
        if tracer is not None:
            tracer.export_chrome_trace(trace)
            disable_tracing()
            log(f"wrote {trace} (open at https://ui.perfetto.dev)")
    if metrics_out and reporter:
        reg.export_json(metrics_out)
        log(f"wrote {metrics_out}")
    meta = dict(dataset=dataset, model=model_name, backend=na_backend, lanes=lanes,
                model_split=model_split, plan_lanes=None if plan is None else plan.num_lanes,
                n_params=n_params, n_target=n_target, device=str(dev), characterize=char)
    return state, history, meta


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="acm", choices=DATASETS)
    ap.add_argument("--model", default="HAN", choices=sorted(_INIT_KW))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--lanes", type=int, default=1,
                    help="lane mesh axis size: the ranks of the process group (torchrun)")
    ap.add_argument("--model-split", type=int, default=1,
                    help="model mesh axis size: the heads/features over it (divides --heads)")
    ap.add_argument("--plan-lanes", type=int, default=None,
                    help="work-unit partition lanes (default: mesh lanes; must be a multiple)")
    ap.add_argument("--backend", default="kernel", choices=BACKENDS,
                    help="multilane NA executor: kernel = one launch of #1 (#2 backward) over "
                         "the plan's units a step (kernel_interpret: the same); reference = "
                         "the plain per-unit softmax")
    ap.add_argument("--hidden", type=int, default=16)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--lr", type=float, default=5e-3)
    ap.add_argument("--batch", type=int, default=0, help="labeled minibatch (0 = full)")
    ap.add_argument("--block", type=int, default=128,
                    help="dst block size (paper: 128; #1/#2 take 8, 16, 32, 64 or 128)")
    ap.add_argument("--scale", type=float, default=0.1)
    ap.add_argument("--feat-scale", type=float, default=0.1)
    ap.add_argument("--max-edges", type=int, default=400_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--crash-at", type=int, default=None, help="fault injection (tests)")
    ap.add_argument("--out", default=None, help="write the loss trajectory as JSON")
    ap.add_argument(
        "--trace", default=None, metavar="PATH",
        help="write a Chrome-trace/Perfetto JSON of the run (enables sync spans "
             "+ the per-stage characterization pass for HAN)",
    )
    ap.add_argument(
        "--metrics", default=None, metavar="PATH",
        help="write a metrics-registry JSON snapshot (step-time histogram, "
             "loss/grad-norm gauges, characterization stage histogram)",
    )
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu (plain versions)")
    return ap.parse_args(argv)


def main(argv: list[str] | None = None) -> None:
    args = parse_args(argv)
    # under torchrun (one process per rank) the launcher joins the group it sets up
    joined = (args.lanes * args.model_split > 1 and "WORLD_SIZE" in os.environ
              and not dist.is_initialized())
    if joined:
        dist.init_process_group("nccl" if args.device.startswith("cuda") else "gloo")
    try:
        state, history, meta = run_training(
            dataset=args.dataset, model_name=args.model, steps=args.steps,
            lanes=args.lanes, model_split=args.model_split, plan_lanes=args.plan_lanes,
            backend=args.backend, hidden=args.hidden, heads=args.heads, lr=args.lr,
            batch=args.batch, block=args.block, scale=args.scale,
            feat_scale=args.feat_scale, max_edges=args.max_edges, seed=args.seed,
            ckpt_dir=args.ckpt, ckpt_every=args.ckpt_every, resume=not args.no_resume,
            crash_at=args.crash_at, trace=args.trace, metrics_out=args.metrics,
            device=args.device,
        )
    finally:
        if joined:
            dist.destroy_process_group()
    if history:
        print(f"final loss {history[-1]['loss']:.4f} (start {history[0]['loss']:.4f}) "
              f"acc {history[-1]['acc']:.3f}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"meta": meta, "history": history}, f, indent=1)
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
