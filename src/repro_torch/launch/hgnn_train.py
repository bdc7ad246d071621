"""HGNN training launcher of the port: HAN or R-GAT on one card.

    PYTHONPATH=src python -m repro_torch.launch.hgnn_train --dataset imdb \\
        --scale 1.0 --feat-scale 1.0 --hidden 64 --heads 8 --steps 20
    PYTHONPATH=src python -m repro_torch.launch.hgnn_train --model R-GAT \\
        --dataset imdb --scale 1.0 --feat-scale 1.0 --hidden 64 --heads 4 --steps 20
    PYTHONPATH=src python -m repro_torch.launch.hgnn_train --device cpu --steps 5

Builds the named Table-5 HetGraph, its target-type semantic graphs in the
similarity schedule's order (FP reuse), synthetic labels with planted
structure, and trains node classification with AdamW through the
fault-tolerant ``train_loop``: atomic checkpoints in the reference's
layout (``--ckpt``), counter-based data state, ``--crash-at`` fault
injection.

``--backend kernel`` (the default) runs HAN's NA of all semantic graphs in
one launch of the multigraph kernel, forward and backward (kernels #1 and
#2); R-GAT's relation-specific projections keep it off that one-launch
plan, so it runs the same kernels once per semantic graph and layer
(G = 1).  ``reference`` is the plain per-graph BLOCK path.  With one lane
this is what ``repro``'s launcher runs (``han_forward_multilane`` with one
lane is one multigraph launch over the units in graph-major order).
``--device`` defaults to ``cuda`` and raises on a host without a card;
``--device cpu`` runs the kernels' plain versions.

Not ported yet, and an error that names the ROADMAP slice: more than one
lane (``--lanes``, ``--plan-lanes``, ``--model-split``), ``--trace`` and
``--metrics``.
"""
from __future__ import annotations

import argparse
import json

import torch

from ..core.fusion import NABackend
from ..core.scheduling import similarity_schedule
from ..data import SyntheticHGNNData
from ..graphs import (
    build_semantic_graphs,
    dataset_metapaths,
    dataset_target,
    synthetic_hetgraph,
    synthetic_labels,
)
from ..models.hgnn import MODELS, prepare_data
from ..optim import AdamWConfig
from ..runtime import resolve_device
from ..train import init_hgnn_train_state, make_hgnn_train_step, train_loop
from ..tree import tree_leaves

DATASETS = ("acm", "imdb", "dblp")
BACKENDS = {"reference": NABackend.BLOCK, "kernel": NABackend.MULTIGRAPH}

# model.init keyword vocabularies differ (HAN takes att_dim, R-GAT layers)
_INIT_KW = {
    "HAN": lambda hidden, heads: dict(hidden=hidden, heads=heads, att_dim=2 * hidden),
    "R-GAT": lambda hidden, heads: dict(hidden=hidden, heads=heads, layers=2),
}


def _not_ported(what: str, slice_: str) -> NotImplementedError:
    return NotImplementedError(f"{what} is not ported yet: ROADMAP Queue 1 item {slice_}")


def build_problem(
    dataset: str,
    *,
    scale: float = 0.1,
    feat_scale: float = 0.1,
    block: int = 16,
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


def run_training(
    *,
    dataset: str = "acm",
    model_name: str = "HAN",
    steps: int = 100,
    backend: str = "kernel",
    hidden: int = 16,
    heads: int = 4,
    lr: float = 5e-3,
    batch: int = 0,  # labeled minibatch size; 0 = full batch
    block: int = 16,
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
    device: str | torch.device = "cuda",
):
    """Train HAN or R-GAT on one dataset on one device.  Returns ``(state,
    history, meta)``; meta records the model, the resolved backend and
    sizes."""
    if backend not in BACKENDS:
        raise ValueError(f"backend={backend!r}, expected one of {sorted(BACKENDS)}")
    if model_name not in _INIT_KW:
        raise ValueError(f"model_name={model_name!r}, expected one of {sorted(_INIT_KW)}")
    dev = resolve_device(device)
    g, data = build_problem(dataset, scale=scale, feat_scale=feat_scale, block=block,
                            max_edges=max_edges, seed=seed, device=dev)
    nab = BACKENDS[backend]
    n_target = g.vertex_counts[data.target_type]
    opt = AdamWConfig(lr=lr, weight_decay=0.0)
    pipeline = SyntheticHGNNData(num_vertices=n_target,
                                 batch_size=batch if batch > 0 else n_target, seed=seed)
    model = MODELS[model_name]
    state = init_hgnn_train_state(model, torch.Generator().manual_seed(seed), data, opt,
                                  **_INIT_KW[model_name](hidden, heads))
    n_params = sum(p.numel() for p in tree_leaves(state.params))
    log(f"[hgnn_train] {model_name}/{dataset} params={n_params / 1e6:.2f}M "
        f"edges={sum(b.num_edges for b in data.graphs)} device={dev} backend={nab.value}")
    step_fn = make_hgnn_train_step(lambda p: model.forward(p, data, backend=nab), data, opt)
    state, history = train_loop(
        state=state, train_step=step_fn, data=pipeline, steps=steps,
        ckpt_dir=ckpt_dir, ckpt_every=ckpt_every, resume=resume,
        crash_at=crash_at, log_every=log_every, log=log,
    )
    meta = dict(dataset=dataset, model=model_name, backend=nab.value, n_params=n_params,
                n_target=n_target, device=str(dev))
    return state, history, meta


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="acm", choices=DATASETS)
    ap.add_argument("--model", default="HAN", choices=sorted(_INIT_KW))
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--lanes", type=int, default=1, help="lane mesh axis size (1 only)")
    ap.add_argument("--model-split", type=int, default=1, help="model mesh axis size (1 only)")
    ap.add_argument("--plan-lanes", type=int, default=None, help="work-unit partition lanes (1 only)")
    ap.add_argument("--backend", default="kernel", choices=sorted(BACKENDS),
                    help="kernel = the multigraph kernels #1/#2 (HAN: one launch per step; "
                         "R-GAT: one per graph and layer); reference = plain per-graph BLOCK")
    ap.add_argument("--hidden", type=int, default=16)
    ap.add_argument("--heads", type=int, default=4)
    ap.add_argument("--lr", type=float, default=5e-3)
    ap.add_argument("--batch", type=int, default=0, help="labeled minibatch (0 = full)")
    ap.add_argument("--block", type=int, default=16,
                    help="dst block size (the kernel backend's #1/#2 take 8, 16, 32, 64 or "
                         "128; the reference trainer's default is 128)")
    ap.add_argument("--scale", type=float, default=0.1)
    ap.add_argument("--feat-scale", type=float, default=0.1)
    ap.add_argument("--max-edges", type=int, default=400_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--no-resume", action="store_true")
    ap.add_argument("--crash-at", type=int, default=None, help="fault injection (tests)")
    ap.add_argument("--out", default=None, help="write the loss trajectory as JSON")
    ap.add_argument("--trace", default=None, metavar="PATH", help="not ported yet")
    ap.add_argument("--metrics", default=None, metavar="PATH", help="not ported yet")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu (plain versions)")
    args = ap.parse_args(argv)
    if args.lanes > 1 or args.model_split > 1 or (args.plan_lanes or 1) > 1:
        raise _not_ported("training on more than one lane", "3 (multi-lane execution)")
    if args.trace or args.metrics:
        raise _not_ported("--trace/--metrics on the training launcher", "5 (observability)")

    state, history, meta = run_training(
        dataset=args.dataset, model_name=args.model, steps=args.steps, backend=args.backend,
        hidden=args.hidden, heads=args.heads, lr=args.lr,
        batch=args.batch, block=args.block, scale=args.scale,
        feat_scale=args.feat_scale, max_edges=args.max_edges, seed=args.seed,
        ckpt_dir=args.ckpt, ckpt_every=args.ckpt_every, resume=not args.no_resume,
        crash_at=args.crash_at, device=args.device,
    )
    if history:
        print(f"final loss {history[-1]['loss']:.4f} (start {history[0]['loss']:.4f}) "
              f"acc {history[-1]['acc']:.3f}")
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"meta": meta, "history": history}, f, indent=1)
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
