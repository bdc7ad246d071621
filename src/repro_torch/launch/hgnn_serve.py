"""HGNN serving launcher of the port: stepped graph-request inference with
the cross-request FP cache and similarity-aware admission.

    PYTHONPATH=src python -m repro_torch.launch.hgnn_serve --na-backend multigraph

Builds the named Table-5 HetGraph, submits a round-robin request mix over
its target-type metapaths, and drives ``serve/hgnn_engine.py``.
``--compare`` runs the same mix under FIFO and similarity-aware admission
and reports the measured FP-stage compute reduction.

``--na-backend multigraph`` runs one multigraph kernel launch per step;
``fused_fp`` (or ``fused-fp``) runs the FP+NA megakernel on an FP-cache
miss and the multigraph kernel on a full-table hit; ``block`` and
``segment`` are the plain PyTorch per-graph paths.
``multigraph_interpret`` and ``fused_fp_interpret`` are spellings of
``multigraph`` and ``fused_fp``: the device picks the code.  ``--device``
defaults to ``cuda`` and raises on a host without a card (no fallback);
``--device cpu`` runs the kernels' plain versions.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

from ..core.fusion import NABackend
from ..graphs import dataset_metapaths, dataset_target, synthetic_hetgraph
from ..obs import MetricsRegistry, disable_tracing, enable_tracing
from ..runtime import resolve_device
from ..serve.hgnn_engine import HGNNEngine, make_request_mix

_BACKENDS = {
    "segment": NABackend.SEGMENT,
    "block": NABackend.BLOCK,
    "multigraph": NABackend.MULTIGRAPH,
    "multigraph_interpret": NABackend.MULTIGRAPH,
    "fused_fp": NABackend.FUSED_FP,
    "fused-fp": NABackend.FUSED_FP,  # alias
    "fused_fp_interpret": NABackend.FUSED_FP,
}


def _target_metapaths(name: str, target: str) -> list[tuple[str, ...]]:
    return [tuple(mp) for mp in dataset_metapaths(name) if mp[0] == target and mp[-1] == target]


def serve_mix(graph, target, clusters, args, admission, registry=None,
              outputs: dict | None = None) -> dict:
    """Serve the mix on a fresh engine; returns its metrics and puts each
    finished request's fused embedding into ``outputs`` by rid."""
    eng = HGNNEngine(
        graph,
        target_type=target,
        hidden=args.hidden,
        heads=args.heads,
        num_slots=args.slots,
        cache_bytes=args.cache_kb * 1024,
        cache_block_rows=args.cache_block_rows,
        cache_policy=args.policy,
        admission=admission,
        backend=_BACKENDS[args.na_backend],
        block=args.block,
        max_edges=args.max_edges,
        registry=registry,
        device=args.device,
    )
    for req in make_request_mix(0, clusters, repeats=args.repeats):
        eng.submit(req)
    t0 = time.perf_counter()
    finished = eng.run()
    dt = time.perf_counter() - t0
    if outputs is not None:
        outputs.update((r.rid, r.result) for r in finished)
    m = eng.metrics()
    m["wall_s"] = dt
    m["admission"] = admission
    m["device"] = str(eng.device)
    return m


def main(argv: list[str] | None = None) -> dict:
    """Run the launcher; returns the fused embedding of each request by rid
    (under ``--compare``, the similarity run's)."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="imdb", choices=("imdb", "acm", "dblp"))
    ap.add_argument("--scale", type=float, default=0.05)
    ap.add_argument("--feat-scale", type=float, default=0.02)
    ap.add_argument("--repeats", type=int, default=4, help="requests per metapath cluster")
    ap.add_argument("--slots", type=int, default=2)
    ap.add_argument("--cache-kb", type=int, default=48, help="FP cache capacity (0 disables)")
    ap.add_argument("--cache-block-rows", type=int, default=64)
    ap.add_argument("--policy", default="lru", choices=("lru", "similarity"))
    ap.add_argument("--admission", default="similarity", choices=("similarity", "fifo"))
    ap.add_argument("--na-backend", default="multigraph", choices=sorted(_BACKENDS))
    ap.add_argument("--hidden", type=int, default=8)
    ap.add_argument("--heads", type=int, default=2)
    ap.add_argument("--block", type=int, default=8, help="dst block size for the NA formats")
    ap.add_argument("--max-edges", type=int, default=20_000)
    ap.add_argument("--compare", action="store_true", help="run FIFO vs similarity admission")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu (plain versions)")
    ap.add_argument(
        "--trace", default=None, metavar="PATH",
        help="write a Chrome-trace/Perfetto JSON of the serving run (sync spans: "
             "serve/step + FP/theta/NA spans, one lane row per slot)",
    )
    ap.add_argument(
        "--metrics", default=None, metavar="PATH",
        help="write the engine metrics registry (counters, cache gauges, "
             "per-step latency histogram) as JSON",
    )
    args = ap.parse_args(argv)
    resolve_device(args.device)  # fail before building the graph

    graph = synthetic_hetgraph(args.dataset, scale=args.scale, feat_scale=args.feat_scale, seed=0)
    target, _ = dataset_target(args.dataset)
    clusters = [[mp] for mp in _target_metapaths(args.dataset, target)]
    if not clusters:
        raise SystemExit(f"{args.dataset}: no target->target metapaths")

    tracer = enable_tracing(sync=True) if args.trace else None
    # one registry across runs: --compare accumulates both admissions'
    # counters; gauges reflect the last engine to step
    reg = MetricsRegistry() if args.metrics else None
    outputs: dict = {}
    try:
        if args.compare:
            fifo = serve_mix(graph, target, clusters, args, "fifo", registry=reg)
            sim = serve_mix(graph, target, clusters, args, "similarity", registry=reg,
                            outputs=outputs)
            reduction = fifo["fp_rows_computed"] / max(sim["fp_rows_computed"], 1)
            print(json.dumps(dict(fifo=fifo, similarity=sim,
                                  fp_rows_fifo_over_similarity=reduction), indent=1))
        else:
            print(json.dumps(
                serve_mix(graph, target, clusters, args, args.admission, registry=reg,
                          outputs=outputs),
                indent=1,
            ))
    finally:
        if tracer is not None:
            tracer.export_chrome_trace(args.trace)
            disable_tracing()
            print(f"wrote {args.trace} (open at https://ui.perfetto.dev)", file=sys.stderr)
    if reg is not None:
        reg.export_json(args.metrics)
        print(f"wrote {args.metrics}", file=sys.stderr)
    return outputs


if __name__ == "__main__":
    main()
