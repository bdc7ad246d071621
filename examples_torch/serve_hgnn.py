"""Serve HGNN graph requests with a cross-request FP cache (the port).

    PYTHONPATH=src python examples_torch/serve_hgnn.py                 # on the card
    PYTHONPATH=src python examples_torch/serve_hgnn.py --device cpu

Twelve concurrent subgraph queries over the synthetic IMDB HetGraph
arrive in an adversarial interleaved order (director-heavy, actor-heavy
and keyword-heavy requests alternating).  Similarity-aware admission
reorders and co-batches them so consecutive requests share
projected-feature blocks; the FIFO baseline thrashes the cache.  Outputs
are bit-identical either way — the cache only removes recomputation.
Each step's NA runs as one launch of the multigraph kernel (#1) on the
card, its plain version on the CPU.
"""
import argparse
import time

import torch

from repro_torch.core import NABackend
from repro_torch.graphs import synthetic_hetgraph
from repro_torch.serve import HGNNEngine, make_request_mix

CLUSTERS = [
    [("movie", "director", "movie"), ("movie", "director", "movie", "director", "movie")],
    [("movie", "actor", "movie"), ("movie", "actor", "movie", "actor", "movie")],
    [("movie", "keyword", "movie")],
]


def build_engine(graph, admission, cache_bytes, device):
    return HGNNEngine(
        graph,
        target_type="movie",
        num_slots=2,
        cache_bytes=cache_bytes,
        cache_block_rows=64,
        admission=admission,
        backend=NABackend.MULTIGRAPH,
        block=8,
        max_edges=8_000,
        device=device,
    )


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--repeats", type=int, default=4)
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    args = ap.parse_args(argv)

    graph = synthetic_hetgraph("imdb", scale=0.05, feat_scale=0.02, seed=0)
    out_bytes = 2 * 8 * 4  # heads * hidden * fp32
    table = {t: n * out_bytes for t, n in graph.vertex_counts.items()}
    cache_bytes = table["movie"] + max(table.values()) + 64 * out_bytes

    results = {}
    for admission in ("fifo", "similarity"):
        eng = build_engine(graph, admission, cache_bytes, args.device)
        for req in make_request_mix(0, CLUSTERS, repeats=args.repeats):
            eng.submit(req)
        t0 = time.perf_counter()
        finished = eng.run()
        dt = time.perf_counter() - t0
        m = eng.metrics()
        results[admission] = (finished, m)
        print(f"[{admission}] {m['requests_finished']} requests, {m['steps']} steps, "
              f"{dt:.2f}s  hit_rate={m['cache_hit_rate']:.2f} "
              f"fp_rows_computed={m['fp_rows_computed']} "
              f"(naive {m['fp_rows_naive']}, {m['fp_compute_reduction']:.1f}x saved)")
        for req in finished[:3]:
            print(f"  rid={req.rid} admitted@{req.admitted_step} finished@{req.finished_step} "
                  f"beta={[round(b, 3) for b in req.beta.tolist()]} "
                  f"|emb|={float(torch.linalg.vector_norm(req.result)):.3f}")

    fifo, sim = results["fifo"][1], results["similarity"][1]
    print(f"\nsimilarity admission computes "
          f"{fifo['fp_rows_computed'] / max(sim['fp_rows_computed'], 1):.1f}x fewer FP rows than FIFO")
    a = {r.rid: r.result for r in results["fifo"][0]}
    b = {r.rid: r.result for r in results["similarity"][0]}
    if not all(torch.equal(a[k], b[k]) for k in a):
        raise AssertionError("admission order changed results!")
    print("outputs bit-identical across admission policies")
    return {k: m for k, (_, m) in results.items()}


if __name__ == "__main__":
    main()
