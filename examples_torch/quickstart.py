"""Quickstart of the PyTorch/CUDA port: the HiHGNN pipeline end to end on
synthetic DBLP.

    PYTHONPATH=src python examples_torch/quickstart.py                 # on the card
    PYTHONPATH=src python examples_torch/quickstart.py --device cpu --scale 0.02

Builds semantic graphs from metapaths (SGB), orders them by the shortest
Hamilton path over the similarity graph, counts the FP and θ work the
factoring saves, balances block-row workloads across lanes, and trains
the HAN layer on SEGMENT for a few SGD steps through autograd.
"""
import argparse

import torch

from repro_torch.core import NABackend, batch_semantic_graph, count_reuse, similarity_schedule
from repro_torch.core.multilane import build_multilane_plan
from repro_torch.graphs import (
    build_semantic_graphs,
    dataset_metapaths,
    dataset_target,
    synthetic_hetgraph,
    synthetic_labels,
)
from repro_torch.models.hgnn import MODELS, cross_entropy, prepare_data


def main(argv: list[str] | None = None) -> list[float]:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--scale", type=float, default=0.1, help="graph scale (Table 5 = 1.0)")
    ap.add_argument("--steps", type=int, default=10)
    args = ap.parse_args(argv)

    # 1. Semantic Graph Build (host preprocessing, like the paper)
    g = synthetic_hetgraph("dblp", scale=args.scale, feat_scale=0.1, seed=0)
    sgs = build_semantic_graphs(g, dataset_metapaths("dblp"), max_edges=100_000)
    print("semantic graphs:", [(s.name, s.num_edges) for s in sgs])

    # 2. Similarity-aware execution scheduling (shortest Hamilton path)
    order, _ = similarity_schedule(sgs, g.vertex_counts)
    print("execution order:", [sgs[i].name for i in order])

    # 3. RAB-style reuse accounting
    c = count_reuse(sgs, g.vertex_counts)
    print(f"FP work saved by dedup: {c.fp_saved:.0%}; theta work saved: {c.theta_saved:.0%}")

    # 4. Workload-aware lane balancing (independency-aware parallelism)
    batches = [batch_semantic_graph(s, block=32) for s in sgs]
    plan = build_multilane_plan(batches, num_lanes=4)
    print("lane loads (edges):", plan.lane_plan.lane_load.astype(int).tolist(),
          f"imbalance={plan.lane_plan.imbalance():.2f}")

    # 5. HAN forward + a few SGD steps through autograd
    target, ncls = dataset_target("dblp")
    labels = synthetic_labels(g, "dblp")
    data = prepare_data(g, [sgs[i] for i in order], target, ncls, labels, block=32,
                        device=args.device)
    model = MODELS["HAN"]
    params = {k: v.requires_grad_() for k, v in
              model.init(torch.Generator().manual_seed(0), data).items()}
    losses = []
    for i in range(args.steps):
        loss = cross_entropy(model.forward(params, data, backend=NABackend.SEGMENT), data.labels)
        grads = torch.autograd.grad(loss, list(params.values()))
        with torch.no_grad():
            for p, gr in zip(params.values(), grads):
                p -= 0.05 * gr
        losses.append(float(loss.detach()))
        if i % 3 == 0:
            print(f"step {i}: loss {losses[-1]:.4f}")
    print("done — fused HGNN pipeline runs end to end.")
    return losses


if __name__ == "__main__":
    main()
