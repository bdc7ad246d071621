"""The port's HAN on a configuration, wired as the port's training
launcher (``repro_torch.launch.hgnn_train.run_training``) wires it: the
metapath graphs composed by the port (``build_semantic_graphs``), ordered
by its similarity schedule, moved to the card by ``prepare_data``, a
``MultiLanePlan`` of the configuration's lanes, and
``han_forward_multilane`` on the kernel backend (#1 forward, #2 backward).

The weights are the benchmark's (``reference.han.init_params``): this
module only puts them into the port's tree, in the port's graph order,
and reads the port's trees back into the reference's flat names.
"""
from __future__ import annotations

import torch

from repro_torch.core.multilane import build_multilane_plan
from repro_torch.core.scheduling import similarity_schedule
from repro_torch.graphs import HetGraph, build_semantic_graphs, make_relation
from repro_torch.models.hgnn import han_forward_multilane, prepare_data


def hetgraph(inputs: dict) -> HetGraph:
    return HetGraph(
        vertex_counts=dict(inputs["vertex_counts"]),
        features=dict(inputs["features"]),
        relations={n: make_relation(n, st, dt, s, d)
                   for n, (st, dt, s, d) in inputs["relations"].items()})


class Port:
    """The port's set-up for one run; ``span`` times each call."""

    def __init__(self, cfg: dict, inputs: dict, device, span, *, mode: str):
        if mode != "train":
            raise ValueError(f"HAN cells train; mode {mode!r} has no path here")
        spec = cfg["graph"]
        paths = [tuple(m) for m in spec["metapaths"]]
        g = hetgraph(inputs)
        with span("bench/setup/semantic_graphs"):
            sgs = build_semantic_graphs(g, paths, max_edges=cfg["max_edges"])
        with span("bench/setup/schedule"):
            order, _ = similarity_schedule(sgs, g.vertex_counts)
        with span("bench/setup/prepare_data"):
            self.data = prepare_data(g, [sgs[i] for i in order], spec["target"],
                                     int(spec["num_classes"]), inputs["labels"],
                                     block=cfg["block"], device=device)
        with span("bench/setup/plan"):
            self.plan = build_multilane_plan(self.data.graphs, cfg["plan_lanes"])
        # the configuration's metapath of each of the port's graphs
        self.graph_of = [paths.index(tuple(b.path_types)) for b in self.data.graphs]
        self.n_target = int(inputs["vertex_counts"][spec["target"]])

    def to_port(self, params: dict) -> dict:
        tree = {k: params[k].clone() for k in ("w_fp", "b_fp", "w_g", "b_g", "w_out", "b_out")}
        tree["q"] = params["q"][:, 0].clone()
        for side in ("a_src", "a_dst"):
            tree[side] = torch.stack([params[f"{side}.{j}"] for j in self.graph_of])
        return tree

    def from_port(self, tree: dict) -> dict:
        flat = {k: tree[k] for k in ("w_fp", "b_fp", "w_g", "b_g", "w_out", "b_out")}
        flat["q"] = tree["q"][:, None]
        for side in ("a_src", "a_dst"):
            for i, j in enumerate(self.graph_of):
                flat[f"{side}.{j}"] = tree[side][i]
        return flat

    def forward_fn(self):
        """The training forward: ``params -> logits``."""
        return lambda p: han_forward_multilane(p, self.data, self.plan, backend="kernel")
