"""The port's Simple-HGN on a configuration: every relation, its reverse
and a self-loop relation a vertex type as the port's ``HetGraph``, each
mapped to its edge type (``reference.simple_hgn.edge_types``),
``prepare_simple_hgn`` (the port's ``JointGraph``: one table of every
vertex, a unit a dst block holding every relation's slots), and
``simple_hgn_forward`` on MULTIGRAPH: the joint #1 once a layer, the
joint #2 once a layer under autograd.

The weights are the benchmark's (``reference.simple_hgn.init_params``):
this module only puts them into the port's tree (``fp[type]``,
``layers[l]``) and reads the port's trees back.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.fusion import NABackend
from repro_torch.graphs import HetGraph, make_relation
from repro_torch.models.hgnn.shgn import prepare_simple_hgn, simple_hgn_forward

from ..reference.simple_hgn import edge_types, param_shapes, vertex_order


class Port:
    def __init__(self, cfg: dict, inputs: dict, device, span, *, mode: str):
        if mode != "train":
            raise ValueError(f"Simple-HGN's benchmark trains; no {mode!r} cell")
        spec = cfg["graph"]
        rels = {n: make_relation(n, st, dt, s, d)
                for n, (st, dt, s, d) in inputs["relations"].items()}
        for n in spec["reverse"]:
            rels[f"{n}_rev"] = rels[n].reversed(f"{n}_rev")
        for t, count in inputs["vertex_counts"].items():
            ids = np.arange(int(count), dtype=np.int32)
            rels[f"{t}_self"] = make_relation(f"{t}_self", t, t, ids, ids)
        g = HetGraph(vertex_counts=dict(inputs["vertex_counts"]),
                     features=dict(inputs["features"]), relations=rels)
        with span("bench/setup/prepare_data"):
            self.data = prepare_simple_hgn(g, edge_types(cfg), spec["target"],
                                           int(spec["num_classes"]), inputs["labels"],
                                           block=cfg["block"], device=device)
        self.types = vertex_order(cfg)
        self.keys = list(param_shapes(cfg, inputs)[0])
        self.layers = int(cfg["widths"]["layers"]) + 1
        self.beta, self.slope = float(cfg["widths"]["beta"]), float(cfg["widths"]["slope"])
        self.n_target = int(inputs["vertex_counts"][spec["target"]])

    def to_port(self, params: dict) -> dict:
        tree = {"fp": {t: {k: params[f"fp.{t}.{k}"].clone() for k in ("w", "b")}
                       for t in self.types}, "layers": [{} for _ in range(self.layers)]}
        for key in self.keys:
            if key.startswith("layers."):
                _, layer, leaf = key.split(".")
                tree["layers"][int(layer)][leaf] = params[key].clone()
        return tree

    def from_port(self, tree: dict) -> dict:
        flat = {}
        for key in self.keys:
            kind, mid, leaf = key.split(".")
            flat[key] = tree["fp"][mid][leaf] if kind == "fp" else tree["layers"][int(mid)][leaf]
        return flat

    def forward_fn(self):
        """``params -> logits`` on MULTIGRAPH (the joint kernels on the card)."""
        return lambda p: simple_hgn_forward(p, self.data, backend=NABackend.MULTIGRAPH,
                                            beta=self.beta, leaky_slope=self.slope)
