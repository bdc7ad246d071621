"""The port's R-GAT on a configuration: the relations and their reverses
as the port's ``HetGraph``, one semantic graph a relation
(``relation_semantic_graphs``), ``prepare_data``, and ``rgat_forward``:
on MULTIGRAPH to train (#1 and #2 once a relation and layer, as the
port's training launcher runs it), on KERNEL to infer (#6 twice and #5
once a relation and layer).

The weights are the benchmark's (``reference.rgat.init_params``): this
module only puts them into the port's tree (``layers[l]["rel"]["g<i>"]``
in the port's graph order) and reads the port's trees back.
"""
from __future__ import annotations

from repro_torch.core.fusion import NABackend
from repro_torch.graphs import HetGraph, make_relation, relation_semantic_graphs
from repro_torch.models.hgnn import prepare_data
from repro_torch.models.hgnn.rgat import rgat_forward

_BACKEND = {"train": NABackend.MULTIGRAPH, "infer": NABackend.KERNEL}
_REL = ("w_src", "w_dst", "a_src", "a_dst")


class Port:
    def __init__(self, cfg: dict, inputs: dict, device, span, *, mode: str):
        spec = cfg["graph"]
        rels = {n: make_relation(n, st, dt, s, d)
                for n, (st, dt, s, d) in inputs["relations"].items()}
        for n in spec["reverse"]:
            rels[f"{n}_rev"] = rels[n].reversed(f"{n}_rev")
        g = HetGraph(vertex_counts=dict(inputs["vertex_counts"]),
                     features=dict(inputs["features"]), relations=rels)
        with span("bench/setup/relation_graphs"):
            sgs = relation_semantic_graphs(g)
        with span("bench/setup/prepare_data"):
            self.data = prepare_data(g, sgs, spec["target"], int(spec["num_classes"]),
                                     inputs["labels"], block=cfg["block"], device=device)
        self.names = [b.name for b in self.data.graphs]
        self.types = list(self.data.features)
        self.layers = int(cfg["widths"]["layers"])
        self.backend = _BACKEND[mode]
        self.n_target = int(inputs["vertex_counts"][spec["target"]])

    def to_port(self, params: dict) -> dict:
        layers = []
        for layer in range(self.layers):
            pre = f"layers.{layer}."
            layers.append({
                "rel": {f"g{i}": {k: params[f"{pre}rel.{n}.{k}"].clone() for k in _REL}
                        for i, n in enumerate(self.names)},
                "self": {t: params[f"{pre}self.{t}"].clone() for t in self.types}})
        return {"layers": layers, "w_out": params["w_out"].clone(),
                "b_out": params["b_out"].clone()}

    def from_port(self, tree: dict) -> dict:
        flat = {"w_out": tree["w_out"], "b_out": tree["b_out"]}
        for layer, lp in enumerate(tree["layers"]):
            for i, n in enumerate(self.names):
                for k in _REL:
                    flat[f"layers.{layer}.rel.{n}.{k}"] = lp["rel"][f"g{i}"][k]
            for t in self.types:
                flat[f"layers.{layer}.self.{t}"] = lp["self"][t]
        return flat

    def forward_fn(self):
        """``params -> logits`` on the mode's backend."""
        return lambda p: rgat_forward(p, self.data, backend=self.backend)
