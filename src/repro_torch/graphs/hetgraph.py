"""Heterogeneous graph substrate (host-side, numpy).

A HetGraph G = (V, E, T_v, T_e) carries typed vertex sets with per-type
feature matrices and typed edge sets (relations).  Semantic graphs are
derived from it by metapath composition (see sgb.py) or taken per relation.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class Relation:
    """A typed edge set `src_type --name--> dst_type`."""

    name: str
    src_type: str
    dst_type: str
    src_ids: np.ndarray  # int32 [E]
    dst_ids: np.ndarray  # int32 [E]

    @property
    def num_edges(self) -> int:
        return int(self.src_ids.shape[0])

    def reversed(self, name: str | None = None) -> "Relation":
        return Relation(
            name=name or (self.name + "_rev"),
            src_type=self.dst_type,
            dst_type=self.src_type,
            src_ids=self.dst_ids,
            dst_ids=self.src_ids,
        )


@dataclasses.dataclass(frozen=True)
class HetGraph:
    """Typed vertices + typed edges + per-type raw features."""

    vertex_counts: Mapping[str, int]
    features: Mapping[str, np.ndarray]  # type -> float32 [n_type, d_type]
    relations: Mapping[str, Relation]

    @property
    def vertex_types(self) -> Sequence[str]:
        return tuple(self.vertex_counts.keys())

    @property
    def edge_types(self) -> Sequence[str]:
        return tuple(self.relations.keys())

    def num_vertices(self, vtype: str) -> int:
        return int(self.vertex_counts[vtype])

    def feature_dim(self, vtype: str) -> int:
        return int(self.features[vtype].shape[1])

    def validate(self) -> None:
        for name, rel in self.relations.items():
            assert rel.name == name
            assert rel.src_ids.shape == rel.dst_ids.shape
            assert rel.src_ids.dtype == np.int32 and rel.dst_ids.dtype == np.int32
            ns = self.vertex_counts[rel.src_type]
            nd = self.vertex_counts[rel.dst_type]
            if rel.num_edges:
                assert rel.src_ids.min() >= 0 and rel.src_ids.max() < ns, name
                assert rel.dst_ids.min() >= 0 and rel.dst_ids.max() < nd, name
        for vtype, feat in self.features.items():
            assert feat.shape[0] == self.vertex_counts[vtype], vtype


@dataclasses.dataclass(frozen=True)
class SemanticGraph:
    """One semantic graph G^P: edges src->dst under a metapath/relation P.

    ``path_types`` records every vertex type visited along the metapath —
    that is what similarity-aware scheduling (core/scheduling.py) uses to
    estimate inter-semantic-graph FP reuse, mirroring the paper's hypergraph
    whose edge weights come from shared vertex types.
    """

    name: str
    src_type: str
    dst_type: str
    src_ids: np.ndarray  # int32 [E]
    dst_ids: np.ndarray  # int32 [E]
    num_src: int
    num_dst: int
    path_types: tuple[str, ...]

    @property
    def num_edges(self) -> int:
        return int(self.src_ids.shape[0])

    def in_degrees(self) -> np.ndarray:
        return np.bincount(self.dst_ids, minlength=self.num_dst).astype(np.int32)


def make_relation(name, src_type, dst_type, src_ids, dst_ids) -> Relation:
    return Relation(
        name=name,
        src_type=src_type,
        dst_type=dst_type,
        src_ids=np.asarray(src_ids, np.int32),
        dst_ids=np.asarray(dst_ids, np.int32),
    )



def relation_semantic_graphs(g: HetGraph) -> list[SemanticGraph]:
    """One semantic graph per relation (the R-GCN / R-GAT / S-HGN view)."""
    out = []
    for rel in g.relations.values():
        out.append(
            SemanticGraph(
                name=rel.name,
                src_type=rel.src_type,
                dst_type=rel.dst_type,
                src_ids=rel.src_ids,
                dst_ids=rel.dst_ids,
                num_src=g.num_vertices(rel.src_type),
                num_dst=g.num_vertices(rel.dst_type),
                path_types=(rel.src_type, rel.dst_type),
            )
        )
    return out
