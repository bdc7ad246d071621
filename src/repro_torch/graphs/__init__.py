"""Heterogeneous-graph substrate of the port (host-side numpy, no torch):
copies of ``repro.graphs`` that produce byte-identical arrays."""
from .datasets import (
    TABLE5,
    dataset_metapaths,
    dataset_target,
    synthetic_hetgraph,
    synthetic_labels,
)
from .formats import BlockCSR, to_block_csr
from .hetgraph import HetGraph, Relation, SemanticGraph, make_relation
from .sgb import build_semantic_graph, build_semantic_graphs

__all__ = [
    "HetGraph",
    "Relation",
    "SemanticGraph",
    "make_relation",
    "build_semantic_graph",
    "build_semantic_graphs",
    "BlockCSR",
    "to_block_csr",
    "TABLE5",
    "dataset_metapaths",
    "dataset_target",
    "synthetic_hetgraph",
    "synthetic_labels",
]
