"""Heterogeneous-graph substrate of the port (host-side numpy, no torch):
copies of ``repro.graphs`` that produce byte-identical arrays."""
from .datasets import (
    TABLE5,
    dataset_metapaths,
    dataset_target,
    synthetic_hetgraph,
    synthetic_labels,
)
from .formats import (
    BlockCSR,
    PaddedEdges,
    block_csr_to_dense,
    dense_adjacency,
    to_block_csr,
    to_padded_edges,
)
from .hetgraph import (
    HetGraph,
    Relation,
    SemanticGraph,
    make_relation,
    relation_semantic_graphs,
)
from .sgb import build_semantic_graph, build_semantic_graphs

__all__ = [
    "HetGraph",
    "Relation",
    "SemanticGraph",
    "make_relation",
    "relation_semantic_graphs",
    "build_semantic_graph",
    "build_semantic_graphs",
    "BlockCSR",
    "PaddedEdges",
    "block_csr_to_dense",
    "dense_adjacency",
    "to_block_csr",
    "to_padded_edges",
    "TABLE5",
    "dataset_metapaths",
    "dataset_target",
    "synthetic_hetgraph",
    "synthetic_labels",
]
