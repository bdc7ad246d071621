"""HiHGNN core of the port: stage ops, the NA dispatch with its kernel
backends, similarity-aware scheduling and FP-traffic accounting."""
from . import stages
from .fusion import (
    FusedFPInputs,
    NABackend,
    SemanticGraphBatch,
    batch_semantic_graph,
    build_unit_tables,
    mean_aggregate,
    neighbor_aggregate,
    neighbor_aggregate_multi,
    project_coefficients,
)
from .reuse import FPTraffic, fp_buffer_traffic
from .scheduling import shortest_hamilton_path, similarity_matrix, similarity_schedule

__all__ = [
    "stages",
    "FusedFPInputs",
    "NABackend",
    "SemanticGraphBatch",
    "batch_semantic_graph",
    "build_unit_tables",
    "mean_aggregate",
    "neighbor_aggregate",
    "neighbor_aggregate_multi",
    "project_coefficients",
    "FPTraffic",
    "fp_buffer_traffic",
    "shortest_hamilton_path",
    "similarity_matrix",
    "similarity_schedule",
]
