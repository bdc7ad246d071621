"""HiHGNN core of the port: stage ops, the NA dispatch with its kernel
backends, independency-aware parallel execution (multi-lane plans and
workload-aware lane scheduling), similarity-aware scheduling and
RAB-style reuse accounting."""
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
    project_dst_coefficients,
)
from .multilane import (
    MULTILANE_BACKENDS,
    MultiLanePlan,
    build_multilane_plan,
    multilane_na,
    multilane_na_sharded,
    resolve_multilane_backend,
)
from .reuse import FPTraffic, ReuseCounters, count_reuse, fp_buffer_traffic
from .scheduling import (
    LanePlan,
    brute_force_hamilton_path,
    lane_assignment,
    naive_lane_assignment,
    shortest_hamilton_path,
    similarity_matrix,
    similarity_schedule,
)

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
    "project_dst_coefficients",
    "MULTILANE_BACKENDS",
    "MultiLanePlan",
    "build_multilane_plan",
    "multilane_na",
    "multilane_na_sharded",
    "resolve_multilane_backend",
    "FPTraffic",
    "ReuseCounters",
    "count_reuse",
    "fp_buffer_traffic",
    "LanePlan",
    "brute_force_hamilton_path",
    "lane_assignment",
    "naive_lane_assignment",
    "shortest_hamilton_path",
    "similarity_matrix",
    "similarity_schedule",
]
