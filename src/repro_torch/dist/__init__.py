"""Distribution subsystem: logical-axis sharding rules (the counterpart of
``repro.dist``).

``sharding`` maps *logical* tensor axes (``"embed"``, ``"mlp"``,
``"lane"``, ...) onto the named dimensions of a ``torch.distributed``
device mesh (``"lane"``, ``"model"``, ...), and places and gathers the
leaves of a parameter tree by that map; it also holds the LM step's data
group (``use_data_group``, ``mean_over_data``).  Model code names logical axes
only; which mesh dimension a name lands on is decided once, at launch
time, by ``make_rules``.
"""
from .sharding import (
    ModelSplit,
    Rules,
    active_data_group,
    active_rules,
    data_sharded,
    gather_columns,
    gather_fsdp,
    gather_leaf,
    lane_axes,
    local_slice,
    make_rules,
    map_placements,
    mean_over_data,
    model_split,
    param_shardings,
    placement_leaves,
    shard,
    sum_cotangent,
    sum_partials,
    use_data_group,
    use_rules,
)

__all__ = [
    "ModelSplit",
    "Rules",
    "active_data_group",
    "active_rules",
    "data_sharded",
    "gather_columns",
    "gather_fsdp",
    "gather_leaf",
    "lane_axes",
    "local_slice",
    "make_rules",
    "map_placements",
    "mean_over_data",
    "model_split",
    "param_shardings",
    "placement_leaves",
    "shard",
    "sum_cotangent",
    "sum_partials",
    "use_data_group",
    "use_rules",
]
