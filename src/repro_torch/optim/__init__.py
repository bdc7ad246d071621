from .adamw import (
    AdamWConfig,
    apply_updates,
    apply_updates_,
    global_norm,
    init_opt_state,
    opt_state_axes,
)
from .schedules import warmup_cosine

__all__ = ["AdamWConfig", "apply_updates", "apply_updates_", "global_norm", "init_opt_state",
           "opt_state_axes", "warmup_cosine"]
