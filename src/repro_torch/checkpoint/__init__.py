from .io import (
    broadcast_from_writer,
    latest_step,
    logical_state,
    read_leaves,
    reshard_to,
    restore_checkpoint,
    save_checkpoint,
    writes_checkpoints,
)

__all__ = ["broadcast_from_writer", "latest_step", "logical_state", "read_leaves", "reshard_to",
           "restore_checkpoint", "save_checkpoint", "writes_checkpoints"]
