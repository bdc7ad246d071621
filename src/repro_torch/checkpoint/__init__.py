from .io import latest_step, reshard_to, restore_checkpoint, save_checkpoint, writes_checkpoints

__all__ = ["latest_step", "reshard_to", "restore_checkpoint", "save_checkpoint",
           "writes_checkpoints"]
