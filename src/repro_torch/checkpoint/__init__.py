from .io import latest_step, restore_checkpoint, save_checkpoint

__all__ = ["latest_step", "restore_checkpoint", "save_checkpoint"]
