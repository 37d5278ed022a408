"""Parameter checkpoints in the reference's on-disk layout."""
from repro_torch.checkpoint.ckpt import latest_step, restore, save

__all__ = ["latest_step", "restore", "save"]
