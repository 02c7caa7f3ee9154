"""repro_torch.checkpoint — sharded, async, fault-tolerant checkpoints."""
from .store import CheckpointManager, restore_latest, save_checkpoint

__all__ = ["CheckpointManager", "save_checkpoint", "restore_latest"]
