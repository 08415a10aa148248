"""Training checkpoints: save, resume-from-latest."""

from imagegenerator_tpu_torch.checkpoint.manager import CheckpointManager

__all__ = ["CheckpointManager"]
