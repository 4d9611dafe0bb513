"""Training checkpoints and crash-safe directory commits (the protocol
the serving artifact is written under too): the JAX package's ``ckpt/``."""
from repro_torch.ckpt.checkpoint import (CheckpointError, CheckpointManager,
                                         clean_stale_tmp, commit_dir,
                                         latest_step, load_checkpoint,
                                         save_checkpoint)

__all__ = ["CheckpointError", "CheckpointManager", "clean_stale_tmp",
           "commit_dir", "latest_step", "load_checkpoint", "save_checkpoint"]
