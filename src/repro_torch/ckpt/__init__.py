"""Crash-safe directory commits (the protocol the serving artifact is
written under). The rest of the JAX package's ``ckpt/`` (training
checkpoints) comes with ROADMAP.md Queue 1 slice 8."""
from repro_torch.ckpt.checkpoint import (CheckpointError, clean_stale_tmp,
                                         commit_dir)

__all__ = ["CheckpointError", "clean_stale_tmp", "commit_dir"]
