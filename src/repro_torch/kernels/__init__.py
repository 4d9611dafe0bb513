"""The fused kernels of the PipeCNN pipeline (``csrc/*.cu``), their plain
PyTorch versions, the exact oracles (:mod:`.ref`) and the dispatch the
model calls (:mod:`.ops`)."""
