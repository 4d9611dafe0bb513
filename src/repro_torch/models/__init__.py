"""The paper's CNNs as a fold over fused pipeline groups."""
