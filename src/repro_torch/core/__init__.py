"""Configuration records of the port."""
from repro_torch.core.config import (CNNConfig, ConvLayer, SpecError,
                                     flops_per_image, fuse_groups)

__all__ = ["CNNConfig", "ConvLayer", "SpecError", "flops_per_image",
           "fuse_groups"]
