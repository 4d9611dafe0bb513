"""Configuration records of the port."""
from repro_torch.core.config import (FAMILIES, CNNConfig, ConvLayer,
                                     ModelConfig, SpecError, flops_per_image,
                                     fuse_groups)

__all__ = ["CNNConfig", "ConvLayer", "FAMILIES", "ModelConfig", "SpecError",
           "flops_per_image", "fuse_groups"]
