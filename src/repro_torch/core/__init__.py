"""Configuration records of the port."""
from repro_torch.core.config import (FAMILIES, SHAPES, CNNConfig, ConvLayer,
                                     ModelConfig, ShapeSpec, SpecError,
                                     applicable_shapes, flops_per_image,
                                     fuse_groups, get_shape)

__all__ = ["CNNConfig", "ConvLayer", "FAMILIES", "ModelConfig", "SHAPES",
           "ShapeSpec", "SpecError", "applicable_shapes", "flops_per_image",
           "fuse_groups", "get_shape"]
