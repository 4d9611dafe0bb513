"""The compile-once API of the port: ``compile_cnn(cfg, spec)``."""
from repro_torch.core.config import SpecError
from repro_torch.pipeline.compile import (CompiledCNN, compile_cnn,
                                          resolve_device)
from repro_torch.pipeline.spec import (ExecutionSpec, Placement, Precision,
                                       Serving)

__all__ = ["CompiledCNN", "ExecutionSpec", "Placement", "Precision",
           "Serving", "SpecError", "compile_cnn", "resolve_device"]
