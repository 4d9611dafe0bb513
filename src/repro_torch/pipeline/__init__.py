"""The compile-once API of the port: ``compile_cnn(cfg, spec)``."""
from repro_torch.core.config import SpecError
from repro_torch.pipeline.compile import (CompiledCNN, compile_cnn,
                                          resolve_device)
from repro_torch.pipeline.plan_table import PlanTable, load_plan, plan_key
from repro_torch.pipeline.spec import (ExecutionSpec, Placement, Precision,
                                       Serving, Tiling)

__all__ = ["CompiledCNN", "ExecutionSpec", "Placement", "PlanTable",
           "Precision", "Serving", "SpecError", "Tiling", "compile_cnn",
           "load_plan", "plan_key", "resolve_device"]
