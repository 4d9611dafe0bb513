"""The compile-once API of the port: ``compile_cnn(cfg, spec)``."""
from repro_torch.core.config import SpecError
from repro_torch.pipeline.compile import (CompiledCNN, compile_cnn,
                                          resolve_device)
from repro_torch.pipeline.plan_table import PlanTable, load_plan, plan_key
from repro_torch.pipeline.spec import (AutoscalePolicy, ExecutionSpec,
                                       Placement, Precision, Serving, Tiling,
                                       resolve_config, spec_from_config)

__all__ = ["AutoscalePolicy", "CompiledCNN", "ExecutionSpec", "Placement",
           "PlanTable", "Precision", "Serving", "SpecError", "Tiling",
           "compile_cnn", "load_plan", "plan_key", "resolve_config",
           "resolve_device", "spec_from_config"]
