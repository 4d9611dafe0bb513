"""Public-API surface snapshot of the port.

Pins the exported names of the port's entry-point modules, as
``tests/test_api_surface.py`` pins the JAX package's, so a refactor
cannot silently drop or rename an entry point. The port's lint (RPA203,
``repro_torch.analysis.lint.check_api_snapshots``) cross-checks these
literal sets against the modules' ``__all__``. Each set is also held
against the JAX snapshot (read from ``tests/test_api_surface.py`` by AST,
not imported): every difference is named below, as left out by design or
as the port's own.
"""
import ast
from pathlib import Path

import pytest

import repro_torch.kernels.autotune as autotune
import repro_torch.kernels.ops as ops
import repro_torch.obs as obs
import repro_torch.pipeline as pipeline

REPO = Path(__file__).resolve().parents[1]

PIPELINE_SURFACE = {
    "AutoscalePolicy",
    "CompiledCNN",
    "ExecutionSpec",
    "Placement",
    "PlanTable",
    "Precision",
    "Serving",
    "SpecError",
    "Tiling",
    "compile_cnn",
    "load_plan",
    "plan_key",
    "resolve_config",
    "resolve_device",
    "spec_from_config",
}

OBS_SURFACE = {
    "TraceRecorder",
    "CAT_REQUEST",
    "CAT_ROUND",
    "CAT_FLEET",
    "CAT_COMPILE",
    "FLEET_TRACK",
    "COMPILE_TRACK",
    "MetricsRegistry",
    "Counter",
    "Gauge",
    "Histogram",
    "WindowSeries",
    "DEFAULT_LATENCY_BUCKETS",
    "record_report",
    "MeasureOptions",
    "backend_fingerprint",
    "clear_measure_cache",
    "measure_record",
    "profile_table",
    "refine_plan",
    "shortlist",
    "DRIFT_RATIO_BUCKETS",
    "drift_report",
    "format_drift",
    "record_drift",
    "validate_trace",
    "validate_metrics",
    "validate_drift",
    "validate_analysis",
    "reconcile",
}

AUTOTUNE_SURFACE = {
    "ConvShape",
    "ConvPlan",
    "GemmShape",
    "GemmPlan",
    "conv_smem_bytes",
    "conv_bound",
    "plan_fits",
    "score_plan",
    "enumerate_plans",
    "best_plan",
    "rule_plan",
    "manual_plan",
    "gemm_smem_bytes",
    "gemm_bound",
    "gemm_plan_fits",
    "score_gemm_plan",
    "enumerate_gemm_plans",
    "best_gemm_plan",
    "rule_gemm_plan",
    "measure_plan",
    "measure_gemm_plan",
    "get_plan",
    "get_gemm_plan",
    "plan_for_layer",
    "gemm_plan_for_layer",
    "clear_registry",
    "registry_snapshot",
    "gemm_registry_snapshot",
    "seed_registry",
    "record_lookups",
    "sweep_stats",
    "reset_sweep_stats",
    "measure_stats",
    "reset_measure_stats",
    "count_measure_hit",
    "default_backend",
    "is_port_backend",
}

OPS_SURFACE = {
    "attention",
    "fc",
    "fc_q",
    "fused_conv",
    "fused_conv_q",
    "lrn",
}

# JAX names the port does not export, each for a reason of its design
LEFT_OUT_BY_DESIGN = {
    # the artifact functions are reached through CompiledCNN.save/.load
    "PIPELINE_SURFACE": {"load_artifact", "save_artifact"},
    "OBS_SURFACE": set(),
    # VMEM is a TPU budget (the port sizes shared memory); the registry
    # dump is a deprecated shim
    "AUTOTUNE_SURFACE": {"conv_vmem_bytes", "gemm_vmem_bytes",
                         "dump_registry"},
    # Pallas interpret mode has no CUDA meaning: a CPU tensor runs the
    # plain version
    "OPS_SURFACE": {"get_interpret", "interpret_mode", "set_interpret"},
}

# names only the port exports
PORT_ONLY = {
    "PIPELINE_SURFACE": {"plan_key", "resolve_device"},
    "OBS_SURFACE": {"format_drift"},
    "AUTOTUNE_SURFACE": {"conv_smem_bytes", "gemm_smem_bytes",
                         "conv_bound", "gemm_bound", "rule_plan",
                         "rule_gemm_plan", "manual_plan", "default_backend",
                         "is_port_backend"},
    "OPS_SURFACE": set(),
}

MODULES = {"PIPELINE_SURFACE": (pipeline, PIPELINE_SURFACE),
           "OBS_SURFACE": (obs, OBS_SURFACE),
           "AUTOTUNE_SURFACE": (autotune, AUTOTUNE_SURFACE),
           "OPS_SURFACE": (ops, OPS_SURFACE)}


def _jax_snapshot():
    tree = ast.parse((REPO / "tests" / "test_api_surface.py").read_text())
    return {n.targets[0].id: set(ast.literal_eval(n.value))
            for n in tree.body
            if isinstance(n, ast.Assign) and len(n.targets) == 1
            and isinstance(n.targets[0], ast.Name)
            and n.targets[0].id in MODULES}


@pytest.mark.parametrize("name", sorted(MODULES))
def test_port_exports_exactly_the_contract(name):
    mod, surface = MODULES[name]
    assert set(mod.__all__) == surface
    for n in surface:
        assert hasattr(mod, n), f"{mod.__name__}.{n} missing"


@pytest.mark.parametrize("name", sorted(MODULES))
def test_surface_differs_from_jax_only_by_name(name):
    jax_set = _jax_snapshot()[name]
    surface = MODULES[name][1]
    assert jax_set - surface == LEFT_OUT_BY_DESIGN[name]
    assert surface - jax_set == PORT_ONLY[name]


def test_compiled_cnn_runtime_surface():
    """The CompiledCNN method contract of the compile-once API, as JAX's."""
    for method in ("forward", "forward_stage", "serve", "plans",
                   "save_plan", "load_plan", "save", "load",
                   "roofline_breakdown", "verify"):
        assert callable(getattr(pipeline.CompiledCNN, method, None)), \
            f"CompiledCNN.{method} missing"
