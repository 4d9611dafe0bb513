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
    "lrn_q",
    "pool_q",
    "quantize_q",
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
    # the int8 fold's glue, which XLA fuses in the JAX package and the port
    # dispatches to its kernels (kernels/codes.py, lrn_pwl's int8 mode)
    "OPS_SURFACE": {"lrn_q", "pool_q", "quantize_q"},
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


# -- slice 8c: the sharding and dry-run modules against their JAX twins ------
# (the JAX modules are read by AST, not imported: repro.launch.dryrun
# forces 512 host devices when imported)

def _public(path):
    tree = ast.parse(path.read_text())
    names = set()
    for n in tree.body:
        if isinstance(n, (ast.FunctionDef, ast.ClassDef)):
            names.add(n.name)
        elif isinstance(n, ast.Assign):
            names.update(t.id for t in n.targets if isinstance(t, ast.Name))
    return {n for n in names if not n.startswith("_")}


# module -> (JAX names left out, port-only names), each named for a reason
SLICE_8C = {
    # the port's DTensor layer: the NamedSharding record, the spec tuple,
    # placements and the explicit redistributes DTensor needs where GSPMD
    # reshards on its own (align, flatten, full, per_shard with its
    # per-argument cuts and offsets, put_prefix, take_last, take_rows,
    # unflatten, unshard), the products and splits laid out as GSPMD lays them
    # (matmul, chunk), and the groups of ranks that share a head's P
    # (pieces, parts_group, group_sum, group_gather)
    "parallel/sharding": (set(), {
        "NamedSharding", "Spec", "align", "chunk", "flatten", "full",
        "group_gather", "group_sum", "matmul", "mesh_shape", "parts_group",
        "per_shard", "pieces", "placements", "put_prefix", "take_last",
        "take_rows", "unflatten", "unshard"}),
    # compat_make_mesh is JAX's AxisType shim; make_mesh is its twin over
    # the fake process group, teardown frees a process's one default group
    "launch/mesh": ({"compat_make_mesh"}, {"make_mesh", "teardown"}),
    # run_cell_scaled (and --scaled/--unroll) extrapolates XLA's
    # once-counted scan bodies; the port's trace runs every layer
    "launch/dryrun": ({"run_cell_scaled"}, {"cell_rules", "trace_cell"}),
    "launch/hillclimb": (set(), set()),
    # the partial and its one-process combine, for one card
    "parallel/collectives": (set(), {"sp_decode_combine",
                                     "sp_decode_partial"}),
    # the TPU v5e constants and the XLA readers have no meaning on the
    # card; the port's rates, its profile, the trace counter and the call
    # site it files each collective under
    "core/roofline": (
        {"HBM_BW", "ICI_BW", "MXU_DIM", "PEAK_FLOPS", "PEAK_OPS_INT8",
         "VMEM_BYTES", "analyze_compiled", "collective_bytes_from_hlo",
         "cost_analysis_dict", "mxu_utilization", "peak_ops"},
        {"COLLECTIVES", "DeviceProfile", "H100", "KINDS", "MEM_BW",
         "NVLINK_BW", "PRODUCTS", "TraceCounter", "analyze_trace",
         "call_site", "device_profile", "profile_for"}),
    # the heterogeneous-stage entry point is the serving engine's
    # gpipe_schedule
    "parallel/pipeline_par": ({"pipeline_forward_stages"},
                              {"gpipe_schedule"}),
}


@pytest.mark.parametrize("module", sorted(SLICE_8C))
def test_slice8c_module_differs_from_jax_only_by_name(module):
    jax_names = _public(REPO / "src" / "repro" / f"{module}.py")
    port_names = _public(REPO / "src" / "repro_torch" / f"{module}.py")
    left_out, port_only = SLICE_8C[module]
    assert jax_names - port_names == left_out
    assert port_names - jax_names == port_only
