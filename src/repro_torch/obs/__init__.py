"""Observability of the port, for the serving and the compile stacks.

Five modules. ``trace``, ``metrics`` and ``validate`` depend on nothing
else of ``repro_torch`` (the serving loops import them, and this package
imports nothing of ``repro_torch.serve``); ``profiler`` reaches into the
kernel layer, and only when a measurement runs:

  * :mod:`repro_torch.obs.trace`: :class:`TraceRecorder`, Chrome
    trace-event JSON (Perfetto), byte-deterministic on the modelled clock,
    with the compile phase's ``sweep`` / ``measure`` spans on the
    ``compile`` track, and the gang loop's host spans on the epoch clock
    (``host_spans``);
  * :mod:`repro_torch.obs.metrics`: :class:`MetricsRegistry` of counters,
    gauges, histograms and windows; JSON and Prometheus text;
  * :mod:`repro_torch.obs.profiler`: plans timed on the card (CUDA
    events), ``refine_plan`` and ``profile_table`` behind
    ``compile_cnn(measure=True)``;
  * :mod:`repro_torch.obs.drift`: measured-against-modelled drift reports
    over a format-3 plan table, and their gauges and ratio histogram (a
    CLI: ``python -m repro_torch.obs.drift``);
  * :mod:`repro_torch.obs.validate`: schema checks, trace / metrics /
    ``FleetReport`` reconciliation and drift / plan-table reconciliation
    (a CLI: ``python -m repro_torch.obs.validate``).
"""
from repro_torch.obs.trace import (  # noqa: F401
    CAT_COMPILE,
    CAT_FLEET,
    CAT_REQUEST,
    CAT_ROUND,
    COMPILE_TRACK,
    FLEET_TRACK,
    TraceRecorder,
)
from repro_torch.obs.metrics import (  # noqa: F401
    DEFAULT_LATENCY_BUCKETS,
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    WindowSeries,
    record_report,
)
from repro_torch.obs.profiler import (  # noqa: F401
    MeasureOptions,
    backend_fingerprint,
    clear_measure_cache,
    measure_record,
    profile_table,
    refine_plan,
    shortlist,
)
from repro_torch.obs.drift import (  # noqa: F401
    DRIFT_RATIO_BUCKETS,
    drift_report,
    format_drift,
    record_drift,
)
from repro_torch.obs.validate import (  # noqa: F401
    reconcile,
    validate_analysis,
    validate_drift,
    validate_metrics,
    validate_trace,
)

__all__ = [
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
]
