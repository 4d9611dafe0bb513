"""Measured against modelled time: the drift report over a plan table.

The port's copy of the JAX package's ``obs/drift.py``. A format-3 plan
table carries, a plan, the card's cost-model time the DSE priced it at and
the time :mod:`repro_torch.obs.profiler` measured on the card. This module
turns one table into a drift report (one ``ratio = t_measured /
t_model_call`` row a plan, plus min / median / geomean / max of the
ratios) and feeds the same numbers into a
:class:`~repro_torch.obs.metrics.MetricsRegistry` as gauges and a factor-2
ratio histogram.

The report is JSON to JSON (it reads the table document, not live
kernels), so it runs anywhere, the CLI included::

    python -m repro_torch.obs.drift plan_table.json [--json OUT]
                                                    [--metrics OUT[.prom]]

Its counts reconcile exactly with the table (one row a plan entry,
measured or not); :func:`repro_torch.obs.validate.validate_drift` checks
that. A ratio means something only beside the card it was measured on,
``report["measurement"]["backend"]`` (the port's fingerprint: the card's
name, capability, SM count, torch and CUDA versions).
"""
from __future__ import annotations

import json
import math
from typing import List, Optional

__all__ = [
    "DRIFT_RATIO_BUCKETS",
    "drift_report",
    "format_drift",
    "record_drift",
]

# Factor-2 buckets centred on ratio 1 (1/64x .. 64x): drift is
# multiplicative, so the histogram is log-spaced like the latency one.
DRIFT_RATIO_BUCKETS = tuple(2.0 ** k for k in range(-6, 7))


def _table_doc(table) -> dict:
    """Accept a PlanTable object, its JSON text, or its parsed dict."""
    if hasattr(table, "to_json"):
        return json.loads(table.to_json())
    if isinstance(table, str):
        return json.loads(table)
    return table


def drift_report(table) -> dict:
    """One plan-table document -> the drift report document.

    One row per plan entry (kind, shape, plan, modeled per-call time,
    measured time or ``None``, ratio or ``None``), exact counts, the
    table's measurement provenance, and ratio statistics (min / median /
    geomean / max over the measured rows). ``t_model_call`` prefers the
    per-call figure stored with the measurement; an unmeasured row's is
    its plan's ``t_model`` (a conv's per image, times the batch).
    """
    doc = _table_doc(table)
    rows: List[dict] = []
    counts = {"conv": len(doc.get("conv", [])),
              "gemm": len(doc.get("gemm", [])),
              "conv_measured": 0, "gemm_measured": 0}
    for kind in ("conv", "gemm"):
        for r in doc.get(kind, []):
            m = r.get("measured")
            scale = r["shape"].get("b", 1) if kind == "conv" else 1
            t_model_call = r["plan"]["t_model"] * scale
            entry = {"kind": kind, "shape": r["shape"],
                     "plan": r["plan"],
                     "t_model_call": t_model_call,
                     "t_measured": None, "ratio": None}
            if m is not None:
                counts[f"{kind}_measured"] += 1
                t_model_call = m.get("t_model_call", t_model_call)
                entry["t_model_call"] = t_model_call
                entry["t_measured"] = m["t_measured"]
                if "interpret" in m:     # a JAX table's harness mode
                    entry["interpret"] = m["interpret"]
                if t_model_call > 0:
                    entry["ratio"] = m["t_measured"] / t_model_call
            rows.append(entry)
    ratios = sorted(e["ratio"] for e in rows if e["ratio"] is not None)
    stats = None
    if ratios:
        stats = {"min": ratios[0], "max": ratios[-1],
                 "median": ratios[(len(ratios) - 1) // 2],
                 "geomean": math.exp(sum(math.log(v) for v in ratios)
                                     / len(ratios)),
                 "n": len(ratios)}
    n_measured = counts["conv_measured"] + counts["gemm_measured"]
    return {"format": 1,
            "n_plans": counts["conv"] + counts["gemm"],
            "n_measured": n_measured,
            "n_unmeasured": counts["conv"] + counts["gemm"] - n_measured,
            "counts": counts,
            "measurement": (doc.get("provenance") or {}).get(
                "measurement"),
            "ratio": stats,
            "rows": rows}


def record_drift(metrics, report: dict) -> None:
    """Feed a drift report into a :class:`MetricsRegistry`.

    Gauges for the coverage counts and ratio statistics, plus a factor-2
    ``plan_drift_ratio`` histogram over the per-plan ratios, exported by
    the same ``to_json`` / ``to_prometheus`` as the serving metrics.
    """
    metrics.gauge("drift_plans_total",
                  "plan entries in the table").set(report["n_plans"])
    metrics.gauge("drift_plans_measured",
                  "plan entries with t_measured").set(report["n_measured"])
    stats = report.get("ratio")
    if stats:
        for k in ("min", "median", "geomean", "max"):
            metrics.gauge(f"drift_ratio_{k}",
                          f"{k} measured/modeled ratio").set(stats[k])
    hist = metrics.histogram(
        "plan_drift_ratio", "measured/modeled time ratio per plan",
        buckets=DRIFT_RATIO_BUCKETS)
    for row in report["rows"]:
        if row["ratio"] is not None:
            hist.observe(row["ratio"])


def _shape_label(row: dict) -> str:
    s = row["shape"]
    if row["kind"] == "conv":
        return (f"conv {s['h']}x{s['w']}x{s['c']}->m{s['m']} "
                f"k{s['kh']} b{s.get('b', 1)} {s.get('dtype', 'f32')}")
    return f"gemm {s['m']}x{s['k']}x{s['n']} {s.get('dtype', 'f32')}"


def format_drift(report: dict) -> str:
    """Human-readable drift table (the CLI's stdout)."""
    lines = [f"plans: {report['n_plans']} "
             f"({report['n_measured']} measured, "
             f"{report['n_unmeasured']} unmeasured)"]
    meas = report.get("measurement")
    if meas:
        b = meas.get("backend", {})
        lines.append(
            f"backend: {b.get('platform')}/{b.get('device')} "
            f"sm {b.get('capability')} x{b.get('sms')} torch "
            f"{b.get('torch')} cuda {b.get('cuda')} timer={b.get('timer')} "
            f"harness={meas.get('harness')}")
    for row in report["rows"]:
        if row["t_measured"] is None:
            lines.append(f"  {_shape_label(row):<44} "
                         f"model {row['t_model_call'] * 1e6:9.1f}us  "
                         f"(unmeasured)")
        else:
            lines.append(f"  {_shape_label(row):<44} "
                         f"model {row['t_model_call'] * 1e6:9.1f}us  "
                         f"measured {row['t_measured'] * 1e6:9.1f}us  "
                         f"ratio {row['ratio']:8.2f}x")
    stats = report.get("ratio")
    if stats:
        lines.append(
            f"ratio: min {stats['min']:.2f}x  median "
            f"{stats['median']:.2f}x  geomean {stats['geomean']:.2f}x  "
            f"max {stats['max']:.2f}x  (n={stats['n']})")
    return "\n".join(lines)


def main(argv: Optional[list] = None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.drift",
        description="measured-vs-modeled drift report over a plan table")
    ap.add_argument("plan_table",
                    help="PlanTable JSON (CompiledCNN.save_plan output; "
                         "format 3, from compile_cnn(measure=True), carries "
                         "the card's measurements)")
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="write the report document as JSON")
    ap.add_argument("--metrics", metavar="PATH", default=None,
                    help="export drift gauges + ratio histogram via "
                         "MetricsRegistry (.prom suffix for Prometheus "
                         "text)")
    args = ap.parse_args(argv)

    with open(args.plan_table) as f:
        doc = json.load(f)
    report = drift_report(doc)

    from repro_torch.obs.validate import validate_drift
    errors = validate_drift(report, table=doc)

    print(f"[obs.drift] {args.plan_table}:")
    print(format_drift(report))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, sort_keys=True, indent=1)
            f.write("\n")
        print(f"[obs.drift] report -> {args.json}")
    if args.metrics:
        from repro_torch.obs.metrics import MetricsRegistry
        reg = MetricsRegistry()
        record_drift(reg, report)
        reg.save(args.metrics)
        print(f"[obs.drift] metrics -> {args.metrics}")
    for e in errors:
        print(f"[obs.drift] ERROR: {e}")
    print(f"[obs.drift] {'FAIL' if errors else 'OK'}")
    return 1 if errors else 0


if __name__ == "__main__":
    raise SystemExit(main())
