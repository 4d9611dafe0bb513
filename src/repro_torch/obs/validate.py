"""Schema validation and reconciliation of the serving stack's outputs.

The port's copy of the JAX package's ``obs/validate.py``: four checks,
each a pure function returning a list of error strings (empty = valid),
and a CLI (``python -m repro_torch.obs.validate``):

  * :func:`validate_trace`: every span and instant is well-formed Chrome
    trace-event JSON (name/ph/ts/pid/tid present, durations >= 0), and
    timestamps are monotone non-decreasing a track in file order;
  * :func:`validate_metrics`: the snapshot is well-formed and consistent
    (a histogram's bucket counts sum to ``count``);
  * :func:`reconcile`: the three outputs of one run tell one story: trace
    event counts equal the report's counters (``n_done``/``n_steals``/
    ``n_retries``/``n_failed``/``scale_events``...), the metrics counters
    equal the same report fields, and the report's p50/p95 fall inside
    the latency histogram's nearest-rank bucket;
  * :func:`validate_drift`: a :mod:`repro_torch.obs.drift` report is
    consistent (counts add up, every measured row's ratio is
    ``t_measured / t_model_call``) and, given the plan-table document it
    came from, reconciles with it exactly: one row a plan entry, measured
    rows matching the table's ``measured`` records one for one;

plus :func:`validate_analysis`, the schema of a static-analysis report
(:func:`repro_torch.analysis.findings.report_doc`).

Self-contained on purpose: it imports nothing of ``repro_torch.serve``
(the serving loops import ``repro_torch.obs``), so it checks outputs of
another process or commit as well.
"""
from __future__ import annotations

import json
import math
from typing import List

# Event names whose trace counts must equal a FleetReport counter.
_TRACE_VS_REPORT = (
    ("request", "n_done"),
    ("steal", "n_steals"),
    ("retry", "n_retries"),
    ("failed", "n_failed"),
    ("fail", "n_failures"),
    ("recover", "n_recoveries"),
    ("scale_up", "n_scale_up"),
    ("scale_down", "n_scale_down"),
)

# Metrics counters whose values must equal a FleetReport field.
_METRICS_VS_REPORT = (
    ("serve_done_total", "n_done"),
    ("serve_failed_total", "n_failed"),
    ("serve_rejected_total", "n_rejected"),
    ("serve_retries_total", "n_retries"),
    ("serve_steals_total", "n_steals"),
    ("serve_failures_total", "n_failures"),
    ("serve_recoveries_total", "n_recoveries"),
    ("serve_swapped_total", "n_swapped"),
    ("serve_scale_up_total", "n_scale_up"),
    ("serve_scale_down_total", "n_scale_down"),
    ("serve_rounds_total", "rounds"),
)


def validate_trace(doc: dict) -> List[str]:
    """Well-formedness of a Chrome trace-event document."""
    errors: List[str] = []
    events = doc.get("traceEvents")
    if not isinstance(events, list):
        return ["traceEvents is not a list"]
    last_ts: dict = {}
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            errors.append(f"event[{i}]: not an object")
            continue
        ph = ev.get("ph")
        if ph not in ("X", "i", "M"):
            errors.append(f"event[{i}]: unknown ph {ph!r}")
            continue
        if not isinstance(ev.get("name"), str) or not ev["name"]:
            errors.append(f"event[{i}]: missing name")
        if not isinstance(ev.get("pid"), int) \
                or not isinstance(ev.get("tid"), int):
            errors.append(f"event[{i}]: pid/tid must be ints")
            continue
        if "args" in ev and not isinstance(ev["args"], dict):
            errors.append(f"event[{i}]: args must be an object")
        if ph == "M":
            continue                    # metadata events carry no ts
        ts = ev.get("ts")
        if not isinstance(ts, (int, float)) or ts < 0:
            errors.append(f"event[{i}]: bad ts {ts!r}")
            continue
        if ph == "X":
            dur = ev.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                errors.append(f"event[{i}]: span with bad dur {dur!r}")
        key = (ev["pid"], ev["tid"])
        if ts < last_ts.get(key, 0.0):
            errors.append(
                f"event[{i}] ({ev['name']}): ts {ts} < {last_ts[key]} — "
                f"track {key} not monotone")
        last_ts[key] = ts
    return errors


def validate_metrics(doc: dict) -> List[str]:
    """Well-formedness + internal consistency of a metrics snapshot."""
    errors: List[str] = []
    for section in ("counters", "gauges", "histograms", "windows"):
        if not isinstance(doc.get(section), dict):
            return [f"metrics snapshot missing section {section!r}"]
    for name, v in doc["counters"].items():
        if not isinstance(v, int) or v < 0:
            errors.append(f"counter {name}: {v!r} is not an int >= 0")
    for name, h in doc["histograms"].items():
        buckets, counts = h.get("buckets", []), h.get("counts", [])
        if len(counts) != len(buckets) + 1:
            errors.append(f"histogram {name}: {len(counts)} counts for "
                          f"{len(buckets)} buckets (want buckets+1)")
            continue
        if list(buckets) != sorted(buckets):
            errors.append(f"histogram {name}: bucket bounds not sorted")
        if sum(counts) != h.get("count"):
            errors.append(f"histogram {name}: bucket counts sum to "
                          f"{sum(counts)} != count {h.get('count')}")
    for name, w in doc["windows"].items():
        if len(w.get("values", [])) > w.get("size", 0):
            errors.append(f"window {name}: more values than its size")
    return errors


def _hist_percentile_bounds(h: dict, q: float):
    """(lo, hi] of the nearest-rank bucket in a snapshot histogram."""
    n = h["count"]
    if n == 0:
        return None
    rank = min(max(0, math.ceil(q * n) - 1), n - 1)
    cum = 0
    for i, c in enumerate(h["counts"]):
        cum += c
        if rank < cum:
            lo = h["buckets"][i - 1] if i > 0 else 0.0
            hi = (h["buckets"][i] if i < len(h["buckets"])
                  else float("inf"))
            return (lo, hi)
    return (h["buckets"][-1], float("inf"))


def reconcile(report: dict, trace: dict = None,
              metrics: dict = None) -> List[str]:
    """Cross-check the artifacts of one run against its report dict."""
    errors: List[str] = []
    if trace is not None:
        counts: dict = {}
        for ev in trace.get("traceEvents", ()):
            if ev.get("ph") in ("X", "i"):
                counts[ev["name"]] = counts.get(ev["name"], 0) + 1
        for ev_name, field in _TRACE_VS_REPORT:
            want = report.get(field, 0)
            got = counts.get(ev_name, 0)
            if got != want:
                errors.append(f"trace: {got} {ev_name!r} events != "
                              f"report.{field} {want}")
        n_scale = counts.get("scale_up", 0) + counts.get("scale_down", 0)
        if n_scale != len(report.get("scale_events", ())):
            errors.append(f"trace: {n_scale} scale instants != "
                          f"{len(report.get('scale_events', ()))} "
                          f"report.scale_events")
    if metrics is not None:
        for c_name, field in _METRICS_VS_REPORT:
            want = report.get(field, 0)
            got = metrics.get("counters", {}).get(c_name, 0)
            if got != want:
                errors.append(f"metrics: {c_name}={got} != "
                              f"report.{field} {want}")
        hist = metrics.get("histograms", {}).get("request_latency_seconds")
        if hist is not None and report.get("n_done", 0) > 0:
            for q, field in ((0.50, "p50_ms"), (0.95, "p95_ms")):
                bounds = _hist_percentile_bounds(hist, q)
                if bounds is None:
                    continue
                lo, hi = bounds
                v = report.get(field, float("nan")) / 1e3
                if not (lo - 1e-12 <= v <= hi + 1e-12):
                    errors.append(
                        f"metrics: report.{field} {v * 1e3:.3f} ms "
                        f"outside its histogram bucket "
                        f"({lo * 1e3:.3f}, {hi * 1e3:.3f}] ms")
    return errors


def validate_drift(report: dict, table: dict = None) -> List[str]:
    """Internal consistency of a drift report document, and — given the
    plan-table document it was derived from — exact reconciliation of
    the report's rows/counts against the table's plan entries."""
    errors: List[str] = []
    for field in ("n_plans", "n_measured", "n_unmeasured", "counts",
                  "rows"):
        if field not in report:
            return [f"drift report missing field {field!r}"]
    rows = report["rows"]
    counts = report["counts"]
    if report["n_plans"] != len(rows):
        errors.append(f"drift: n_plans {report['n_plans']} != "
                      f"{len(rows)} rows")
    if report["n_measured"] + report["n_unmeasured"] != report["n_plans"]:
        errors.append("drift: n_measured + n_unmeasured != n_plans")
    for kind in ("conv", "gemm"):
        n_kind = sum(1 for r in rows if r.get("kind") == kind)
        n_meas = sum(1 for r in rows if r.get("kind") == kind
                     and r.get("t_measured") is not None)
        if counts.get(kind) != n_kind:
            errors.append(f"drift: counts[{kind!r}] {counts.get(kind)} "
                          f"!= {n_kind} {kind} rows")
        if counts.get(f"{kind}_measured") != n_meas:
            errors.append(
                f"drift: counts[{kind}_measured] "
                f"{counts.get(f'{kind}_measured')} != {n_meas} measured "
                f"{kind} rows")
    for i, r in enumerate(rows):
        if r.get("kind") not in ("conv", "gemm"):
            errors.append(f"drift row[{i}]: bad kind {r.get('kind')!r}")
            continue
        tm = r.get("t_model_call")
        if not isinstance(tm, (int, float)) or tm <= 0:
            errors.append(f"drift row[{i}]: bad t_model_call {tm!r}")
            continue
        if r.get("t_measured") is None:
            if r.get("ratio") is not None:
                errors.append(f"drift row[{i}]: ratio without a "
                              f"measurement")
            continue
        if r["t_measured"] <= 0:
            errors.append(f"drift row[{i}]: t_measured "
                          f"{r['t_measured']!r} not > 0")
            continue
        want = r["t_measured"] / tm
        got = r.get("ratio")
        if got is None or abs(got - want) > 1e-9 * max(1.0, abs(want)):
            errors.append(f"drift row[{i}]: ratio {got!r} != "
                          f"t_measured/t_model_call {want!r}")
    if table is not None:
        for kind in ("conv", "gemm"):
            entries = table.get(kind, [])
            if counts.get(kind) != len(entries):
                errors.append(
                    f"drift vs table: counts[{kind!r}] "
                    f"{counts.get(kind)} != {len(entries)} table entries")
            n_meas_tbl = sum(1 for e in entries if "measured" in e)
            if counts.get(f"{kind}_measured") != n_meas_tbl:
                errors.append(
                    f"drift vs table: counts[{kind}_measured] "
                    f"{counts.get(f'{kind}_measured')} != {n_meas_tbl} "
                    f"measured table entries")
            want_t = sorted(e["measured"]["t_measured"] for e in entries
                            if "measured" in e)
            got_t = sorted(r["t_measured"] for r in rows
                           if r.get("kind") == kind
                           and r.get("t_measured") is not None)
            if want_t != got_t:
                errors.append(f"drift vs table: measured {kind} times "
                              f"do not match the table's records")
    return errors


def validate_analysis(doc: dict) -> List[str]:
    """Schema-check a static-analysis report document: the tool and
    format stamp, findings carrying well-formed ``RPA<nnn>`` codes and
    locators, and counts that agree with the lists they summarise."""
    import re as _re

    errors: List[str] = []
    if doc.get("tool") != "repro_torch.analysis":
        errors.append(f"analysis: tool={doc.get('tool')!r}, expected "
                      f"'repro_torch.analysis'")
    if doc.get("format") != 1:
        errors.append(f"analysis: format={doc.get('format')!r}, this "
                      f"validator understands 1")
    for section in ("findings", "baselined"):
        items = doc.get(section)
        if not isinstance(items, list):
            errors.append(f"analysis: {section} is not a list")
            continue
        for i, f in enumerate(items):
            if not isinstance(f, dict):
                errors.append(f"analysis: {section}[{i}] not a dict")
                continue
            code = f.get("code", "")
            if not _re.fullmatch(r"RPA\d{3}", str(code)):
                errors.append(f"analysis: {section}[{i}] code "
                              f"{code!r} is not an RPA<nnn> rule id")
            if not isinstance(f.get("path"), str) or not f.get("path"):
                errors.append(f"analysis: {section}[{i}] has no path")
            if not isinstance(f.get("line"), int) or f.get("line", -1) < 0:
                errors.append(f"analysis: {section}[{i}] line "
                              f"{f.get('line')!r} is not an int >= 0")
            if not isinstance(f.get("message"), str) or not f.get("message"):
                errors.append(f"analysis: {section}[{i}] has no message")
    n = doc.get("n_findings")
    if isinstance(doc.get("findings"), list) and n != len(doc["findings"]):
        errors.append(f"analysis: n_findings={n} but "
                      f"{len(doc['findings'])} findings listed")
    nb = doc.get("n_baselined")
    if isinstance(doc.get("baselined"), list) and nb != len(doc["baselined"]):
        errors.append(f"analysis: n_baselined={nb} but "
                      f"{len(doc['baselined'])} baselined listed")
    for head in ("lint", "verify"):
        meta = doc.get(head)
        if meta is not None and not isinstance(meta, dict):
            errors.append(f"analysis: {head} section is not a dict/null")
    return errors


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.obs.validate",
        description="validate the serving stack's trace, metrics, report, "
                    "drift and analysis documents")
    ap.add_argument("--trace", help="Chrome trace-event JSON path")
    ap.add_argument("--metrics", help="metrics snapshot JSON path")
    ap.add_argument("--report", help="FleetReport.to_dict() JSON path")
    ap.add_argument("--drift", help="repro_torch.obs.drift report JSON path")
    ap.add_argument("--plan-table",
                    help="plan table JSON to reconcile --drift against")
    ap.add_argument("--analysis",
                    help="static-analysis report JSON path")
    args = ap.parse_args(argv)

    def load(path):
        with open(path) as f:
            return json.load(f)

    errors: List[str] = []
    trace = metrics = None
    if args.trace:
        trace = load(args.trace)
        errs = validate_trace(trace)
        errors += errs
        n = len(trace.get("traceEvents", ()))
        print(f"[obs.validate] trace {args.trace}: {n} events, "
              f"{len(errs)} errors")
    if args.metrics:
        metrics = load(args.metrics)
        errs = validate_metrics(metrics)
        errors += errs
        print(f"[obs.validate] metrics {args.metrics}: "
              f"{len(metrics.get('counters', {}))} counters, "
              f"{len(errs)} errors")
    if args.report:
        report = load(args.report)
        errs = reconcile(report, trace=trace, metrics=metrics)
        errors += errs
        print(f"[obs.validate] reconcile vs {args.report}: "
              f"{len(errs)} errors")
    if args.drift:
        drift = load(args.drift)
        table = load(args.plan_table) if args.plan_table else None
        errs = validate_drift(drift, table=table)
        errors += errs
        print(f"[obs.validate] drift {args.drift}: "
              f"{drift.get('n_measured', 0)}/{drift.get('n_plans', 0)} "
              f"plans measured"
              + (f", reconciled vs {args.plan_table}"
                 if args.plan_table else "")
              + f", {len(errs)} errors")
    if args.analysis:
        analysis = load(args.analysis)
        errs = validate_analysis(analysis)
        errors += errs
        print(f"[obs.validate] analysis {args.analysis}: "
              f"{analysis.get('n_findings', 0)} findings, "
              f"{analysis.get('n_baselined', 0)} baselined, "
              f"{len(errs)} errors")
    for e in errors:
        print(f"[obs.validate] ERROR: {e}")
    print(f"[obs.validate] {'FAIL' if errors else 'OK'}")
    return 1 if errors else 0


if __name__ == "__main__":
    raise SystemExit(main())
