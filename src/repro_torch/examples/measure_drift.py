"""Measured-plan profiler: close the loop from the cost model to the card.

The tuner ranks tile plans by an analytic model (``plan.t_model``, the
port's H100 profile). This example holds it against the stopwatch (CUDA
events on the card) in two acts:

  * **Act 1, guided refinement of one layer.**
    :func:`repro_torch.obs.refine_plan` times the top-2 plans of the
    modelled shortlist for AlexNet's first conv layer (guided, never
    exhaustive) with the trimmed-mean harness, and reports the measured
    winner beside the model's pick.

  * **Act 2, drift over the whole pipeline.**
    ``compile_cnn(measure=True)`` times every resolved conv and GEMM plan
    and records ``t_measured`` and the backend fingerprint in the plan
    table (format 3). From that table:
      - ``drift.json``: the ``repro_torch.obs.drift`` report (a measured /
        modelled ratio a plan, and their aggregate), checked by
        ``validate_drift``;
      - ``drift_metrics.json`` / ``.prom``: the same numbers as registry
        gauges and a factor-2 ratio histogram;
      - ``compile_trace.json``: the compile track's ``sweep`` and
        ``measure`` spans (open in Perfetto);
      - and the seeded-compile contract: recompiling from the measured
        table runs no measurement (even with ``measure=True``) and
        reproduces the table byte for byte.

The stopwatch is the card's: on a CPU device the measure functions raise
(the tests stand a fixed timer in for them).

Run:  PYTHONPATH=src python -m repro_torch.examples.measure_drift
      [--out DIR]
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import torch

from repro_torch.configs import get_config
from repro_torch.examples import _common
from repro_torch.kernels import autotune
from repro_torch.obs import (MeasureOptions, MetricsRegistry, TraceRecorder,
                             drift_report, record_drift, refine_plan,
                             validate_drift)
from repro_torch.pipeline import ExecutionSpec, Serving, compile_cnn
from repro_torch.pipeline.compile import resolve_device

BATCH = 2


def refine_one_layer(cfg, dev):
    """Act 1: measured refinement over the top-2 modelled plans of the
    first conv layer. Returns ``(shape, best, records)``."""
    l = cfg.layers[0]
    shape = autotune.ConvShape(
        h=cfg.input_hw, w=cfg.input_hw, c=cfg.input_ch, kh=l.kernel,
        kw=l.kernel, m=l.out_ch, stride=l.stride, pad=l.pad, b=BATCH)
    opts = MeasureOptions(warmup=1, iters=1, repeats=3, trim=1)
    best, records = refine_plan(shape, top_k=2, opts=opts, device=dev)
    assert len(records) == 2, records       # guided: K plans, no more
    return shape, best, records


def measured_compile(cfg, dev, outdir=None):
    """Act 2: one measured cold compile -> every drift output. Returns
    ``(compiled, report, stats, trace)``; asserts the seeded-compile
    contract on the way."""
    spec = ExecutionSpec(serving=Serving(batch=BATCH, clock="modeled"))
    opts = MeasureOptions(warmup=1, iters=1, repeats=1, trim=0)
    trace = TraceRecorder()

    autotune.clear_registry()
    autotune.reset_measure_stats()
    compiled = compile_cnn(cfg, spec, measure=True, measure_opts=opts,
                           trace=trace, device=dev,
                           generator=torch.Generator(dev).manual_seed(0))
    stats = autotune.measure_stats()
    table = compiled.plan_table
    report = drift_report(table)

    # full coverage, exact reconciliation with the table
    assert report["n_measured"] == report["n_plans"] > 0, report
    errs = validate_drift(report, table=json.loads(table.to_json()))
    assert not errs, errs

    # the seeded-compile contract: the measured table is an artifact, not
    # a trigger (no measurement, a byte-identical table)
    autotune.reset_measure_stats()
    warm = compile_cnn(cfg, spec, plans=table, measure=True,
                       measure_opts=opts, device=dev,
                       generator=torch.Generator(dev).manual_seed(0))
    assert sum(autotune.measure_stats().values()) == 0
    assert warm.plan_table.to_json() == table.to_json()

    if outdir is not None:
        out = Path(outdir)
        out.mkdir(parents=True, exist_ok=True)
        compiled.save_plan(str(out / "plan_table.json"))
        (out / "drift.json").write_text(
            json.dumps(report, sort_keys=True, indent=1) + "\n")
        reg = MetricsRegistry()
        record_drift(reg, report)
        reg.save(out / "drift_metrics.json")
        reg.save(out / "drift_metrics.prom")
        trace.save(out / "compile_trace.json")
    return compiled, report, stats, trace


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples."
                                      "measure_drift", description=__doc__)
    _common.add_device_arg(ap, out=True)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    outdir = _common.out_dir(args, "measure_drift")
    cfg = get_config("alexnet").smoke()
    where = _common.where(dev)

    shape, best, records = refine_one_layer(cfg, dev)
    print(f"measure_drift act 1: top-2 refinement on conv1 "
          f"{shape.h}x{shape.w}x{shape.c}->m{shape.m} b{shape.b} on {where}")
    for r in records:
        tag = "model pick" if r["model_pick"] else f"rank {r['rank_model']}"
        print(f"  {tag:<10} plan {r['plan']}  "
              f"model {r['t_model_call'] * 1e6:9.1f}us  "
              f"measured {r['t_measured'] * 1e6:9.1f}us")
    win = min(records, key=lambda r: r["t_measured"])
    print(f"  measured winner: rank {win['rank_model']} "
          f"({'the' if win['model_pick'] else 'NOT the'} model pick), "
          f"plan {best.to_dict()}")

    _, report, stats, trace = measured_compile(cfg, dev, outdir)
    meas = report["measurement"]
    ratio = report["ratio"]
    print(f"\nmeasure_drift act 2: measured compile of alexnet smoke")
    print(f"  coverage: {report['n_measured']}/{report['n_plans']} plans "
          f"measured ({stats['conv_measured']} conv + "
          f"{stats['gemm_measured']} gemm timings)")
    print(f"  backend:  {meas['backend']['platform']}/"
          f"{meas['backend'].get('device', '?')} "
          f"({meas['backend']['timer']}) on {where}")
    print(f"  drift:    geomean {ratio['geomean']:.3g}x "
          f"(min {ratio['min']:.3g}x, max {ratio['max']:.3g}x)")
    spans = [e for e in json.loads(trace.to_json())["traceEvents"]
             if e.get("ph") == "X"]
    print(f"  trace:    {len(spans)} compile spans "
          f"({sum(1 for e in spans if e['name'] == 'measure')} measure) "
          f"-> {outdir}/compile_trace.json")
    print("  seeded recompile: 0 measurements, byte-identical table")
    print(f"  outputs -> {outdir}/plan_table.json, drift.json, "
          f"drift_metrics.json, drift_metrics.prom")
    print("measure_drift OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
