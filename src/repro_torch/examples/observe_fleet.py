"""Observability: trace + metrics + report from one chaos run.

One continuous-batching fleet under an ``AutoscalePolicy`` and a seeded
stochastic fault schedule (``execute=False``: the port's H100 cost model
prices every slot on the modelled clock), instrumented with the port's
observability stack:

  * a :class:`repro_torch.obs.TraceRecorder` records the run as Chrome
    trace-event JSON: a track a replica of request spans, fleet-track
    instants for every fail/recover/steal/scale decision (open
    ``trace.json`` in Perfetto or ``chrome://tracing``);
  * a :class:`repro_torch.obs.MetricsRegistry` holds the counters the
    serve loop itself increments: the same objects the autoscaler reads
    and the :class:`FleetReport` is built from;
  * ``repro_torch.obs.reconcile`` proves the three agree: trace event
    counts = report counters = metrics counters, and the report's p50/p95
    inside the histogram's nearest-rank bucket.

The modelled clock makes it deterministic: ``run()`` twice gives the same
trace bytes. The trace is ``serve_elastic``'s.

Run:  PYTHONPATH=src python -m repro_torch.examples.observe_fleet
      [--device cpu] [--out DIR]
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from repro_torch.examples import _common
from repro_torch.examples.serve_elastic import (BATCH, bursty_requests,
                                                full_alexnet, phases_for)
from repro_torch.obs import (MetricsRegistry, TraceRecorder, reconcile,
                             validate_metrics, validate_trace)
from repro_torch.pipeline.compile import resolve_device
from repro_torch.serve import (AutoscalePolicy, FaultSchedule, ServeEngine,
                               total_cost)


def run(cfg, model, outdir=None):
    """One instrumented chaos + autoscale run. Writes ``trace.json``,
    ``metrics.json``, ``metrics.prom`` and ``report.json`` into ``outdir``
    (if given) and returns ``(trace, metrics, report)``."""
    tr = total_cost(cfg, BATCH)              # one modelled pipeline round
    cap2 = 2 * BATCH / tr                    # 2-replica service rate
    policy = AutoscalePolicy(min_replicas=2, max_replicas=6, interval=tr,
                             util_high=0.85, util_low=0.30)
    faults = FaultSchedule.mtbf(30 * tr, 4 * tr, 2, seed=1)
    eng = ServeEngine(model, batch=BATCH, replicas=2, clock="modeled",
                      execute=False, retries=2, scheduler="continuous",
                      steal_threshold=2, autoscale=policy)
    requests = bursty_requests(tr, cap2,
                               phases_for(tr, eng.t_restore_model))
    trace, metrics = TraceRecorder(), MetricsRegistry()
    done, rep = eng.serve(requests, faults=faults, trace=trace,
                          metrics=metrics)

    # nothing stranded, even under chaos and elasticity
    assert len(done) + rep.n_rejected == len(requests)
    # the three outputs are one set of books
    errs = (validate_trace(json.loads(trace.to_json()))
            + validate_metrics(json.loads(metrics.to_json()))
            + reconcile(rep.to_dict(), trace=json.loads(trace.to_json()),
                        metrics=json.loads(metrics.to_json())))
    assert not errs, errs

    if outdir is not None:
        out = Path(outdir)
        out.mkdir(parents=True, exist_ok=True)
        trace.save(out / "trace.json")
        metrics.save(out / "metrics.json")
        metrics.save(out / "metrics.prom")
        (out / "report.json").write_text(
            json.dumps(rep.to_dict(), sort_keys=True, indent=1) + "\n")
    return trace, metrics, rep


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples."
                                      "observe_fleet", description=__doc__)
    _common.add_device_arg(ap, out=True)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    outdir = _common.out_dir(args, "observe_fleet")

    cfg, model = full_alexnet(dev)
    trace, metrics, rep = run(cfg, model, outdir)
    print(f"observe_fleet (modelled clock; the fleet's model on "
          f"{_common.where(dev)}): {rep.summary()}\n")
    print(f"  trace:   {len(trace)} events on "
          f"{1 + rep.replicas_final + rep.n_scale_up} tracks "
          f"-> {outdir}/trace.json (open in Perfetto)")
    snap = json.loads(metrics.to_json())
    print(f"  metrics: {len(snap['counters'])} counters, "
          f"{len(snap['gauges'])} gauges, "
          f"{len(snap['histograms'])} histograms "
          f"-> {outdir}/metrics.json + .prom")
    print(f"  report:  -> {outdir}/report.json")
    for k in ("done", "steals", "retries", "failures", "recoveries",
              "scale_up", "scale_down"):
        print(f"    serve_{k}_total = "
              f"{snap['counters'][f'serve_{k}_total']}")

    # determinism: a second identical run gives identical bytes
    trace2, metrics2, rep2 = run(cfg, model)
    assert trace2.to_json() == trace.to_json(), "trace not deterministic"
    assert metrics2.to_json() == metrics.to_json()
    assert rep2.to_dict() == rep.to_dict()
    print("\n  second run byte-identical (modelled clock determinism)")
    print("observe_fleet OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
