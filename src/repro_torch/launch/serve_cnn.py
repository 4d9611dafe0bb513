"""CNN serving launcher of the port — a thin CLI over ``compile_cnn``.

    PYTHONPATH=src python -m repro_torch.launch.serve_cnn --arch alexnet \\
        [--smoke] [--batch 8] [--requests N] [--rate 200] [--device cpu] \\
        [--quant int8 [--calib 8]] [--replicas R] [--pp-stages S] \\
        [--microbatches M] [--clock measured|modeled] [--max-queue N] \\
        [--fail-at T [--recover-at T] [--fail-replica r] | --mtbf T --mttr T] \\
        [--retries N] [--backoff T] [--slo T] \\
        [--straggler-every k] [--straggler-cost c] [--report-json PATH] \\
        [--scheduler gang|continuous] [--steal-threshold N] \\
        [--autoscale [--min-replicas N] [--max-replicas N] \\
         [--scale-interval T] [--scale-cooldown T] [--util-high u] \\
         [--util-low u]] [--trace-out PATH] [--metrics-out PATH[.prom]] \\
        [--measure [--measure-repeats N]] [--plan-out PATH] \\
        [--drift-out PATH] [--verify] [--no-kernels]

Compiles the model once (random weights from ``--seed``; with
``--quant int8`` calibrated on ``--calib`` synthetic images and served by
the int8 kernel pipeline; ``--no-kernels`` runs the exact oracles instead
of the kernels, the JAX launcher's ``--no-pallas``), placed as
``--replicas`` data-parallel replicas of ``--pp-stages`` pipeline stages
(each a CUDA stream of the one card), serves a synthetic request stream
(exponential inter-arrival times) on the chosen clock, with replica
faults injected when asked, and prints the report.

``--scheduler continuous`` (with ``--clock modeled``) admits and retires
requests one by one at microbatch boundaries, ``--steal-threshold`` turns
on work stealing across queues, and ``--autoscale`` scales the fleet
between ``--min-replicas`` and ``--max-replicas`` on the p95-against-SLO
and load signals. ``--trace-out`` writes the run's Chrome trace-event
JSON (Perfetto), ``--metrics-out`` the metrics snapshot (a ``.prom``
suffix: Prometheus text), ``--report-json`` the report; all three come
from one set of counters, so ``python -m repro_torch.obs.validate``
reconciles them. ``--measure`` times every compiled plan on the card
(format-3 table, ``--plan-out``), ``--drift-out`` writes the measured
against modelled drift report, and ``--verify`` re-proves the compiled
plans statically and refuses to serve on a finding. Runs on the CUDA
device unless ``--device`` says otherwise.
"""
from __future__ import annotations

import argparse
import json
import warnings
from typing import List

import numpy as np
import torch

from repro_torch.configs import CNN_IDS, get_config
from repro_torch.obs import (MeasureOptions, MetricsRegistry, TraceRecorder,
                             drift_report, record_drift)
from repro_torch.core.config import CNNConfig, flops_per_image
from repro_torch.pipeline import (AutoscalePolicy, ExecutionSpec, Placement,
                                  Precision, Serving, compile_cnn)
from repro_torch.serve import Completion, Request, latency_report
from repro_torch.serve.faults import FaultSchedule


def synthetic_requests(n: int, hw: int, ch: int, rate: float,
                       seed: int = 0, straggler_every: int = 0,
                       straggler_cost: float = 4.0) -> List[Request]:
    """n requests with exponential inter-arrival times (mean 1/rate s) and
    standard-normal images; the same stream as the JAX launcher's for the
    same seed. ``straggler_every`` > 0 gives every k-th request the service
    weight ``straggler_cost`` (a gang round runs at its dearest)."""
    rng = np.random.default_rng(seed)
    t = 0.0
    out = []
    for i in range(n):
        t += rng.exponential(1.0 / rate)
        cost = (straggler_cost
                if straggler_every and i % straggler_every == 0 else 1.0)
        out.append(Request(rid=i, t_arrival=t, cost=cost,
                           image=rng.standard_normal(
                               (hw, hw, ch)).astype(np.float32)))
    return out


def serve(cfg: CNNConfig, params, requests: List[Request], *,
          batch: int, use_kernels: bool, replicas: int = 1,
          pp_stages: int = 1, clock: str = "measured", max_queue: int = 0,
          device=None) -> List[Completion]:
    """Deprecated (the JAX package's first launcher API): compile, serve,
    return the completions. ``params`` are fp32/bf16 parameters or a
    ``QuantizedCNNParams`` (served in int8). Call
    ``compile_cnn(cfg, spec, params).serve(requests)`` instead."""
    from repro_torch.quant import QuantizedCNNParams
    warnings.warn("serve is deprecated: compile_cnn(cfg, spec, params)"
                  ".serve(requests)", DeprecationWarning, stacklevel=2)
    quant = "int8" if isinstance(params, QuantizedCNNParams) else "none"
    spec = ExecutionSpec(
        precision=Precision(quant=quant),
        placement=Placement(replicas=replicas, pp_stages=pp_stages),
        serving=Serving(batch=batch, clock=clock, max_queue=max_queue),
        use_kernels=use_kernels)
    return compile_cnn(cfg, spec, params, device=device).serve(
        requests).completions


def default_request_count(batch: int, replicas: int = 1) -> int:
    """Two full micro-batches per replica plus a non-dividing remainder,
    so every run exercises the pad-to-plan path."""
    return 2 * batch * replicas + 3


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="alexnet", choices=CNN_IDS)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced channel counts and input (CPU-friendly)")
    ap.add_argument("--batch", type=int, default=8,
                    help="micro-batch the queue pads requests to")
    ap.add_argument("--requests", type=int, default=0,
                    help="synthetic requests (default 2*batch + 3)")
    ap.add_argument("--rate", type=float, default=200.0,
                    help="request arrival rate (req/s)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weights and of the request stream")
    ap.add_argument("--quant", choices=("none", "int8"), default="none",
                    help="serve in fixed-point: calibrate on a synthetic "
                         "batch, then run the int8 kernel pipeline")
    ap.add_argument("--calib", type=int, default=8,
                    help="calibration images for --quant int8")
    ap.add_argument("--replicas", type=int, default=1,
                    help="data-parallel replicas (CUDA streams of the card)")
    ap.add_argument("--pp-stages", type=int, default=1,
                    help="pipeline stages (CUDA streams of the card)")
    ap.add_argument("--microbatches", type=int, default=0,
                    help="GPipe microbatches a pipeline round (0 = the "
                         "modelled round's best)")
    ap.add_argument("--clock", choices=("measured", "modeled"),
                    default="measured",
                    help="advance the clock by wall time or by the card's "
                         "cost model (deterministic)")
    ap.add_argument("--max-queue", type=int, default=0,
                    help="admission control: reject when the chosen "
                         "replica queue holds this many (0 = unbounded)")
    ap.add_argument("--fail-at", type=float, default=None,
                    help="fail a replica at this simulated second")
    ap.add_argument("--recover-at", type=float, default=None,
                    help="recover it at this simulated second (needs "
                         "--fail-at; the modelled restore is charged on "
                         "top)")
    ap.add_argument("--fail-replica", type=int, default=0,
                    help="which replica --fail-at fails")
    ap.add_argument("--mtbf", type=float, default=0.0,
                    help="seeded random faults: mean time between failures "
                         "a replica (s; needs --mttr)")
    ap.add_argument("--mttr", type=float, default=0.0,
                    help="mean time to repair for --mtbf (s)")
    ap.add_argument("--retries", type=int, default=0,
                    help="re-dispatch budget of a request lost to a fault "
                         "(past it: a failed completion)")
    ap.add_argument("--backoff", type=float, default=0.0,
                    help="base exponential backoff (s) before a retried "
                         "request is re-admitted")
    ap.add_argument("--slo", type=float, default=0.0,
                    help="latency bound (s) the report counts violations "
                         "of (0 = off)")
    ap.add_argument("--straggler-every", type=int, default=0,
                    help="give every k-th request --straggler-cost (0 = "
                         "none)")
    ap.add_argument("--straggler-cost", type=float, default=4.0,
                    help="service weight of a straggler request")
    ap.add_argument("--report-json", default=None, metavar="PATH",
                    help="write FleetReport.to_dict() as JSON")
    ap.add_argument("--no-kernels", action="store_true",
                    help="serve through the exact oracles instead of the "
                         "CUDA kernels (use_kernels=False)")
    # -- continuous scheduling and the elastic fleet --------------------------
    ap.add_argument("--scheduler", choices=("gang", "continuous"),
                    default="gang",
                    help="padded gang rounds, or per-request slots admitted "
                         "and retired at microbatch boundaries (needs "
                         "--clock modeled)")
    ap.add_argument("--steal-threshold", type=int, default=0,
                    help="continuous only: steal one queued request a "
                         "boundary when queue depths differ by more than "
                         "this (each steal charges the retry budget; 0 = "
                         "off)")
    ap.add_argument("--autoscale", action="store_true",
                    help="continuous only: scale the replicas between "
                         "--min-replicas and --max-replicas on the "
                         "p95-against-SLO and load signals")
    ap.add_argument("--min-replicas", type=int, default=0,
                    help="autoscale floor (default: --replicas)")
    ap.add_argument("--max-replicas", type=int, default=0,
                    help="autoscale ceiling (default: 2 x --replicas)")
    ap.add_argument("--scale-interval", type=float, default=0.05,
                    help="seconds between autoscale evaluations")
    ap.add_argument("--scale-cooldown", type=float, default=0.0,
                    help="least seconds between scaling decisions")
    ap.add_argument("--util-high", type=float, default=0.85,
                    help="scale up when the fleet's load (slots + backlog "
                         "over capacity) exceeds this")
    ap.add_argument("--util-low", type=float, default=0.30,
                    help="scale down (graceful drain) when the load falls "
                         "below this")
    # -- observability ------------------------------------------------------
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write the run's Chrome trace-event JSON "
                         "(Perfetto); byte-identical across runs on "
                         "--clock modeled")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write the metrics snapshot (JSON, or Prometheus "
                         "text for a .prom suffix)")
    ap.add_argument("--measure", action="store_true",
                    help="time every compiled plan on the card and record "
                         "it in the plan table (format 3)")
    ap.add_argument("--measure-repeats", type=int, default=3,
                    help="timing samples a plan for --measure (trimmed "
                         "mean)")
    ap.add_argument("--plan-out", default=None, metavar="PATH",
                    help="write the compiled plan table JSON")
    ap.add_argument("--drift-out", default=None, metavar="PATH",
                    help="write the measured-against-modelled drift report "
                         "(python -m repro_torch.obs.drift's document)")
    ap.add_argument("--verify", action="store_true",
                    help="re-prove the compiled plans statically "
                         "(repro_torch.analysis) and refuse to serve on a "
                         "finding")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    n_req = args.requests or default_request_count(args.batch, args.replicas)
    if args.mtbf and args.fail_at is not None:
        raise SystemExit("--fail-at (deterministic) and --mtbf (seeded "
                         "random) are exclusive fault modes")
    if args.recover_at is not None and args.fail_at is None:
        raise SystemExit("--recover-at requires --fail-at")
    faults = None
    if args.fail_at is not None:
        faults = FaultSchedule.at(args.fail_at, args.recover_at,
                                  replica=args.fail_replica)
    elif args.mtbf:
        faults = FaultSchedule.mtbf(args.mtbf, args.mttr, args.replicas,
                                    seed=args.seed)
    autoscale = None
    if args.autoscale:
        autoscale = AutoscalePolicy(
            min_replicas=args.min_replicas or args.replicas,
            max_replicas=args.max_replicas or 2 * args.replicas,
            interval=args.scale_interval, cooldown=args.scale_cooldown,
            util_high=args.util_high, util_low=args.util_low)
    trace = TraceRecorder() if args.trace_out else None
    metrics = MetricsRegistry() if args.metrics_out else None
    compiled = compile_cnn(cfg, ExecutionSpec(
        precision=Precision(quant=args.quant, calib=args.calib),
        placement=Placement(replicas=args.replicas,
                            pp_stages=args.pp_stages,
                            microbatches=args.microbatches),
        serving=Serving(batch=args.batch, clock=args.clock,
                        max_queue=args.max_queue, retries=args.retries,
                        backoff=args.backoff, slo=args.slo,
                        scheduler=args.scheduler,
                        steal_threshold=args.steal_threshold,
                        autoscale=autoscale),
        use_kernels=not args.no_kernels),
        generator=torch.Generator().manual_seed(args.seed),
        device=args.device, measure=args.measure,
        measure_opts=(MeasureOptions(repeats=args.measure_repeats)
                      if args.measure else None), trace=trace)
    if args.verify:
        findings = compiled.verify()
        for f in findings:
            print(f"[serve_cnn] VERIFY {f}")
        if findings:
            raise SystemExit(f"[serve_cnn] --verify: {len(findings)} "
                             f"static finding(s): refusing to serve "
                             f"{args.arch!r}")
        print(f"[serve_cnn] --verify: plan table statically verified "
              f"({len(compiled.plan_table)} rows, 0 findings)")
    requests = synthetic_requests(n_req, cfg.input_hw, cfg.input_ch,
                                  args.rate, seed=args.seed,
                                  straggler_every=args.straggler_every,
                                  straggler_cost=args.straggler_cost)
    sp = compiled.stage_plan
    if sp is not None:
        m = compiled.engine.n_micro
        print(f"[serve_cnn] {args.pp_stages} pipeline stages (balance "
              f"{sp.balance:.2f}, bubble {sp.bubble(m):.0%} at M={m}): "
              + " | ".join(f"s{i}:{len(s.groups)}g {s.t_model * 1e6:.0f}us"
                           for i, s in enumerate(sp.stages)))
    if faults is not None:
        print(f"[serve_cnn] faults: {faults!r}, retries={args.retries}, "
              f"backoff={args.backoff}s")
    rep = compiled.serve(requests, faults=faults, trace=trace,
                         metrics=metrics)
    # every request ends as one completion (ok or failed) or one rejection
    if len(rep.completions) + rep.n_rejected != n_req:
        raise SystemExit(f"{n_req} requests but {len(rep.completions)} "
                         f"completions and {rep.n_rejected} rejections")
    if args.scheduler == "continuous":
        # one scale event a decision, and the final fleet follows from them
        ups = sum(e["kind"] == "up" for e in rep.scale_events)
        downs = sum(e["kind"] == "down" for e in rep.scale_events)
        if (ups, downs) != (rep.n_scale_up, rep.n_scale_down) or \
                rep.replicas_final != args.replicas + ups - downs:
            raise SystemExit(f"scale accounting: events +{ups}/-{downs}, "
                             f"counters +{rep.n_scale_up}/"
                             f"-{rep.n_scale_down}, "
                             f"{rep.replicas_final} final replicas")
        print(f"[serve_cnn] continuous: {rep.n_steals} steals, "
              f"{rep.n_scale_up} scale-ups, {rep.n_scale_down} "
              f"scale-downs, {rep.replicas_final} final replicas, mean "
              f"occupancy " + "/".join(f"{o:.0%}" for o in rep.occupancy))
    gops = flops_per_image(cfg) * rep.throughput / 1e9
    print(f"[serve_cnn] {args.arch}{' (smoke)' if args.smoke else ''}: "
          f"{n_req} requests @ micro-batch {args.batch} on "
          f"{compiled.device}{', int8' if compiled.quant else ''}, mode "
          f"{compiled.mode} (R={args.replicas}, S={args.pp_stages})")
    if compiled.quant:
        qp = compiled.params
        n_conv = sum(1 for l in qp.layers
                     if l is not None and l.kind == "conv")
        print(f"[serve_cnn] int8 calibration: {args.calib} images, "
              f"{n_conv} conv layers quantized (per-channel weights, "
              f"per-tensor activations); input scale {qp.in_scale:.3g}")
    print(f"[serve_cnn] {rep.summary()}")
    print(f"[serve_cnn] latency_report {latency_report(rep.completions)}")
    print(f"[serve_cnn] {gops:.2f} GOPS at the reported throughput")
    if args.plan_out:
        compiled.save_plan(args.plan_out)
        print(f"[serve_cnn] plan table ({compiled.plan_table.summary()}) "
              f"-> {args.plan_out}")
    if args.measure or args.drift_out:
        drift = drift_report(compiled.plan_table)
        stats = drift["ratio"]
        print(f"[serve_cnn] drift: {drift['n_measured']}/"
              f"{drift['n_plans']} plans measured"
              + (f", geomean ratio {stats['geomean']:.3g}x" if stats
                 else ""))
        if metrics is not None and args.measure:
            record_drift(metrics, drift)
        if args.drift_out:
            _write_json(args.drift_out, drift)
            print(f"[serve_cnn] drift report -> {args.drift_out}")
    if trace is not None:
        trace.save(args.trace_out)
        print(f"[serve_cnn] trace: {len(trace)} events -> {args.trace_out}")
    if metrics is not None:
        metrics.save(args.metrics_out)
        print(f"[serve_cnn] metrics -> {args.metrics_out}")
    if args.report_json:
        _write_json(args.report_json, rep.to_dict())
        print(f"[serve_cnn] report -> {args.report_json}")


def _write_json(path: str, doc: dict) -> None:
    """Canonical JSON (sorted keys, indent 1, trailing newline)."""
    with open(path, "w") as f:
        json.dump(doc, f, sort_keys=True, indent=1)
        f.write("\n")


if __name__ == "__main__":
    main()
