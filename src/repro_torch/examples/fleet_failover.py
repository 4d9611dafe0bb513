"""Resilient fleet: fault injection, retries and a checkpointed hot-swap.

Three acts over the same 4-replica data-parallel fleet:

  1. the committed serving artifact: ``CompiledCNN.save`` writes params,
     the frozen plan table and the spec under the checkpoint crash-safety
     protocol, and ``CompiledCNN.load`` rebuilds it with no DSE sweep
     (the plan table seeds the registry);
  2. fault injection: replica 0 dies mid-stream and recovers later (the
     modelled artifact-restore latency is charged on top); its lost round
     re-dispatches against a per-request retry budget, and the fleet
     serves degraded gang rounds over the 3 survivors meanwhile; then the
     same chaos under the continuous-batching scheduler, where only the
     in-flight slots are lost and stealing rebalances the queues;
  3. a rolling hot-swap: the fleet upgrades fp32 -> calibrated int8 under
     load, replica by replica, without dropping a request.

Artifacts go to ``--out`` (or a temporary directory).

Run:  PYTHONPATH=src python -m repro_torch.examples.fleet_failover
      [--device cpu] [--out DIR]
"""
from __future__ import annotations

import argparse
import os
import sys

import torch

from repro_torch.configs import get_config
from repro_torch.examples import _common
from repro_torch.kernels import autotune
from repro_torch.launch.serve_cnn import synthetic_requests
from repro_torch.models.cnn import init_cnn_params
from repro_torch.pipeline import (CompiledCNN, ExecutionSpec, Placement,
                                  Precision, Serving, compile_cnn)
from repro_torch.pipeline.compile import resolve_device
from repro_torch.quant import calibrate_cnn
from repro_torch.serve import FaultSchedule

N_REQ = 240


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples."
                                      "fleet_failover", description=__doc__)
    _common.add_device_arg(ap, out=True)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    g = torch.Generator(dev).manual_seed(0)

    cfg = get_config("alexnet").smoke()
    params = init_cnn_params(cfg, generator=g, device=dev)
    spec = ExecutionSpec(placement=Placement(replicas=4),
                         serving=Serving(batch=8, clock="modeled",
                                         retries=2))
    print(f"compiling alexnet smoke, 4 DP replicas on {_common.where(dev)} "
          "(times are the modelled clock's)")
    compiled = compile_cnn(cfg, spec, params, device=dev)

    # -- act 1: save -> warm load of the committed artifact ---------------
    root = _common.out_dir(args, "fleet_failover")
    art_fp32 = os.path.join(root, "alexnet_fp32")
    compiled.save(art_fp32)
    autotune.clear_registry()
    autotune.reset_sweep_stats()
    compiled = CompiledCNN.load(art_fp32, device=dev)
    st = autotune.sweep_stats()
    assert st["conv_sweeps"] == 0 and st["gemm_sweeps"] == 0
    print(f"artifact committed at {art_fp32}\n"
          f"warm load: 0 DSE sweeps ({st['conv_hits']} conv + "
          f"{st['gemm_hits']} GEMM plan hits)\n")

    # -- act 2: kill replica 0 mid-stream, recover it, retry the losses ---
    # arrivals over about 120 ms of modelled time, so the failure (30 ms)
    # and the recovery (60 ms + the modelled restore) land in the stream
    requests = synthetic_requests(N_REQ, cfg.input_hw, cfg.input_ch,
                                  rate=2000.0)
    faults = FaultSchedule.at(0.03, 0.06, replica=0)
    rep = compiled.serve(requests, faults=faults)
    assert len(rep.completions) + rep.n_rejected == len(requests)
    failed = [c for c in rep.completions if c.status == "failed"]
    print(f"chaos run ({faults!r}):\n    {rep.summary()}\n"
          f"    {rep.n_failures} failure(s), {rep.n_recoveries} recovery("
          f"ies), {rep.n_retries} retried dispatches, "
          f"{rep.degraded_rounds} degraded rounds, "
          f"TTR {max(rep.time_to_recover_s) * 1e3:.1f} ms, "
          f"{len(failed)} explicitly failed")
    # the resilience invariant: nothing is ever silently stranded
    assert sorted(c.rid for c in rep.completions) == list(range(N_REQ))
    print("    every admitted request terminated (ok or explicit failure)\n")

    # -- act 2b: the same chaos under the continuous-batching scheduler ---
    spec_cb = ExecutionSpec(
        placement=Placement(replicas=4),
        serving=Serving(batch=8, clock="modeled", retries=2,
                        scheduler="continuous", steal_threshold=1))
    # stragglers (every 4th request is 50x heavier) keep work in flight
    # when the fault lands; under gang rounds each would stall its whole
    # co-scheduled batch, here they only occupy their own slot
    rep_cb = compile_cnn(cfg, spec_cb, params, device=dev).serve(
        synthetic_requests(N_REQ, cfg.input_hw, cfg.input_ch, rate=2000.0,
                           straggler_every=4, straggler_cost=50.0),
        faults=FaultSchedule.at(0.03, 0.06, replica=0))
    assert sorted(c.rid for c in rep_cb.completions) == list(range(N_REQ))
    print(f"same chaos, continuous batching (straggler-heavy stream):\n"
          f"    {rep_cb.summary()}\n"
          f"    only in-flight slots were lost to the fault "
          f"({rep_cb.n_retries} retried dispatches); stragglers never "
          f"stalled a co-scheduled request\n")

    # -- act 3: rolling hot-swap fp32 -> int8 under load ------------------
    calib = torch.randn((8, cfg.input_hw, cfg.input_hw, cfg.input_ch),
                        generator=g, device=dev)
    qp = calibrate_cnn(params, calib, cfg)
    spec8 = ExecutionSpec(precision=Precision(quant="int8"),
                          placement=Placement(replicas=4),
                          serving=Serving(batch=8, clock="modeled"))
    art_int8 = os.path.join(root, "alexnet_int8")
    compile_cnn(cfg, spec8, qp, device=dev).save(art_int8)

    fleet = CompiledCNN.load(art_fp32, device=dev)   # a fresh fp32 fleet
    target = CompiledCNN.load(art_int8, device=dev)
    v = fleet.engine.hot_swap(target, at=0.02)
    rep2 = fleet.serve(synthetic_requests(N_REQ, cfg.input_hw,
                                          cfg.input_ch, rate=2000.0))
    assert all(c.status == "ok" for c in rep2.completions), \
        "a graceful rolling swap must never drop a request"
    versions = {c.version for c in rep2.completions}
    assert versions == {0, v} and rep2.n_swapped == 4
    print(f"hot-swap run:\n    {rep2.summary()}\n"
          f"    {rep2.n_swapped}/4 replicas rolled to int8 (version {v}); "
          f"{sum(1 for c in rep2.completions if c.version == v)} of "
          f"{len(rep2.completions)} completions served by the new version")
    print("\nfleet_failover OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
