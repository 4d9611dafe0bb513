"""Distributed CNN serving: one compile a placement, one router.

Compiles the same network four times through the compile-once API
(``compile_cnn``), changing only the spec's Placement and Serving, and
drains the same synthetic request stream through each ``CompiledCNN``:

  1. a single replica,
  2. 4 data-parallel replicas,
  3. hybrid 2 replicas x 4 pipeline stages (dp x pp),
  4. the same 4 replicas under the continuous-batching scheduler
     (per-request slots and work stealing instead of gang rounds),

printing each fleet report and asserting that every mode classifies
identically (scheduling never changes the math). On one card a replica
or a stage is a CUDA stream; the modelled clock keeps the JAX meaning (a
replica is a device).

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_fleet
      [--device cpu]
"""
from __future__ import annotations

import argparse
import sys

import torch

from repro_torch.configs import get_config
from repro_torch.examples import _common
from repro_torch.launch.serve_cnn import (default_request_count,
                                          synthetic_requests)
from repro_torch.models.cnn import init_cnn_params
from repro_torch.pipeline import ExecutionSpec, Placement, Serving, compile_cnn
from repro_torch.pipeline.compile import resolve_device

BATCH = 8

MODES = (
    ("single replica", Placement(), Serving(batch=BATCH, clock="modeled")),
    ("4 DP replicas", Placement(replicas=4),
     Serving(batch=BATCH, clock="modeled")),
    ("hybrid 2 replicas x 4 pipeline stages",
     Placement(replicas=2, pp_stages=4),
     Serving(batch=BATCH, clock="modeled")),
    ("4 replicas, continuous batching + stealing", Placement(replicas=4),
     Serving(batch=BATCH, clock="modeled", scheduler="continuous",
             steal_threshold=1, retries=1)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples."
                                      "serve_fleet", description=__doc__)
    _common.add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config("alexnet").smoke()
    params = init_cnn_params(cfg, generator=torch.Generator(dev).manual_seed(0),
                             device=dev)
    n_req = default_request_count(BATCH, replicas=4)
    # a bursty arrival rate: queues build up, so the modes differ (the
    # fleet's throughput, not the arrivals, is the bottleneck)
    requests = synthetic_requests(n_req, cfg.input_hw, cfg.input_ch,
                                  rate=1e6)

    print(f"serving {n_req} requests (alexnet smoke, micro-batch {BATCH}) "
          f"on {_common.where(dev)}; times are the modelled clock's\n")
    preds = {}
    for label, placement, serving in MODES:
        spec = ExecutionSpec(placement=placement, serving=serving)
        compiled = compile_cnn(cfg, spec, params, device=dev)
        rep = compiled.serve(requests)
        assert len(rep.completions) == n_req
        preds[label] = {c.rid: c.pred for c in rep.completions}
        extra = ""
        if compiled.stage_plan is not None:
            sp = compiled.stage_plan
            extra = ("\n    stages: " + " | ".join(
                f"{len(s.groups)}g {s.t_model * 1e6:.0f}us"
                for s in sp.stages) + f"  (balance {sp.balance:.2f}, "
                f"M={compiled.engine.n_micro})")
        print(f"  {label}:\n    {rep.summary()}{extra}")

    # every mode classifies identically: dp shards the batch, pp slices
    # the network, neither changes the math
    base = preds["single replica"]
    for label, p in preds.items():
        assert p == base, f"{label} diverged from single-replica predictions"
    print("\nall modes produced identical predictions")
    print("serve_fleet OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
