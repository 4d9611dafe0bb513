"""Elastic fleet: a bursty trace scales the fleet 2 -> 6 -> 2.

One continuous-batching fleet (``scheduler="continuous"``) under an
``AutoscalePolicy``, fed a three-phase Poisson trace on the modelled
discrete-event clock (``execute=False``: no forward runs, the port's H100
cost model prices every slot):

  1. steady state at about half the 2-replica capacity (no scaling),
  2. a burst at several times capacity: the autoscaler spins replicas up
     one policy interval at a time (each paying the modelled
     artifact-restore latency before serving) up to the 6-replica
     ceiling,
  3. a quiet tail: utilization falls below ``util_low`` and the autoscaler
     drains back down to the 2-replica floor (queue evacuations cost no
     retry; nothing is dropped).

The phases are JAX's, in rounds, except that the quiet tail also outlasts
the modelled restore: the engine charges a scale-up the restore of the
model's own artifact (the full AlexNet's 244 MB at the reference's 2 GB/s
+ 5 ms, about 370 of the H100 model's rounds), where JAX's device-free
engine holds no weights and charges the 5 ms alone.

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_elastic
      [--device cpu]
"""
from __future__ import annotations

import argparse
import math
import sys

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.examples import _common
from repro_torch.models.cnn import CNN, init_cnn_params
from repro_torch.pipeline.compile import resolve_device
from repro_torch.serve import AutoscalePolicy, Request, ServeEngine, total_cost

BATCH = 8
PHASES = ((24, 0.5), (20, 4.0), (40, 0.2))  # (rounds, load / 2-replica cap)


def phases_for(tr: float, t_restore: float):
    """JAX's phases, the quiet tail lengthened by the rounds a modelled
    restore takes (so scaled-up replicas join, then drain)."""
    (r1, l1), (r2, l2), (r3, l3) = PHASES
    return ((r1, l1), (r2, l2), (r3 + math.ceil(t_restore / tr), l3))


def bursty_requests(tr: float, cap2: float, phases=PHASES):
    """The three-phase Poisson trace: (duration in rounds, rate against
    the 2-replica capacity) a phase, from a seeded numpy generator."""
    rng = np.random.default_rng(0)
    arrivals, t = [], 0.0
    for rounds, load in phases:
        t_end = t + rounds * tr
        while t < t_end:
            t += rng.exponential(1.0 / (load * cap2))
            arrivals.append(t)
    return [Request(rid=i, image=np.zeros((1, 1, 1), np.float32),
                    t_arrival=a) for i, a in enumerate(arrivals)]


def full_alexnet(dev):
    """The full AlexNet on ``dev``: the H100 cost model of its groups
    prices the slots, and its weights' bytes price a restore."""
    cfg = get_config("alexnet")
    params = init_cnn_params(cfg, generator=torch.Generator(dev).manual_seed(0),
                             device=dev)
    return cfg, CNN(cfg, params)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples."
                                      "serve_elastic", description=__doc__)
    _common.add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg, model = full_alexnet(dev)
    tr = total_cost(cfg, BATCH)              # one modelled pipeline round
    cap2 = 2 * BATCH / tr                    # 2-replica service rate
    policy = AutoscalePolicy(min_replicas=2, max_replicas=6, interval=tr,
                             util_high=0.85, util_low=0.30)
    eng = ServeEngine(model, batch=BATCH, replicas=2, clock="modeled",
                      execute=False, retries=1, scheduler="continuous",
                      steal_threshold=2, autoscale=policy)
    requests = bursty_requests(tr, cap2,
                               phases_for(tr, eng.t_restore_model))
    print(f"elastic fleet: {len(requests)} requests over "
          f"{requests[-1].t_arrival * 1e3:.1f} ms of modelled traffic "
          f"(burst {PHASES[1][1]:.0f}x the 2-replica capacity; a round "
          f"{tr * 1e3:.3f} ms, a restore {eng.t_restore_model * 1e3:.1f} "
          f"ms in the H100 cost model; the fleet's model on "
          f"{_common.where(dev)})\n")
    done, rep = eng.serve(requests)

    # the serving contract survives elasticity: nothing stranded
    assert sorted(c.rid for c in done) == list(range(len(requests)))
    assert all(c.status == "ok" for c in done)
    print(f"  {rep.summary()}\n")
    print("  scaling timeline (modelled clock):")
    for e in rep.scale_events:
        print(f"    t={e['t'] * 1e3:8.2f} ms  {e['kind']:>4}  "
              f"replica {e['replica']}  ({e['reason']})")
    n = peak = 2
    for e in rep.scale_events:
        n += 1 if e["kind"] == "up" else -1
        peak = max(peak, n)
    print(f"\n  fleet path: 2 -> {peak} -> {rep.replicas_final} replicas "
          f"(+{rep.n_scale_up}/-{rep.n_scale_down})")
    assert rep.n_scale_up >= 1, "the burst should have scaled the fleet up"
    assert rep.n_scale_down >= 1, "the quiet tail should have drained it"
    assert rep.replicas_final == policy.min_replicas
    print("serve_elastic OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
