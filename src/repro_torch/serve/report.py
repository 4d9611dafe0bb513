"""Latency / throughput accounting for served runs.

The port's copy of the JAX package's ``serve/report.py``: nearest-rank
percentiles (``rank(q) = ceil(q*n) - 1``, exact down to n=1), the
hardened :func:`latency_report`, and the :class:`FleetReport` with its
pipeline-bubble, fault/recovery and continuous-scheduler (occupancy,
steals, scaling) accounting.
"""
from __future__ import annotations

import dataclasses
import math
from dataclasses import dataclass, field
from typing import List, Sequence

import numpy as np


def nearest_rank(lats: Sequence[float], q: float) -> float:
    """Nearest-rank percentile: the ceil(q*n)-th smallest value (1-based);
    ``lats`` must be sorted ascending."""
    n = len(lats)
    if n == 0:
        return float("nan")
    rank = max(0, math.ceil(q * n) - 1)
    return float(lats[min(rank, n - 1)])


def latency_report(done: List) -> dict:
    """Throughput + nearest-rank latency percentiles over the ``status ==
    "ok"`` completions; an empty list gives n=0, zero throughput and NaN
    percentiles."""
    done = [c for c in done if getattr(c, "status", "ok") == "ok"]
    if not done:
        return {"n": 0, "throughput": 0.0,
                "p50_ms": float("nan"), "p95_ms": float("nan")}
    lats = np.array(sorted(c.latency for c in done))
    makespan = max(c.t_done for c in done)
    return {"n": len(done),
            "throughput": len(done) / makespan if makespan > 0 else 0.0,
            "p50_ms": nearest_rank(lats, 0.50) * 1e3,
            "p95_ms": nearest_rank(lats, 0.95) * 1e3}


@dataclass
class FleetReport:
    """Serving summary of one engine run."""
    mode: str                          # "single" | "dp" | "pp" | "hybrid"
    replicas: int                      # replicas the run started with
    pp_stages: int
    batch: int                         # micro-batch (slot count a replica)
    clock: str                         # "measured" | "modeled"
    scheduler: str = "gang"            # "gang" | "continuous"
    device: str = ""                   # where the forwards ran
    n_done: int = 0
    n_rejected: int = 0                # admission-control rejections
    rounds: int = 0                    # gang rounds / microbatch boundaries
    throughput: float = 0.0            # img/s
    p50_ms: float = float("nan")
    p95_ms: float = float("nan")
    makespan_s: float = 0.0
    utilization: List[float] = field(default_factory=list)  # per replica
    bubble_fraction: float = 0.0       # GPipe fill/drain share (pp modes)
    # -- continuous-scheduler accounting ------------------------------------
    occupancy: List[float] = field(default_factory=list)  # mean filled
    #                                    slots / batch a replica
    n_steals: int = 0                  # requests work-stolen across queues
    n_scale_up: int = 0                # replicas the autoscaler spun up
    n_scale_down: int = 0              # replicas it drained out
    scale_events: List = field(default_factory=list)  # dicts: t/kind/
    #                                    replica/reason, in decision order
    replicas_final: int = 0            # active replicas when the run ended
    # -- fault / recovery accounting --------------------------------------
    n_failed: int = 0                  # retry budget exhausted -> "failed"
    n_retries: int = 0                 # re-dispatches charged to budgets
    n_failures: int = 0                # replica fail events that landed
    n_recoveries: int = 0              # replicas restored into dispatch
    degraded_rounds: int = 0           # rounds with < replicas alive
    time_to_recover_s: List[float] = field(default_factory=list)
    n_swapped: int = 0                 # replicas rolled by hot_swap
    slo_s: float = 0.0                 # per-request latency bound (0=off)
    slo_violations: int = 0            # ok completions over the bound
    completions: List = field(default_factory=list, repr=False)

    def to_dict(self) -> dict:
        out = {}
        for f in dataclasses.fields(self):
            if f.name != "completions":
                v = getattr(self, f.name)
                out[f.name] = list(v) if isinstance(v, list) else v
        return out

    def summary(self) -> str:
        util = (", util " + "/".join(f"{u:.0%}" for u in self.utilization)
                if self.utilization else "")
        rej = f", {self.n_rejected} rejected" if self.n_rejected else ""
        bub = (f", bubble {self.bubble_fraction:.0%}"
               if self.pp_stages > 1 else "")
        slo = (f", SLO({self.slo_s * 1e3:.0f} ms) violations "
               f"{self.slo_violations}" if self.slo_s else "")
        chaos = ""
        if self.n_failures or self.n_failed or self.n_retries:
            ttr = (f", TTR {max(self.time_to_recover_s) * 1e3:.0f} ms"
                   if self.time_to_recover_s else "")
            chaos = (f" | chaos: {self.n_failures} failures, "
                     f"{self.n_recoveries} recoveries, "
                     f"{self.degraded_rounds} degraded rounds, "
                     f"{self.n_retries} retries, {self.n_failed} failed"
                     f"{ttr}")
        swap = (f" | hot-swap: {self.n_swapped} replicas rolled"
                if self.n_swapped else "")
        cb = ""
        if self.scheduler == "continuous":
            occ = (", occ " + "/".join(f"{o:.0%}" for o in self.occupancy)
                   if self.occupancy else "")
            scale = (f", scale +{self.n_scale_up}/-{self.n_scale_down} "
                     f"-> {self.replicas_final} replicas"
                     if (self.n_scale_up or self.n_scale_down) else "")
            cb = f" | cb: {self.n_steals} steals{occ}{scale}"
        unit = "rounds" if self.scheduler == "gang" else "boundaries"

        def ms(v):
            return "n/a" if math.isnan(v) else f"{v:.3f} ms"
        return (f"[{self.mode}/{self.scheduler}] {self.n_done} served in "
                f"{self.rounds} {unit} ({self.clock} clock, {self.device}): "
                f"{self.throughput:.1f} img/s, p50 {ms(self.p50_ms)}, "
                f"p95 {ms(self.p95_ms)}{util}{rej}{bub}{slo}{cb}{chaos}"
                f"{swap}")


def fleet_report(done: List, rejected: List, *, mode: str, replicas: int,
                 pp_stages: int, batch: int, clock: str, rounds: int,
                 busy_s: Sequence[float], makespan_s: float,
                 bubble_fraction: float = 0.0, n_retries: int = 0,
                 n_failures: int = 0, n_recoveries: int = 0,
                 degraded_rounds: int = 0,
                 time_to_recover_s: Sequence[float] = (),
                 n_swapped: int = 0, slo_s: float = 0.0,
                 device: str = "", scheduler: str = "gang",
                 occupancy: Sequence[float] = (), n_steals: int = 0,
                 n_scale_up: int = 0, n_scale_down: int = 0,
                 scale_events: Sequence[dict] = (),
                 replicas_final: int = 0) -> FleetReport:
    """Assemble the report from an engine run's accounting."""
    lat = latency_report(done)
    failed = [c for c in done if getattr(c, "status", "ok") == "failed"]
    slo_violations = (sum(1 for c in done
                          if getattr(c, "status", "ok") == "ok"
                          and c.latency > slo_s) if slo_s > 0 else 0)
    return FleetReport(
        mode=mode, replicas=replicas, pp_stages=pp_stages, batch=batch,
        clock=clock, scheduler=scheduler, device=device, n_done=lat["n"],
        n_rejected=len(rejected), rounds=rounds,
        throughput=lat["n"] / makespan_s if makespan_s > 0 else 0.0,
        p50_ms=lat["p50_ms"], p95_ms=lat["p95_ms"], makespan_s=makespan_s,
        utilization=[b / makespan_s if makespan_s > 0 else 0.0
                     for b in busy_s],
        bubble_fraction=bubble_fraction, n_failed=len(failed),
        n_retries=n_retries, n_failures=n_failures,
        n_recoveries=n_recoveries, degraded_rounds=degraded_rounds,
        time_to_recover_s=list(time_to_recover_s), n_swapped=n_swapped,
        slo_s=slo_s, slo_violations=slo_violations,
        occupancy=list(occupancy), n_steals=n_steals,
        n_scale_up=n_scale_up, n_scale_down=n_scale_down,
        scale_events=list(scale_events),
        replicas_final=replicas_final or replicas)
