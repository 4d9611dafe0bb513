"""Latency / throughput accounting for served runs.

The port's copy of the JAX package's ``serve/report.py``, cut to the
fields a single-replica gang run fills: nearest-rank percentiles
(``rank(q) = ceil(q*n) - 1``, exact down to n=1), the hardened
:func:`latency_report`, and the :class:`FleetReport`.
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
    mode: str                          # "single"
    replicas: int
    pp_stages: int
    batch: int                         # micro-batch requests are padded to
    clock: str                         # "measured" | "modeled"
    scheduler: str = "gang"
    device: str = ""                   # where the forwards ran
    n_done: int = 0
    n_rejected: int = 0                # admission-control rejections
    rounds: int = 0                    # gang rounds
    throughput: float = 0.0            # img/s
    p50_ms: float = float("nan")
    p95_ms: float = float("nan")
    makespan_s: float = 0.0
    utilization: List[float] = field(default_factory=list)  # per replica
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
        slo = (f", SLO({self.slo_s * 1e3:.0f} ms) violations "
               f"{self.slo_violations}" if self.slo_s else "")

        def ms(v):
            return "n/a" if math.isnan(v) else f"{v:.3f} ms"
        return (f"[{self.mode}/{self.scheduler}] {self.n_done} served in "
                f"{self.rounds} rounds ({self.clock} clock, {self.device}): "
                f"{self.throughput:.1f} img/s, p50 {ms(self.p50_ms)}, "
                f"p95 {ms(self.p95_ms)}{util}{rej}{slo}")


def fleet_report(done: List, rejected: List, *, mode: str, replicas: int,
                 pp_stages: int, batch: int, clock: str, rounds: int,
                 busy_s: Sequence[float], makespan_s: float,
                 slo_s: float = 0.0, device: str = "") -> FleetReport:
    """Assemble the report from an engine run's accounting."""
    lat = latency_report(done)
    slo_violations = (sum(1 for c in done
                          if getattr(c, "status", "ok") == "ok"
                          and c.latency > slo_s) if slo_s > 0 else 0)
    return FleetReport(
        mode=mode, replicas=replicas, pp_stages=pp_stages, batch=batch,
        clock=clock, device=device, n_done=lat["n"],
        n_rejected=len(rejected), rounds=rounds,
        throughput=lat["n"] / makespan_s if makespan_s > 0 else 0.0,
        p50_ms=lat["p50_ms"], p95_ms=lat["p95_ms"], makespan_s=makespan_s,
        utilization=[b / makespan_s if makespan_s > 0 else 0.0
                     for b in busy_s],
        slo_s=slo_s, slo_violations=slo_violations)
