"""Fault model of the serving fleet: the failure vocabulary of the
engine's discrete-event loop (a copy of the JAX package's
``serve/faults.py``; numpy only).

``FaultSchedule`` is the schedule of replica faults a
``ServeEngine.serve`` run injects into its clock:

  * **deterministic**: explicit fail-at-t / recover-at-t events
    (``FaultSchedule.at(fail_at, recover_at, replica=...)`` or a list of
    events);
  * **stochastic**: a seeded MTBF/MTTR renewal process a replica
    (``FaultSchedule.mtbf(...)``): exponential times between failures and
    to repair from numpy's generator, so a seed gives the JAX package's
    event list.

Semantics (the engine implements them; the schedule is the contract):

  * a ``"fail"`` event kills the replica at that instant: its round in
    flight is lost (those requests re-dispatch against their retry
    budget) and its queue is evacuated to the surviving replicas;
  * a ``"recover"`` event starts the replica's restore at that instant;
    it rejoins dispatch after the engine's modelled restore latency (a
    reload of the committed ``CompiledCNN`` artifact);
  * between the two, the fleet serves degraded gang rounds over the
    survivors.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import Iterable, Iterator, List, Optional

import numpy as np

KINDS = ("fail", "recover")


@dataclass(frozen=True)
class FaultEvent:
    """One scheduled replica fault: (simulated time, replica id, kind)."""
    t: float
    replica: int
    kind: str                          # "fail" | "recover"

    def __post_init__(self):
        if self.kind not in KINDS:
            raise ValueError(f"FaultEvent.kind={self.kind!r}: expected "
                             f"one of {KINDS}")
        if self.t < 0:
            raise ValueError(f"FaultEvent.t={self.t}: fault times are "
                             "simulated seconds >= 0")
        if self.replica < 0:
            raise ValueError(f"FaultEvent.replica={self.replica}: "
                             "replica ids are >= 0")


class FaultSchedule:
    """An ordered stream of :class:`FaultEvent` for one serve run.

    Iterating yields events in non-decreasing time order. Deterministic
    schedules are finite; the MTBF mode is an *infinite* seeded renewal
    process (the engine consumes it lazily up to its own horizon), so
    ``len``/indexing only exist for deterministic schedules.
    """

    def __init__(self, events: Iterable[FaultEvent] = (), *,
                 mtbf: float = 0.0, mttr: float = 0.0,
                 n_replicas: int = 0, seed: int = 0):
        self._events: List[FaultEvent] = sorted(
            events, key=lambda e: (e.t, e.replica, e.kind))
        self._mtbf = float(mtbf)
        self._mttr = float(mttr)
        self._n_replicas = n_replicas
        self._seed = seed
        if self._mtbf < 0 or self._mttr < 0:
            raise ValueError("mtbf/mttr must be >= 0")
        if self._mtbf and (self._mttr <= 0 or self._n_replicas < 1):
            raise ValueError(
                "stochastic mode needs mtbf > 0, mttr > 0 and "
                "n_replicas >= 1 (use FaultSchedule.mtbf(...))")
        if self._mtbf and self._events:
            raise ValueError("a schedule is deterministic events OR a "
                             "stochastic MTBF process, not both")

    # -- constructors ------------------------------------------------------

    @classmethod
    def at(cls, fail_at: float, recover_at: Optional[float] = None, *,
           replica: int = 0) -> "FaultSchedule":
        """One deterministic failure (and optional recovery) of one
        replica — the CLI's ``--fail-at`` / ``--recover-at`` flags."""
        events = [FaultEvent(t=fail_at, replica=replica, kind="fail")]
        if recover_at is not None:
            if recover_at <= fail_at:
                raise ValueError(
                    f"recover_at={recover_at} must be after "
                    f"fail_at={fail_at}")
            events.append(FaultEvent(t=recover_at, replica=replica,
                                     kind="recover"))
        return cls(events)

    @classmethod
    def mtbf(cls, mtbf: float, mttr: float, n_replicas: int, *,
             seed: int = 0) -> "FaultSchedule":
        """Seeded stochastic mode: each replica alternates exponential
        up-times (mean ``mtbf``) and repair times (mean ``mttr``).
        Deterministic for a given seed — chaos you can diff."""
        return cls(mtbf=mtbf, mttr=mttr, n_replicas=n_replicas, seed=seed)

    # -- the event stream --------------------------------------------------

    @property
    def stochastic(self) -> bool:
        return self._mtbf > 0

    def _replica_stream(self, r: int) -> Iterator[FaultEvent]:
        rng = np.random.default_rng(np.random.SeedSequence(
            [self._seed, r]))
        t = 0.0
        while True:
            t += float(rng.exponential(self._mtbf))
            yield FaultEvent(t=t, replica=r, kind="fail")
            t += float(rng.exponential(self._mttr))
            yield FaultEvent(t=t, replica=r, kind="recover")

    def __iter__(self) -> Iterator[FaultEvent]:
        if self.stochastic:
            return heapq.merge(
                *(self._replica_stream(r) for r in range(self._n_replicas)),
                key=lambda e: e.t)
        return iter(self._events)

    def __len__(self) -> int:
        if self.stochastic:
            raise TypeError("a stochastic MTBF schedule is unbounded; "
                            "iterate it lazily instead")
        return len(self._events)

    def validate_for(self, n_replicas: int) -> None:
        """Reject events naming replicas the fleet doesn't have (checked
        up-front for deterministic schedules; the MTBF mode generates
        in-range replicas by construction)."""
        if self.stochastic:
            if self._n_replicas > n_replicas:
                raise ValueError(
                    f"FaultSchedule.mtbf targets {self._n_replicas} "
                    f"replicas but the fleet has {n_replicas}")
            return
        for e in self._events:
            if e.replica >= n_replicas:
                raise ValueError(
                    f"fault event {e} targets replica {e.replica} but "
                    f"the fleet has {n_replicas} replicas (0.."
                    f"{n_replicas - 1})")

    def __repr__(self) -> str:
        if self.stochastic:
            return (f"FaultSchedule.mtbf({self._mtbf}, {self._mttr}, "
                    f"{self._n_replicas}, seed={self._seed})")
        return f"FaultSchedule({self._events!r})"
