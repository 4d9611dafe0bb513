"""Continuous batching and SLO-aware elastic scaling.

The port's copy of the JAX package's ``serve/scheduler.py``, one
discrete-event loop with the JAX loop's event order, tie breaks (``seq``)
and budget rules, so on the same modelled round and restore times the two
give the same completions, counters, scale events and occupancy.

A gang round (:mod:`repro_torch.serve.engine`) stalls at fleet scope in a
way PipeCNN's kernel cascade never does: a whole padded batch enters and
leaves together, so one straggler stalls every co-scheduled request, and
queue skew between replicas goes unserved. Here the unit of scheduling is
the request:

  * each replica has ``batch`` **slots**; a free slot is filled from the
    head of the replica's queue at the next **microbatch boundary**
    (``t_round / batch`` apart for dp replicas, ``t_round / n_micro`` for
    pipeline stages), not when a round drains;
  * a slot holds one request for ``cost * t_round`` of modelled traversal
    and **retires on its own** at the first boundary past it: a
    ``cost > 1`` straggler holds only its own slot;
  * when queue depths skew past ``steal_threshold``, an under-loaded
    replica **steals** the newest request of the deepest queue at its
    boundary (one steal a boundary). A steal charges the request's retry
    budget as a failure's evacuation does (so ``retries=0`` turns stealing
    off), and a request whose budget is used up is never stolen.

:class:`AutoscalePolicy` scales the fleet on the same modelled clock:
every ``interval`` seconds the loop compares the windowed p95 with the SLO
and the fleet's load (filled slots + backlog over serving capacity) with
``util_high`` / ``util_low``, then spins a replica **up** (it serves only
after the modelled restore of its artifact) or **down** by a graceful
drain (its queue re-dispatched free of retry charge, its slots finishing).

Faults and rolling hot swaps ride the same loop as in the gang engine: a
failing replica loses its in-flight slots (readmitted against the retry
budget), and every admitted request ends as exactly one completion or one
rejection. With ``execute=True`` each admission group is padded to
``batch`` with zero images and runs version ``v``'s forward on the card
(``ServeEngine._slot_fn``): one launch of each kernel of the fold a group,
whatever the placement, and rows are independent, so every prediction is
the forward's for its image. The number of groups of the last run is
``ServeEngine.admission_groups``.
"""
from __future__ import annotations

import heapq
import itertools
from dataclasses import asdict, dataclass
from typing import List, Optional, Tuple

import numpy as np

from repro_torch.obs.metrics import record_report
from repro_torch.obs.trace import CAT_REQUEST
from repro_torch.serve.report import FleetReport, fleet_report
from repro_torch.serve.router import Completion, Request


@dataclass(frozen=True)
class AutoscalePolicy:
    """When and how far the fleet elastically scales.

    The scheduler evaluates the policy every ``interval`` modelled
    seconds: scale up one replica when the windowed p95 exceeds the
    engine's SLO or the load exceeds ``util_high``; scale down one
    (graceful drain) when the load falls below ``util_low``. ``cooldown``
    seconds must pass between decisions; ``window`` is how many recent
    completions feed the p95 signal. Load is (filled slots + queued
    requests) / (serving replicas * batch), so it exceeds 1 under a
    backlog: the burst signal.
    """
    min_replicas: int = 1              # never drain below this
    max_replicas: int = 8              # never spin up beyond this
    interval: float = 0.05             # seconds between policy evals
    cooldown: float = 0.0              # min seconds between decisions
    util_high: float = 0.85            # scale up above this load
    util_low: float = 0.30             # scale down below this load
    window: int = 32                   # completions in the p95 window

    def __post_init__(self):
        if not (1 <= self.min_replicas <= self.max_replicas):
            raise ValueError(
                f"AutoscalePolicy needs 1 <= min_replicas "
                f"({self.min_replicas}) <= max_replicas "
                f"({self.max_replicas})")
        if self.interval <= 0:
            raise ValueError(f"AutoscalePolicy.interval={self.interval}: "
                             "must be > 0 seconds")
        if self.cooldown < 0:
            raise ValueError(f"AutoscalePolicy.cooldown={self.cooldown}: "
                             "must be >= 0 seconds")
        if not (0 < self.util_low < self.util_high):
            raise ValueError(
                f"AutoscalePolicy needs 0 < util_low ({self.util_low}) "
                f"< util_high ({self.util_high})")
        if self.window < 1:
            raise ValueError(f"AutoscalePolicy.window={self.window}: "
                             "must be >= 1")


@dataclass(frozen=True)
class ScaleEvent:
    """One autoscaling decision (reports carry these as dicts)."""
    t: float                           # modelled time of the decision
    kind: str                          # "up" | "down"
    replica: int                       # which replica slot it targets
    reason: str                        # the signal that triggered it


@dataclass
class _Slot:
    """One in-flight request: admitted at a boundary, retires at the
    first boundary past ``t_ready = t_admit + cost * t_round``."""
    t_ready: float
    req: Request
    pred: int
    version: int
    t_admit: float = 0.0               # the request span's start time


class ContinuousScheduler:
    """Drives a :class:`~repro_torch.serve.engine.ServeEngine` with
    per-request slots. ``ServeEngine.serve`` builds it when the engine was
    constructed with ``scheduler="continuous"``, which needs the modelled
    clock (service and boundary times come from the cost model, so runs
    are deterministic)."""

    def __init__(self, engine):
        self.engine = engine

    # The serve loop is one long discrete-event simulation; splitting it
    # would scatter the closures over (clock, slots, events) state.
    def serve(self, requests: List[Request], *, faults=None,
              trace=None, metrics=None
              ) -> Tuple[List[Completion], FleetReport]:
        """Drain a request stream; returns (completions, fleet report).

        The gang ``serve``'s contract (every admitted request ends as
        exactly one completion or one admission rejection; faults and hot
        swaps honoured), with requests admitted and retired one by one at
        microbatch boundaries, stolen across queues, and the fleet scaled
        when the engine carries an :class:`AutoscalePolicy`.
        ``trace``/``metrics`` as in the gang ``serve``; the autoscaler's
        p95 window and load gauge live in the registry
        (``request_latency_window`` / ``fleet_load``): the exported
        signals are the decision's inputs.
        """
        from repro_torch.serve.engine import _serve_obs
        eng = self.engine
        eng.admission_groups = 0
        R0 = eng.replicas
        B = eng.batch
        policy = eng.autoscale
        router = eng.router
        nq = router.n_replicas         # max_replicas queues when elastic
        if faults is not None:
            faults.validate_for(R0)
        trace, metrics, ctr, ctr0, hist = _serve_obs(
            trace, metrics, nq, scheduler="continuous",
            clock=eng.clock_mode)

        done: List[Completion] = []
        pending = sorted(requests, key=lambda r: r.t_arrival)
        clock = 0.0
        seq = itertools.count()

        # -- per-replica state ------------------------------------------
        active = [r < R0 for r in range(nq)]    # part of the fleet
        up = [r < R0 for r in range(nq)]        # alive and serving-capable
        draining = [False] * nq                 # no new admissions
        drain_kind: List[Optional[str]] = [None] * nq   # "swap" | "scale"
        version = [eng._cur_version] * nq
        gen = [0] * nq                 # invalidates stale boundary events
        armed = [False] * nq           # a live boundary event exists
        no_steal_until = [0.0] * nq    # backoff after a refused steal
        slots: List[List[_Slot]] = [[] for _ in range(nq)]
        starting: set = set()          # scale-ups paying their restore

        attempts = {}                  # rid -> budget charges so far
        retry_q: list = []             # (t_ready, seq, Request)
        events: list = []              # (t, seq, kind, replica, gen)
        fail_t = {}
        ttr: List[float] = []
        swapped = set()
        # the autoscaler's p95 signal lives in the registry — one source
        # of truth for the decision input and the exported stream
        lat_window = metrics.window("request_latency_window",
                                    size=policy.window if policy else 64,
                                    help="recent ok-completion latencies "
                                         "(the autoscaler's p95 window)")
        g_load = metrics.gauge("fleet_load",
                               "(filled slots + backlog) / capacity")
        g_p95w = metrics.gauge("fleet_p95_window_s",
                               "windowed p95 latency the autoscaler reads")
        g_srv = metrics.gauge("fleet_replicas_serving",
                              "replicas accepting dispatch")
        scale_events: List[dict] = []
        last_scale_t = float("-inf")
        next_eval = policy.interval if policy else float("inf")

        # occupancy/busy integrals: occ_int is filled-slot-seconds,
        # busy is seconds with >= 1 filled slot
        busy = [0.0] * nq
        occ_int = [0.0] * nq
        last_t = [0.0] * nq

        def tick(r, t):
            # settle r's occupancy integral up to t (call BEFORE
            # mutating slots[r])
            dt = t - last_t[r]
            if dt <= 0:
                return
            n = len(slots[r])
            if n:
                occ_int[r] += n * dt
                busy[r] += dt
            last_t[r] = t

        fault_it = iter(faults) if faults is not None else iter(())
        next_fault = next(fault_it, None)

        def pull_faults(t):
            nonlocal next_fault
            while next_fault is not None and next_fault.t <= t:
                e, next_fault = next_fault, next(fault_it, None)
                if e.kind == "fail":
                    heapq.heappush(events,
                                   (e.t, next(seq), "fail", e.replica, -1))
                else:
                    t_up = e.t + eng._versions[
                        version[e.replica]]["t_restore"]
                    heapq.heappush(events,
                                   (t_up, next(seq), "up", e.replica, -1))

        def readmit(req, t, charge=True):
            # identical budget semantics to the gang engine: a charged
            # readmission consumes one retry; past the budget the
            # request ends as an explicit failed Completion
            if not charge:
                heapq.heappush(retry_q, (t, next(seq), req))
                return
            a = attempts.get(req.rid, 0) + 1
            attempts[req.rid] = a
            if a > eng.retries:
                done.append(Completion(
                    rid=req.rid, pred=-1, t_arrival=req.t_arrival,
                    t_done=t, replica=-1, status="failed",
                    attempts=a - 1))
                ctr["failed"].inc()
                trace.instant("failed", t, cat=CAT_REQUEST,
                              args={"rid": req.rid, "attempts": a - 1})
                return
            ctr["retries"].inc()
            trace.instant("retry", t, cat=CAT_REQUEST,
                          args={"rid": req.rid, "attempt": a})
            delay = eng.backoff * (2 ** (a - 1)) if eng.backoff else 0.0
            heapq.heappush(retry_q, (t + delay, next(seq), req))

        def note_dispatch(req, ok, t):
            if ok:
                trace.instant("enqueue", t, cat=CAT_REQUEST,
                              track=f"replica {router.last_replica}",
                              args={"rid": req.rid})
            else:
                ctr["rejected"].inc()
                trace.instant("reject", t, cat=CAT_REQUEST,
                              args={"rid": req.rid})

        def t_bound(r):
            # boundary cadence: one slot-fill opportunity per microbatch
            tr = eng._versions[version[r]]["t_round"]
            return tr / (B if eng.pp_stages == 1 else eng.n_micro)

        def arm(r, t):
            if armed[r]:
                return False
            armed[r] = True
            heapq.heappush(events, (t, next(seq), "boundary", r, gen[r]))
            return True

        def serving_ids():
            return [r for r in range(nq)
                    if active[r] and up[r] and not draining[r]]

        def admit_preds(take, v):
            # one padded single-replica forward an admission group; rows
            # are independent, so each pred is the forward's for its image
            if take:
                eng.admission_groups += 1
            if not eng.execute or not take:
                return [-1] * len(take)
            imgs = np.stack([q.image for q in take])
            if len(take) < B:
                pad = np.zeros((B - len(take),) + imgs.shape[1:],
                               imgs.dtype)
                imgs = np.concatenate([imgs, pad])
            preds = np.asarray(eng._slot_fn(v)(imgs))
            return [int(p) for p in preds[:len(take)]]

        # -- rolling hot swap (graceful drain, one replica at a time) ---
        def start_next_swap(t):
            sw = eng._pending_swap
            while sw["todo"] and sw["current"] is None:
                r = sw["todo"].pop(0)
                if not active[r]:
                    continue            # scaled away since the roll began
                if not up[r]:
                    # a down replica restores from the new artifact when
                    # its recovery lands — no drain needed
                    version[r] = sw["version"]
                    swapped.add(r)
                    ctr["swapped"].inc()
                    trace.instant("hot_swap", t,
                                  args={"replica": r,
                                        "version": sw["version"]})
                    continue
                draining[r] = True
                drain_kind[r] = "swap"
                sw["current"] = r
                for req in router.evacuate(r):
                    readmit(req, t, charge=False)
                if not slots[r]:
                    finish_swap_drain(r, t)
            if not sw["todo"] and sw["current"] is None:
                sw["state"] = "done"

        def finish_swap_drain(r, t):
            # in-flight slots finished: go down for the artifact restore
            sw = eng._pending_swap
            tick(r, t)
            up[r] = False
            gen[r] += 1
            armed[r] = False
            heapq.heappush(events, (t + sw["t_restore"], next(seq),
                                    "swapped", r, -1))

        def maybe_start_swap(t):
            sw = eng._pending_swap
            if sw is None or sw["state"] != "armed" or t < sw["at"]:
                return
            sw["state"] = "rolling"
            sw["todo"] = [r for r in range(nq) if active[r]]
            sw["current"] = None
            start_next_swap(t)

        # -- elastic scaling --------------------------------------------
        def scale_up(t, reason):
            free = [r for r in range(nq) if not active[r]]
            if not free:
                return False
            r = free[0]
            active[r] = True
            up[r] = False               # serves only after the restore
            draining[r] = False
            drain_kind[r] = None
            version[r] = eng._cur_version
            gen[r] += 1
            starting.add(r)
            last_t[r] = t
            t_up = t + eng._versions[version[r]]["t_restore"]
            heapq.heappush(events, (t_up, next(seq), "scaleup", r, -1))
            ctr["scale_up"].inc()
            trace.instant("scale_up", t,
                          args={"replica": r, "reason": reason})
            scale_events.append(asdict(ScaleEvent(
                t=t, kind="up", replica=r, reason=reason)))
            return True

        def finalize_down(r, t):
            tick(r, t)
            active[r] = False
            up[r] = False
            draining[r] = False
            drain_kind[r] = None
            gen[r] += 1
            armed[r] = False

        def scale_down(r, t, reason):
            # graceful drain (the hot_swap primitive): queued requests
            # re-dispatch free of retry charge, in-flight slots finish
            draining[r] = True
            drain_kind[r] = "scale"
            for req in router.evacuate(r):
                readmit(req, t, charge=False)
            ctr["scale_down"].inc()
            trace.instant("scale_down", t,
                          args={"replica": r, "reason": reason})
            scale_events.append(asdict(ScaleEvent(
                t=t, kind="down", replica=r, reason=reason)))
            if not slots[r]:
                finalize_down(r, t)

        def autoscale_eval(t):
            nonlocal last_scale_t
            sw = eng._pending_swap
            if sw is not None and sw["state"] == "rolling":
                return                  # one fleet mutation at a time
            srv = serving_ids()
            committed = [r for r in range(nq)
                         if active[r] and not draining[r]]
            load = sum(len(slots[r]) for r in srv) + router.backlog()
            cap = len(srv) * B
            # the decision signals pass through the registry: write the
            # gauges, then read THEM — the exported stream is the input
            g_srv.set(len(srv))
            g_load.set((load / cap) if cap else
                       (float("inf") if load else 0.0))
            g_p95w.set(lat_window.percentile(0.95))
            util = g_load.value
            p95w = g_p95w.value
            slo_bad = eng.slo > 0 and p95w > eng.slo
            if t - last_scale_t < policy.cooldown:
                return
            reason = f"util={util:.2f} p95={p95w * 1e3:.1f}ms"
            if (util > policy.util_high or slo_bad) and \
                    len(committed) < policy.max_replicas:
                if scale_up(t, reason):
                    last_scale_t = t
            elif (util < policy.util_low and not slo_bad and not starting
                  and len(committed) > policy.min_replicas and srv):
                # drain the serving replica with the least work in it
                r = min(srv, key=lambda i: (len(slots[i])
                                            + len(router.queues[i]), -i))
                scale_down(r, t, reason)
                last_scale_t = t

        # -- the boundary: retire -> drain-check -> fill -> steal -------
        def on_boundary(r, t, g):
            if g != gen[r] or not active[r] or not up[r]:
                return                  # stale: superseded by fail/drain
            armed[r] = False
            ctr["rounds"].inc()
            if any(active[i] and not up[i] and i not in starting
                   for i in range(nq)):
                ctr["degraded"].inc()
            eps = 1e-9 * max(t, 1.0)
            due = [s for s in slots[r] if s.t_ready <= t + eps]
            if due:
                tick(r, t)
                slots[r] = [s for s in slots[r] if s.t_ready > t + eps]
                for s in due:           # each request retires on its own
                    done.append(Completion(
                        rid=s.req.rid, pred=s.pred,
                        t_arrival=s.req.t_arrival, t_done=t, replica=r,
                        version=s.version,
                        attempts=attempts.get(s.req.rid, 0)))
                    ctr["done"].inc()
                    hist.observe(t - s.req.t_arrival)
                    lat_window.observe(t - s.req.t_arrival)
                    trace.span("request", s.t_admit, t,
                               track=f"replica {r}", cat=CAT_REQUEST,
                               args={"rid": s.req.rid,
                                     "version": s.version,
                                     "attempts": attempts.get(
                                         s.req.rid, 0)})
            if draining[r] and not slots[r]:
                if drain_kind[r] == "swap":
                    finish_swap_drain(r, t)
                else:
                    finalize_down(r, t)
                return
            if not draining[r]:
                free = B - len(slots[r])
                take = router.queues[r].pop(free) if free > 0 else []
                if take:
                    tick(r, t)
                    preds = admit_preds(take, version[r])
                    tr = eng._versions[version[r]]["t_round"]
                    for req, p in zip(take, preds):
                        slots[r].append(
                            _Slot(t + req.cost * tr, req, p, version[r],
                                  t_admit=t))
                if eng.steal_threshold > 0:
                    donors = [d for d in serving_ids() if d != r]
                    if donors:
                        d = max(donors,
                                key=lambda i: (len(router.queues[i]), -i))
                        if (len(router.queues[d]) - len(router.queues[r])
                                > eng.steal_threshold):
                            req = router.steal(d)
                            if req is not None:
                                a = attempts.get(req.rid, 0) + 1
                                if a > eng.retries:
                                    # never steal an exhausted budget —
                                    # a steal must not fail a request
                                    router.queues[d].submit(req)
                                    no_steal_until[r] = t + t_bound(r)
                                else:
                                    attempts[req.rid] = a
                                    ctr["steals"].inc()
                                    trace.instant(
                                        "steal", t, track=f"replica {r}",
                                        cat=CAT_REQUEST,
                                        args={"rid": req.rid, "from": d,
                                              "to": r})
                                    router.queues[r].submit(req)
            if slots[r] or len(router.queues[r]):
                armed[r] = True
                heapq.heappush(events, (t + t_bound(r), next(seq),
                                        "boundary", r, gen[r]))

        def handle_event(kind, r, t, g):
            sw = eng._pending_swap
            if kind == "boundary":
                on_boundary(r, t, g)
            elif kind == "fail":
                if not active[r] or not up[r]:
                    return              # already down
                tick(r, t)
                up[r] = False
                ctr["failures"].inc()
                trace.instant("fail", t, args={"replica": r})
                fail_t[r] = t
                gen[r] += 1
                armed[r] = False
                for s in slots[r]:      # in-flight slots are lost
                    readmit(s.req, t)
                slots[r] = []
                for req in router.evacuate(r):
                    readmit(req, t)
                if draining[r] and drain_kind[r] == "swap" and \
                        sw is not None and sw.get("current") == r:
                    # the dying replica restores from the NEW artifact
                    version[r] = sw["version"]
                    swapped.add(r)
                    ctr["swapped"].inc()
                    trace.instant("hot_swap", t,
                                  args={"replica": r,
                                        "version": sw["version"]})
                    draining[r] = False
                    drain_kind[r] = None
                    sw["current"] = None
                    start_next_swap(t)
                elif draining[r] and drain_kind[r] == "scale":
                    finalize_down(r, t)
            elif kind == "up":
                if not active[r] or up[r]:
                    return
                if sw is not None and sw.get("current") == r:
                    return              # the swap's restore owns r
                if r in starting:
                    return              # the scale-up's restore owns r
                up[r] = True
                gen[r] += 1
                last_t[r] = t
                ctr["recoveries"].inc()
                trace.instant("recover", t, args={"replica": r})
                if r in fail_t:
                    ttr.append(t - fail_t.pop(r))
            elif kind == "scaleup":
                starting.discard(r)
                if not active[r] or up[r]:
                    return              # cancelled / already recovered
                up[r] = True
                gen[r] += 1
                last_t[r] = t
            elif kind == "swapped":
                if sw is None:
                    return
                version[r] = sw["version"]
                up[r] = True
                gen[r] += 1
                last_t[r] = t
                draining[r] = False
                drain_kind[r] = None
                swapped.add(r)
                ctr["swapped"].inc()
                trace.instant("hot_swap", t,
                              args={"replica": r, "version": sw["version"]})
                fail_t.pop(r, None)
                sw["current"] = None
                start_next_swap(t)

        # -- the discrete-event loop ------------------------------------
        while True:
            pull_faults(clock)
            moved = True
            while moved:                # fixed point at this timestamp
                moved = False
                if events and events[0][0] <= clock:
                    t_e, _, kind, r, g = heapq.heappop(events)
                    handle_event(kind, r, t_e, g)
                    moved = True
                    continue
                maybe_start_swap(clock)
                if policy and next_eval <= clock:
                    autoscale_eval(clock)
                    next_eval += policy.interval
                    moved = True
                    continue
                mask = [active[i] and up[i] and not draining[i]
                        for i in range(nq)]
                if any(mask):
                    if pending and pending[0].t_arrival <= clock:
                        req = pending.pop(0)
                        note_dispatch(req, router.dispatch(req, mask),
                                      clock)
                        moved = True
                        continue
                    if retry_q and retry_q[0][0] <= clock:
                        _, _, req = heapq.heappop(retry_q)
                        note_dispatch(req, router.dispatch(req, mask),
                                      clock)
                        moved = True
                        continue
                # arm a boundary wherever there is queued work — or an
                # idle replica that could steal across a deep skew
                depths = router.depths()
                deepest = max((depths[i] for i in serving_ids()),
                              default=0)
                for r in serving_ids():
                    if armed[r]:
                        continue
                    if depths[r] or slots[r] or (
                            eng.steal_threshold > 0
                            and eng.retries > 0
                            and clock >= no_steal_until[r]
                            and deepest - depths[r] > eng.steal_threshold):
                        if arm(r, clock):
                            moved = True
            outstanding = (bool(pending) or bool(retry_q)
                           or router.backlog() > 0
                           or any(slots[r] for r in range(nq)))
            if not outstanding:
                break
            # traffic waiting, nothing serving, nothing scheduled to
            # recover: the emergency scale-up (liveness under autoscale)
            if (policy and not serving_ids() and not starting
                    and not events and next_fault is None):
                if scale_up(clock, "emergency: no serving replica"):
                    last_scale_t = clock
                    continue
            srv_now = serving_ids()
            cands = []
            if srv_now:
                if pending:
                    cands.append(pending[0].t_arrival)
                if retry_q:
                    cands.append(retry_q[0][0])
            if events:
                cands.append(events[0][0])
            if next_fault is not None:
                cands.append(next_fault.t)
            if policy and (srv_now or starting or events
                           or next_fault is not None):
                cands.append(next_eval)
            if not cands:
                # dead fleet, no recovery, no elasticity left: fail
                # every outstanding request explicitly — none stranded
                for req in pending + [e[2] for e in retry_q]:
                    t_f = max(clock, req.t_arrival)
                    done.append(Completion(
                        rid=req.rid, pred=-1, t_arrival=req.t_arrival,
                        t_done=t_f, replica=-1,
                        status="failed",
                        attempts=attempts.get(req.rid, 0)))
                    ctr["failed"].inc()
                    trace.instant("failed", t_f, cat=CAT_REQUEST,
                                  args={"rid": req.rid,
                                        "dead_fleet": True})
                pending, retry_q = [], []
                break
            clock = max(clock, min(cands))

        for r in range(nq):
            tick(r, clock)
        sw = eng._pending_swap
        if sw is not None:
            # stream ended before the roll finished: finalize the
            # remaining version flips without extending the makespan
            for r in range(nq):
                if active[r] and r not in swapped:
                    swapped.add(r)
                    ctr["swapped"].inc()
                    trace.instant("hot_swap", clock,
                                  args={"replica": r,
                                        "version": sw["version"]})
            eng._adopt_version(sw["version"])
            eng._pending_swap = None
        makespan = clock
        occupancy = [occ_int[r] / (makespan * B) if makespan > 0 else 0.0
                     for r in range(nq)]
        # the report reads this run's deltas from the registry — the
        # same counters the metrics snapshot exports
        n_of = {k: c.value - ctr0[k] for k, c in ctr.items()}
        g_srv.set(sum(active))
        rep = fleet_report(
            done, router.rejected, mode=eng.mode, replicas=R0,
            pp_stages=eng.pp_stages, batch=B, clock=eng.clock_mode,
            rounds=n_of["rounds"], busy_s=busy, makespan_s=makespan,
            bubble_fraction=(eng.stage_plan.bubble(eng.n_micro)
                             if eng.stage_plan else 0.0),
            n_retries=n_of["retries"], n_failures=n_of["failures"],
            n_recoveries=n_of["recoveries"],
            degraded_rounds=n_of["degraded"], time_to_recover_s=ttr,
            n_swapped=n_of["swapped"], slo_s=eng.slo,
            scheduler="continuous", occupancy=occupancy,
            n_steals=n_of["steals"], n_scale_up=n_of["scale_up"],
            n_scale_down=n_of["scale_down"], scale_events=scale_events,
            replicas_final=sum(active), device=str(eng.device))
        record_report(metrics, rep)
        return done, rep
