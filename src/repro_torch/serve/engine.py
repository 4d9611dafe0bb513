"""CNN serving engine of the port: one router in front of a fleet of
replicas, the JAX package's ``serve/engine.py`` on one card.

Four modes, set by ``(replicas, pp_stages)`` as in the JAX package:

  * **single**: one replica;
  * **dp**: R replicas; each gang round drains one padded micro-batch a
    replica, and replica r runs its micro-batch at the serving batch (so
    it launches the plans compiled for that batch) on its own CUDA
    stream;
  * **pp**: the network split into S stages balanced on the card's cost
    model (:func:`~repro_torch.serve.stage_planner.plan_stages`); the
    padded batch's M microbatches stream through them in GPipe's
    fill-drain ticks, one CUDA stream a stage
    (:mod:`repro_torch.parallel.pipeline_par`); a microbatch launches
    the serving batch's plans (the kernels' tiles and splits fit any
    batch);
  * **hybrid**: both, R x S streams.

The JAX engine maps a (data, pipe) mesh of R x S devices and raises
without them. Here a replica or a stage is a stream of the one card, so
every mode runs on one device; on the CPU the same work runs in order. A
round ends with one synchronisation: the copy of its predictions to the
host.

Clocks. ``"measured"``: the round's wall time on the host, from the
images' copy to the card until the predictions are back; it is what one
card does for the whole fleet, and the first round of each model version
runs once outside the clock (the JAX engine compiles outside it).
``"modeled"``: the JAX engine's meaning, where a replica is a device:
dp replicas run concurrently, so a round is one replica's micro-batch
(:func:`~repro_torch.serve.stage_planner.total_cost`), and a pp round is
``(M + S - 1)`` times the slowest stage, with M swept over the divisors
of the batch for the least modelled round time unless pinned. A gang
round costs its dearest request's ``cost`` times that. With
``execute=False`` nothing runs and every prediction is -1.

Resilience. ``serve(requests, faults=FaultSchedule(...))`` injects
replica fail/recover events: a failed replica loses its round in flight
(those requests re-dispatch against a per-request retry budget, with
exponential backoff; past it they end as ``Completion(status="failed")``),
its queue is evacuated to the survivors, and the fleet serves degraded
rounds until the replica recovers, charged the modelled latency of
reloading its committed artifact (:func:`restore_latency_model`).
``hot_swap(compiled)`` registers a rolling upgrade the same loop runs:
replicas drain and swap one at a time, evacuated requests re-dispatch
for free, and each completion records the version that served it. Every
admitted request ends as exactly one completion or one rejection.

Observability. ``serve(requests, trace=, metrics=)`` records the run into
a :class:`~repro_torch.obs.TraceRecorder` (spans and instants at the JAX
engine's points, with its names) and a
:class:`~repro_torch.obs.MetricsRegistry`: the loop counts into the
registry's ``serve_<key>_total`` counters (:data:`SERVE_COUNTERS`' keys)
and its latency histogram, and the report reads this run's deltas back
from them, so the report and the exported metrics are one set of books.
Left as None, the trace records nothing and the registry is a throwaway
one. On the measured clock the gang loop also times its host work (the
call, each round's drain, pack, copy, launches and sync, the report) on
the epoch clock, when a recorder is given or a torch profile runs: the
host spans of :mod:`repro_torch.obs.trace`.

Gang rounds are the default. ``scheduler="continuous"`` (modelled clock
only) hands the whole call to
:class:`~repro_torch.serve.scheduler.ContinuousScheduler`: requests admit
and retire one by one at microbatch boundaries, queues work-steal past
``steal_threshold``, and an ``autoscale`` policy grows and shrinks the
fleet. Each admission group runs version ``v``'s forward on the card
(:meth:`ServeEngine._slot_fn`), a single-replica fold whatever the
placement.
"""
from __future__ import annotations

import heapq
import itertools
import time
from typing import List, Optional, Tuple, Union

import numpy as np
import torch

from repro_torch.core.roofline import device_profile
from repro_torch.kernels.autotune import DEFAULT_BUDGET
from repro_torch.models.cnn import CNN, QuantCNN
from repro_torch.obs.metrics import MetricsRegistry, record_report
from repro_torch.obs.trace import (CAT_REQUEST, FLEET_TRACK, NULL_RECORDER,
                                   HostCall, TraceRecorder, host_call,
                                   now_ns)
from repro_torch.parallel.pipeline_par import gpipe_schedule
from repro_torch.serve.faults import FaultSchedule
from repro_torch.serve.report import FleetReport, fleet_report
from repro_torch.serve.router import Completion, Request, Router
from repro_torch.serve.stage_planner import plan_stages, total_cost

Model = Union[CNN, QuantCNN]

# (counter key, help) of the serve counters; a key is the registry's
# serve_<key>_total
SERVE_COUNTERS = (
    ("done", "requests served ok"),
    ("failed", "retry budget exhausted -> Completion(failed)"),
    ("rejected", "admission-control rejections"),
    ("retries", "lost requests re-dispatched against budget"),
    ("steals", "requests work-stolen across queues"),
    ("failures", "replica fail events that landed"),
    ("recoveries", "replicas restored into dispatch"),
    ("degraded", "rounds served with < replicas alive"),
    ("swapped", "replicas rolled by hot_swap"),
    ("scale_up", "replicas the autoscaler spun up"),
    ("scale_down", "replicas the autoscaler drained out"),
    ("rounds", "gang rounds / microbatch boundaries"),
)



def _serve_obs(trace, metrics, n_replicas, *, scheduler, clock):
    """The (trace, metrics) pair a serving loop records into: the caller's,
    else a recorder that keeps nothing and a fresh registry, so the loops
    record unconditionally. Tracks are registered up front (fleet first,
    then each replica), so thread ids never depend on event order.
    Returns ``(trace, metrics, counters, their values before this run,
    the latency histogram)``."""
    trace = trace if trace is not None else NULL_RECORDER
    metrics = metrics if metrics is not None else MetricsRegistry()
    trace.track(FLEET_TRACK)
    for r in range(n_replicas):
        trace.track(f"replica {r}")
    trace.set_meta("scheduler", scheduler)
    trace.set_meta("clock", clock)
    ctr = {key: metrics.counter(f"serve_{key}_total", help)
           for key, help in SERVE_COUNTERS}
    base = {key: c.value for key, c in ctr.items()}
    hist = metrics.histogram("request_latency_seconds",
                             "ok-completion request latency")
    return trace, metrics, ctr, base, hist


# The reference's MODEL of an artifact restore (not a measurement): a
# recovering or hot-swapping replica re-reads its committed artifact at a
# fixed bandwidth plus a constant reattach overhead, charged to the clock.
# Kept at the JAX package's values, so both modelled clocks agree.
RESTORE_BW_BYTES_S = 2e9
RESTORE_OVERHEAD_S = 5e-3


def params_nbytes(model: Model) -> int:
    """Bytes of a model's parameters (fp32/bf16 weights and biases, or an
    int8 model's codes and vectors): its artifact's leaf payload."""
    return int(sum(t.numel() * t.element_size()
                   for t in model.state_dict().values()))


def restore_latency_model(n_bytes: int) -> float:
    """Modelled seconds to restore a replica from an ``n_bytes`` artifact."""
    return n_bytes / RESTORE_BW_BYTES_S + RESTORE_OVERHEAD_S


def _device(model: Model) -> torch.device:
    """The device of a model's first tensor (an int8 model has buffers
    only)."""
    return next(iter(model.state_dict().values())).device


def _run_dtype(model: Model) -> str:
    return "int8" if isinstance(model, QuantCNN) else \
        str(model.in_dtype).removeprefix("torch.")


class ServeEngine:
    """Routes request streams onto R replicas of S stages of ``model``
    (fp32, bf16 or int8) on the device of its tensors."""

    def __init__(self, model: Model, *, batch: int = 8, replicas: int = 1,
                 pp_stages: int = 1, n_microbatches: int = 0,
                 clock: str = "measured", max_queue: int = 0,
                 execute: bool = True, retries: int = 0,
                 backoff: float = 0.0, slo: float = 0.0,
                 scheduler: str = "gang", steal_threshold: int = 0,
                 autoscale=None, vmem_budget: int = DEFAULT_BUDGET):
        from repro_torch.serve.scheduler import AutoscalePolicy
        if clock not in ("measured", "modeled"):
            raise ValueError(f"unknown clock {clock!r}")
        if retries < 0:
            raise ValueError(f"retries={retries} must be >= 0")
        if backoff < 0 or slo < 0:
            raise ValueError("backoff/slo are seconds >= 0")
        if scheduler not in ("gang", "continuous"):
            raise ValueError(f"unknown scheduler {scheduler!r}: "
                             "gang or continuous")
        if scheduler == "continuous" and clock != "modeled":
            raise ValueError(
                "scheduler='continuous' needs clock='modeled': slot "
                "service and microbatch-boundary times come from the "
                "cost model, not wall time")
        if steal_threshold < 0:
            raise ValueError(
                f"steal_threshold={steal_threshold} must be >= 0 "
                "(0 = stealing off)")
        if isinstance(autoscale, dict):
            autoscale = AutoscalePolicy(**autoscale)
        if (steal_threshold or autoscale is not None) and \
                scheduler != "continuous":
            raise ValueError(
                "steal_threshold / autoscale only exist under "
                "scheduler='continuous': gang rounds have no per-request "
                "slots to steal or scale")
        if autoscale is not None and not (
                autoscale.min_replicas <= replicas
                <= autoscale.max_replicas):
            raise ValueError(
                f"replicas={replicas} outside the autoscale range "
                f"[{autoscale.min_replicas}, {autoscale.max_replicas}]")
        R, S = replicas, pp_stages
        if R < 1 or S < 1:
            raise ValueError("replicas and pp_stages must be >= 1")
        if not execute and clock == "measured":
            raise ValueError(
                "execute=False (device-free simulation) has no wall time "
                "to measure; use clock='modeled'")
        self.scheduler = scheduler
        self.steal_threshold = int(steal_threshold)
        self.autoscale = autoscale
        self.model = model
        self.cfg = model.cfg
        self.dtype = _run_dtype(model)
        self.device = _device(model)
        self.batch = batch
        self.replicas = R
        self.pp_stages = S
        self.clock_mode = clock
        self.execute = execute
        self.retries = int(retries)
        self.backoff = float(backoff)
        self.slo = float(slo)
        self.vmem_budget = vmem_budget
        self.backend = device_profile(self.device).tag
        self.mode = ("single" if R * S == 1 else "dp" if S == 1 else
                     "pp" if R == 1 else "hybrid")
        # GPipe wants M >= S to amortise the bubble, but a larger M shrinks
        # the microbatch the kernels run at: sweep the divisors of the batch
        # (so every microbatch has one shape) for the least modelled round
        if S > 1:
            if n_microbatches:
                if batch % n_microbatches:
                    raise ValueError(
                        f"n_microbatches={n_microbatches} must divide the "
                        f"plan batch {batch}")
                cands = [n_microbatches]
            else:
                cands = [d for d in range(1, batch + 1) if batch % d == 0]
            scored = [(sp.round_time(m), m, sp) for m, sp in (
                (m, self._plan_stages(self.cfg, self.dtype, batch // m))
                for m in cands)]
            self.t_round_model, self.n_micro, self.stage_plan = min(
                scored, key=lambda c: (c[0], c[1]))
        else:
            self.n_micro = 1
            self.stage_plan = None
            # one replica's micro-batch: dp replicas run concurrently
            self.t_round_model = self._total_cost(self.cfg, self.dtype)
        self.mb = batch // self.n_micro
        # an elastic fleet has queues up to max_replicas; the scheduler's
        # active mask decides which receive dispatch
        self.router = Router(autoscale.max_replicas if autoscale is not None
                             else R, batch, max_queue=max_queue)
        self.t_restore_model = restore_latency_model(params_nbytes(model))
        self._cur_version = 0
        self._n_versions = 1
        self._versions = {0: dict(model=model, cfg=self.cfg,
                                  stage_plan=self.stage_plan,
                                  t_round=self.t_round_model,
                                  t_restore=self.t_restore_model)}
        self._pending_swap = None
        self._warm = set()              # versions whose first round ran
        self._streams = None            # [replica][stage], made on first use
        self._host: Optional[HostCall] = None   # the serve call's host spans
        self.admission_groups = 0       # slot forwards of the last
        #                                 continuous run (0 for gang runs)

    @classmethod
    def from_spec(cls, model: Model, spec) -> "ServeEngine":
        """The engine of a compiled spec: its placement and serving
        sub-specs are the whole constructor."""
        return cls(model, batch=spec.serving.batch,
                   replicas=spec.placement.replicas,
                   pp_stages=spec.placement.pp_stages,
                   n_microbatches=spec.placement.microbatches,
                   clock=spec.serving.clock,
                   max_queue=spec.serving.max_queue,
                   execute=spec.serving.execute,
                   retries=spec.serving.retries,
                   backoff=spec.serving.backoff, slo=spec.serving.slo,
                   scheduler=spec.serving.scheduler,
                   steal_threshold=spec.serving.steal_threshold,
                   autoscale=spec.serving.autoscale,
                   vmem_budget=spec.tiling.vmem_budget)

    def _plan_stages(self, cfg, dtype: str, batch: int):
        return plan_stages(cfg, self.pp_stages, batch=batch, dtype=dtype,
                           vmem_budget=self.vmem_budget,
                           backend=self.backend)

    def _total_cost(self, cfg, dtype: str) -> float:
        return total_cost(cfg, self.batch, dtype=dtype,
                          vmem_budget=self.vmem_budget, backend=self.backend)

    # -- execution -----------------------------------------------------------

    def _replica_streams(self, r: int):
        """Replica ``r``'s stage streams on the card (None on the CPU)."""
        if self.device.type != "cuda":
            return None
        if self._streams is None:
            self._streams = [[torch.cuda.Stream(self.device)
                              for _ in range(self.pp_stages)]
                             for _ in range(self.replicas)]
        return self._streams[r]

    def _stage_logits(self, v: int, r: int, micro) -> List[torch.Tensor]:
        """Version ``v``'s model over replica ``r``'s microbatches, in
        fill-drain ticks over its stages (one stage: the whole fold)."""
        rec = self._versions[v]
        model, sp = rec["model"], rec["stage_plan"]
        groups = [model.groups] if sp is None else [s.groups
                                                    for s in sp.stages]
        micro = [h.to(model.in_dtype) for h in micro]
        return gpipe_schedule(lambda s, h: model.forward_groups(h, groups[s]),
                              micro, len(groups),
                              streams=self._replica_streams(r))

    def staged_logits(self, x: torch.Tensor, v: int = 0) -> torch.Tensor:
        """The placement's forward of ``x`` (B, H, W, C) through version
        ``v``'s model (0: the compiled one, whatever a ``hot_swap`` has
        adopted since): B rows split over the replicas, each share into
        the microbatches of its stage schedule. B must divide into R x M."""
        R, M = self.replicas, self.n_micro
        if x.shape[0] % (R * M):
            raise ValueError(f"batch {x.shape[0]} does not divide into "
                             f"{R} replicas x {M} microbatches")
        mb = x.shape[0] // (R * M)
        with torch.inference_mode():
            return torch.cat([out for r in range(R)
                              for out in self._stage_logits(
                                  v, r, x[r * M * mb:(r + 1) * M * mb]
                                  .split(mb))])

    def _pack(self, round_items) -> np.ndarray:
        """The gang round's super-batch: replica-major ``(R*batch, ...)``
        (dp), or microbatch-major ``(n_micro * R * mb, ...)`` (pp/hybrid):
        the JAX engine's layouts."""
        shape = (self.cfg.input_hw, self.cfg.input_hw, self.cfg.input_ch)
        per_rep = [np.zeros((self.batch,) + shape, np.float32) if imgs is None
                   else np.asarray(imgs) for _, _, imgs, _ in round_items]
        arr = np.stack(per_rep)                     # (R, batch, ...)
        if self.pp_stages > 1:
            arr = arr.reshape(self.replicas, self.n_micro, self.mb, *shape)
            arr = arr.transpose(1, 0, 2, 3, 4, 5)   # (n_micro, R, mb, ...)
        return arr.reshape(-1, *shape)

    def _unpack_preds(self, preds: np.ndarray) -> np.ndarray:
        """(round rows,) in :meth:`_pack`'s order -> (R, batch)."""
        if self.pp_stages > 1:
            p = preds.reshape(self.n_micro, self.replicas, self.mb)
            return p.transpose(1, 0, 2).reshape(self.replicas, self.batch)
        return preds.reshape(self.replicas, self.batch)

    def _round_preds(self, packed: np.ndarray, versions) -> np.ndarray:
        """One gang round on the device: the packed super-batch goes to
        the device in one copy, replica r runs ``versions[r]``'s model on
        its rows (every replica, as every device of the JAX mesh computes
        its padded rows), and the argmax of the logits widened to fp32
        comes back in one copy; returns (R, batch) predictions."""
        R, M, mb = self.replicas, self.n_micro, self.mb
        hs = self._host
        if hs is not None:
            t = now_ns()
        x = torch.from_numpy(packed).to(self.device)
        if hs is not None:
            t = hs.span("h2d", t)
        rows = [[x[(m * R + r) * mb:(m * R + r + 1) * mb] for m in range(M)]
                for r in range(R)]
        with torch.inference_mode():
            outs = [self._stage_logits(versions[r], r, rows[r])
                    for r in range(R)]
            flat = torch.cat([outs[r][m].float().argmax(-1)
                              for m in range(M) for r in range(R)])
        if hs is not None:
            t = hs.span("enqueue", t)
        preds = flat.cpu().numpy()
        if hs is not None:
            hs.span("sync", t)
        return self._unpack_preds(preds)

    def _slot_fn(self, v: int):
        """The continuous scheduler's execution unit: ``imgs`` (batch, H,
        W, C), a padded admission group as a host array -> its predictions
        (batch,). Version ``v``'s compiled forward on the device: one copy
        of the group to the device, the batch converted to the run dtype,
        the fold over the groups (a single replica, whatever the
        placement), and the argmax of the logits widened to fp32, as the
        gang round takes it. Rows are independent in every mode, so each
        prediction is the forward's for its image."""
        model = self._versions[v]["model"]

        def fn(imgs: np.ndarray) -> np.ndarray:
            x = torch.from_numpy(imgs).to(self.device).to(model.in_dtype)
            with torch.inference_mode():
                return model(x).float().argmax(-1).cpu().numpy()
        return fn

    # -- rolling hot swap ----------------------------------------------------

    def hot_swap(self, artifact, *, at: float = 0.0) -> int:
        """Register a rolling upgrade to ``artifact``: a ``CompiledCNN``
        (its model) or a :class:`CNN` / :class:`QuantCNN` on the fleet's
        device. The next :meth:`serve` runs the roll from time ``at``:
        replicas leave dispatch one at a time, their queues re-dispatch
        without charging the retry budget, each pays the modelled restore
        of the new artifact and rejoins on the new version; once all have
        rolled, the engine adopts it. Returns the version id."""
        if self._pending_swap is not None:
            raise RuntimeError("a hot_swap is already registered; serve a "
                               "stream to complete it first")
        model = getattr(artifact, "model", artifact)
        new_cfg = model.cfg
        for f in ("input_hw", "input_ch", "n_classes"):
            if getattr(new_cfg, f) != getattr(self.cfg, f):
                raise ValueError(
                    f"hot_swap artifact is incompatible with the serving "
                    f"fleet: {f}={getattr(new_cfg, f)} vs "
                    f"{getattr(self.cfg, f)}")
        if _device(model) != self.device:
            raise ValueError(f"hot_swap artifact is on {_device(model)}; "
                             f"the fleet serves on {self.device}")
        dtype = _run_dtype(model)
        if self.pp_stages > 1:
            # the same microbatch split, stages rebalanced for the new dtype
            sp = self._plan_stages(new_cfg, dtype, self.mb)
            t_round = sp.round_time(self.n_micro)
        else:
            sp = None
            t_round = self._total_cost(new_cfg, dtype)
        v = self._n_versions
        self._n_versions += 1
        self._versions[v] = dict(model=model, cfg=new_cfg, stage_plan=sp,
                                 t_round=t_round,
                                 t_restore=restore_latency_model(
                                     params_nbytes(model)))
        self._pending_swap = {"state": "armed", "at": float(at),
                              "version": v,
                              "t_restore": self._versions[v]["t_restore"],
                              "todo": [], "current": None}
        return v

    def _adopt_version(self, v: int) -> None:
        """Make version ``v`` the engine's compiled state (the roll is
        complete: later ``serve`` calls start on ``v``)."""
        rec = self._versions[v]
        self.model = rec["model"]
        self.cfg = rec["cfg"]
        self.dtype = _run_dtype(rec["model"])
        self.stage_plan = rec["stage_plan"]
        self.t_round_model = rec["t_round"]
        self.t_restore_model = rec["t_restore"]
        self._cur_version = v

    # -- the serving loop ----------------------------------------------------

    def serve(self, requests: List[Request], *,
              faults: Optional[FaultSchedule] = None,
              trace: Optional[TraceRecorder] = None,
              metrics: Optional[MetricsRegistry] = None
              ) -> Tuple[List[Completion], FleetReport]:
        """Drain a request stream; returns (completions, fleet report).

        The JAX engine's gang loop: admit arrivals up to the clock (router
        policy and admission control over the alive replicas), drain one
        padded micro-batch a replica, advance the clock by the round's
        service time. Fault and swap events landing inside a round hit it
        in flight. Invariant: every admitted request ends as exactly one
        completion or one admission rejection, even if the whole fleet
        dies. ``trace``/``metrics`` receive the run's events and counters
        (see the module docstring); a registry is per run, its counters
        reconcile with this run's report. With ``scheduler="continuous"``
        the call goes to
        :class:`~repro_torch.serve.scheduler.ContinuousScheduler`."""
        if self.scheduler == "continuous":
            from repro_torch.serve.scheduler import ContinuousScheduler
            return ContinuousScheduler(self).serve(
                requests, faults=faults, trace=trace, metrics=metrics)
        hs = self._host = (host_call(trace) if self.clock_mode == "measured"
                           else None)
        done, rep = self._gang(requests, faults, trace, metrics)
        if hs is not None:
            # closed out here, so the loop's frame and its arrays, freed
            # as it returns, are inside the call's span
            hs.span("serve", hs.t0, {"n": len(requests),
                                     "rounds": rep.rounds})
            self._host = None
        return done, rep

    def _gang(self, requests, faults, trace, metrics):
        """The gang loop of :meth:`serve`."""
        hs = self._host
        R = self.replicas
        self.admission_groups = 0
        trace, metrics, ctr, ctr0, hist = _serve_obs(
            trace, metrics, R, scheduler="gang", clock=self.clock_mode)
        if faults is not None:
            faults.validate_for(R)
        router = self.router
        done: List[Completion] = []
        busy = [0.0] * R
        clock = 0.0
        pending = sorted(requests, key=lambda r: r.t_arrival)

        up = [True] * R
        version = [self._cur_version] * R
        attempts = {}                   # rid -> losses charged so far
        retry_q: list = []              # (t_ready, seq, Request)
        events: list = []               # (t, seq, kind, replica)
        seq = itertools.count()
        fail_t = {}                     # replica -> time its failure landed
        ttr: List[float] = []
        swapped = set()

        fault_it = iter(faults) if faults is not None else iter(())
        next_fault = next(fault_it, None)

        def pull_faults(t):
            # materialise schedule events up to t (MTBF streams are
            # infinite); a recovery becomes an "up" event only after the
            # modelled restore of the artifact the replica will load
            nonlocal next_fault
            while next_fault is not None and next_fault.t <= t:
                e, next_fault = next_fault, next(fault_it, None)
                if e.kind == "fail":
                    heapq.heappush(events,
                                   (e.t, next(seq), "fail", e.replica))
                else:
                    t_up = e.t + self._versions[
                        version[e.replica]]["t_restore"]
                    heapq.heappush(events,
                                   (t_up, next(seq), "up", e.replica))

        def readmit(req, t, charge=True):
            # requests lost or evacuated by a failure use retry budget; a
            # graceful swap drain re-admits for free (charge=False)
            if not charge:
                heapq.heappush(retry_q, (t, next(seq), req))
                return
            a = attempts.get(req.rid, 0) + 1
            attempts[req.rid] = a
            if a > self.retries:
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
            delay = self.backoff * (2 ** (a - 1)) if self.backoff else 0.0
            heapq.heappush(retry_q, (t + delay, next(seq), req))

        def note_dispatch(req, ok, t):
            # the router decided: an enqueue lands on the chosen replica's
            # track, an admission rejection is a fleet-level instant
            if ok:
                trace.instant("enqueue", t, cat=CAT_REQUEST,
                              track=f"replica {router.last_replica}",
                              args={"rid": req.rid})
            else:
                ctr["rejected"].inc()
                trace.instant("reject", t, cat=CAT_REQUEST,
                              args={"rid": req.rid})

        def start_next_swap(t):
            sw = self._pending_swap
            while sw["todo"] and sw["current"] is None:
                r = sw["todo"].pop(0)
                if not up[r]:
                    # a down replica restores from the new artifact when
                    # its recovery lands: no drain needed
                    version[r] = sw["version"]
                    swapped.add(r)
                    ctr["swapped"].inc()
                    trace.instant("hot_swap", t,
                                  args={"replica": r,
                                        "version": sw["version"]})
                    continue
                up[r] = False
                for req in router.evacuate(r):
                    readmit(req, t, charge=False)
                heapq.heappush(events,
                               (t + sw["t_restore"], next(seq),
                                "swapped", r))
                sw["current"] = r
            if not sw["todo"] and sw["current"] is None:
                sw["state"] = "done"

        def maybe_start_swap(t):
            sw = self._pending_swap
            if sw is None or sw["state"] != "armed" or t < sw["at"]:
                return
            sw["state"] = "rolling"
            sw["todo"] = list(range(R))
            sw["current"] = None
            start_next_swap(t)

        def handle_event(kind, r, t_e, serving=None):
            sw = self._pending_swap
            if kind == "fail":
                if not up[r]:
                    return              # already down (restoring/swapping)
                up[r] = False
                ctr["failures"].inc()
                trace.instant("fail", t_e, args={"replica": r})
                fail_t[r] = t_e
                if serving is not None and r not in serving["lost"]:
                    take = serving["take"].get(r) or ()
                    if take:            # the round in flight is lost
                        serving["lost"].add(r)
                        busy[r] += t_e - serving["t0"]
                        trace.span("round", serving["t0"], t_e,
                                   track=f"replica {r}",
                                   args={"aborted": True})
                        for req in take:
                            readmit(req, t_e)
                for req in router.evacuate(r):
                    readmit(req, t_e)
            elif kind == "up":
                if up[r]:
                    return
                if sw is not None and sw.get("current") == r:
                    return              # the swap's restore owns r
                up[r] = True
                ctr["recoveries"].inc()
                trace.instant("recover", t_e, args={"replica": r})
                if r in fail_t:
                    ttr.append(t_e - fail_t.pop(r))
            elif kind == "swapped":
                version[r] = sw["version"]
                up[r] = True
                swapped.add(r)
                ctr["swapped"].inc()
                trace.instant("hot_swap", t_e,
                              args={"replica": r, "version": sw["version"]})
                fail_t.pop(r, None)
                sw["current"] = None
                start_next_swap(t_e)

        while True:
            pull_faults(clock)
            while events and events[0][0] <= clock:
                t_e, _, kind, r = heapq.heappop(events)
                handle_event(kind, r, t_e)
            maybe_start_swap(clock)
            if any(up):
                while pending and pending[0].t_arrival <= clock:
                    req = pending.pop(0)
                    note_dispatch(req, router.dispatch(req, up), clock)
                while retry_q and retry_q[0][0] <= clock:
                    _, _, req = heapq.heappop(retry_q)
                    note_dispatch(req, router.dispatch(req, up), clock)
            if not router.backlog():
                if not pending and not retry_q:
                    break
                # outstanding work, nothing dispatchable: jump the clock to
                # whatever unblocks first (every candidate is > clock)
                cands = []
                if any(up):
                    if pending:
                        cands.append(pending[0].t_arrival)
                    if retry_q:
                        cands.append(retry_q[0][0])
                if events:
                    cands.append(events[0][0])
                if next_fault is not None:
                    cands.append(next_fault.t)
                if not cands:
                    # a dead fleet with no recovery scheduled: fail every
                    # outstanding request explicitly, none stranded
                    for req in pending + [e[2] for e in retry_q]:
                        t_f = max(clock, req.t_arrival)
                        done.append(Completion(
                            rid=req.rid, pred=-1, t_arrival=req.t_arrival,
                            t_done=t_f, replica=-1, status="failed",
                            attempts=attempts.get(req.rid, 0)))
                        ctr["failed"].inc()
                        trace.instant("failed", t_f, cat=CAT_REQUEST,
                                      args={"rid": req.rid,
                                            "dead_fleet": True})
                    pending, retry_q = [], []
                    break
                clock = max(clock, min(cands))
                continue
            # ---- one gang round over the surviving replicas -------------
            if hs is not None:
                hs.rnd = ctr["rounds"].value - ctr0["rounds"]
                t = now_ns()
            round_items = router.drain_round(up)
            if hs is not None:
                hs.span("drain", t, {
                    "n_real": sum(n for _, _, _, n in round_items),
                    "rids": [q.rid for _, take, _, _ in round_items
                             for q in take]})
            up_at_drain = list(up)
            version_at_drain = list(version)
            need = sorted({version_at_drain[r]
                           for r, _, _, n_real in round_items if n_real})
            t_wall = 0.0
            if self.execute:
                if hs is not None:
                    t = now_ns()
                packed = self._pack(round_items)
                if hs is not None:
                    hs.span("pack", t)
                if not set(version_at_drain) <= self._warm:
                    # first launches (and kernel builds) outside the clock
                    self._round_preds(packed, version_at_drain)
                    self._warm.update(version_at_drain)
                # repro: allow[RPA102] the measured clock measures
                t0 = time.perf_counter()
                preds = self._round_preds(packed, version_at_drain)
                # repro: allow[RPA102] the measured clock measures
                t_wall = time.perf_counter() - t0
            else:
                preds = np.full((R, self.batch), -1)
            # a gang round is as slow as its dearest co-scheduled request
            cost_mult = max([1.0] + [req.cost
                                     for _, take, _, _ in round_items
                                     for req in take])
            t_service = (max(self._versions[v]["t_round"] for v in need)
                         * cost_mult
                         if self.clock_mode == "modeled" else t_wall)
            t_end = clock + t_service
            ctr["rounds"].inc()
            if not all(up_at_drain):
                ctr["degraded"].inc()
            # fault/swap events landing inside (clock, t_end] hit the
            # round in flight: a failing replica's take is lost
            serving = {"t0": clock, "lost": set(),
                       "take": {r: take for r, take, _, _ in round_items}}
            pull_faults(t_end)
            while events and events[0][0] <= t_end:
                t_e, _, kind, r = heapq.heappop(events)
                handle_event(kind, r, t_e, serving=serving)
            lost = serving["lost"]
            any_real = any(n_real for _, _, _, n_real in round_items)
            for r, take, _, n_real in round_items:
                if r in lost:
                    continue
                if self.pp_stages > 1:
                    # every up replica's stages compute the padded rows of
                    # a pp/hybrid round, real rows or not
                    if up_at_drain[r] and any_real:
                        busy[r] += t_service
                elif n_real:
                    busy[r] += t_service
                if not take:            # an idle or down replica
                    continue
                v = version_at_drain[r]
                trace.span("round", clock, t_end, track=f"replica {r}",
                           args={"version": v, "n_real": n_real})
                for req, pred in zip(take, preds[r][:n_real]):
                    done.append(Completion(
                        rid=req.rid, pred=int(pred),
                        t_arrival=req.t_arrival, t_done=t_end, replica=r,
                        version=v, attempts=attempts.get(req.rid, 0)))
                    ctr["done"].inc()
                    hist.observe(t_end - req.t_arrival)
                    trace.span("request", clock, t_end,
                               track=f"replica {r}", cat=CAT_REQUEST,
                               args={"rid": req.rid, "version": v,
                                     "attempts": attempts.get(req.rid, 0)})
            clock = t_end

        sw = self._pending_swap
        if sw is not None:
            # the stream ended before the roll finished: flip the remaining
            # versions without extending the makespan
            for r in range(R):
                if r not in swapped:
                    swapped.add(r)
                    ctr["swapped"].inc()
                    trace.instant("hot_swap", clock,
                                  args={"replica": r,
                                        "version": sw["version"]})
            self._adopt_version(sw["version"])
            self._pending_swap = None
        # the report reads this run's deltas from the registry: one set of
        # books for the counters, the snapshot and the report
        if hs is not None:
            hs.rnd = None
            t = now_ns()
        n_of = {k: c.value - ctr0[k] for k, c in ctr.items()}
        metrics.gauge("fleet_replicas_serving",
                      "up replicas at run end").set(sum(up))
        rep = fleet_report(
            done, router.rejected, mode=self.mode, replicas=R,
            pp_stages=self.pp_stages, batch=self.batch,
            clock=self.clock_mode, rounds=n_of["rounds"], busy_s=busy,
            makespan_s=clock,
            bubble_fraction=(self.stage_plan.bubble(self.n_micro)
                             if self.stage_plan else 0.0),
            n_retries=n_of["retries"], n_failures=n_of["failures"],
            n_recoveries=n_of["recoveries"],
            degraded_rounds=n_of["degraded"], time_to_recover_s=ttr,
            n_swapped=n_of["swapped"], slo_s=self.slo,
            device=str(self.device))
        record_report(metrics, rep)
        if hs is not None:
            hs.span("report", t)
        return done, rep
