"""Event tracing for the serving stack: Chrome trace-event JSON.

The port's copy of the JAX package's ``obs/trace.py``. The serving loops
(the gang rounds of :mod:`repro_torch.serve.engine` and the continuous
slots of :mod:`repro_torch.serve.scheduler`) feed a
:class:`TraceRecorder` with typed spans and instants: each request's
lifecycle (enqueue, admit, execute, retire, steal, retry, failed), one
track a replica, and a ``fleet`` track for replica fail/recover, hot-swap
rolls and autoscale decisions. The export is the Chrome trace-event
format (``{"traceEvents": [...]}``), which Perfetto and
``chrome://tracing`` load: one process ("repro_torch.serve"), one thread
track a replica plus the fleet track.

Determinism is a contract: on the modelled clock every timestamp comes
from the cost model, track ids and sequence numbers follow emission
order, and ``to_json`` is canonical (sorted keys, events ordered by
``(ts, tid, seq)``), so two identical runs give byte-identical files,
also with ``execute=True`` on the card (the kernels' wall time never
reaches the modelled clock). Recording never touches the clock. Under
``clock="measured"`` the serving process's spans carry the engine's
measured clock: the sum of the round walls from the call's start (0 at
each call), so two runs differ, and these spans line up with no other
clock. The host spans below do.

Span/instant taxonomy (the names are the reconciliation contract:
:mod:`repro_torch.obs.validate` counts them against ``FleetReport``):

  ============  =====  ========  =======================================
  name          ph     track     meaning
  ============  =====  ========  =======================================
  request       X      replica   one served request: admit -> retire
  round         X      replica   one gang round on one replica
  enqueue       i      replica   router accepted a request into a queue
  reject        i      fleet     admission control rejected a request
  retry         i      fleet     a lost request re-dispatched (budget)
  failed        i      fleet     retry budget exhausted -> failed
  steal         i      replica   thief replica stole a queued request
  fail          i      fleet     a replica failure landed
  recover       i      fleet     a failed replica restored into dispatch
  hot_swap      i      fleet     a replica rolled onto a new artifact
  scale_up      i      fleet     autoscaler spun a replica up
  scale_down    i      fleet     autoscaler drained a replica out
  sweep         X      compile   one compile's plan resolve (lookups)
  measure       X      compile   one plan's measurement on the card
  ============  =====  ========  =======================================

The ``compile`` track carries the compile phase: ``compile_cnn(...,
trace=...)`` emits a ``sweep`` span over its plan resolve and, with
``measure=True``, one ``measure`` span a profiled plan (host wall time
around the plan's CUDA-event measurement).

Host spans. The gang loop on the measured clock also times its own host
work on the epoch clock (:func:`now_ns`, ``time.time_ns()``), the clock
of ``torch.profiler``'s events, so they line up with a device trace. A
span is a tuple ``(name, t0_ns, t1_ns, call, round, args)``: ``call`` a
process-wide id of the ``serve`` call, ``round`` the round's index in it
(None for ``serve`` and ``report``). They are logged when the caller
passed a recorder or a torch profile is running (:func:`host_call`),
into a bounded process-wide log (:func:`host_spans`, oldest dropped and
counted by :func:`host_spans_dropped`) and into the given recorder,
whose export carries them as a second process ("repro_torch.host", one
``serve loop`` track, ``ts`` in epoch microseconds). Not counted by
:meth:`TraceRecorder.count` nor reconciled:

  ============  ==========================================================
  name          what the host was doing
  ============  ==========================================================
  serve         the whole ``ServeEngine.serve`` call (args ``n``, ``rounds``)
  drain         ``Router.drain_round`` (args ``n_real``, ``rids``)
  pack          ``ServeEngine._pack``: the round's super-batch
  h2d           the super-batch's copy to the device
  enqueue       launching the fold and the argmax, up to the copy back
  sync          the copy back, which waits for the device
  report        ``fleet_report`` and ``record_report``
  ============  ==========================================================

A version's first round runs twice, once outside the measured clock to
warm it, and then has two ``h2d``, ``enqueue`` and ``sync`` spans.
"""
from __future__ import annotations

import itertools
import json
import time
from collections import deque
from typing import Dict, List, Optional

import torch

# Event categories (the "cat" field): filterable lanes in Perfetto.
CAT_REQUEST = "request"        # per-request lifecycle events
CAT_ROUND = "round"            # gang-round execution spans
CAT_FLEET = "fleet"            # fleet mutations (faults, swaps, scaling)
CAT_COMPILE = "compile"        # compile-phase spans (DSE sweep, measure)

FLEET_TRACK = "fleet"          # the non-replica instant track
COMPILE_TRACK = "compile"      # the compile-phase span track

CAT_HOST = "host"              # host spans of the serving loop
HOST_PROCESS = "repro_torch.host"
HOST_PID = 2
HOST_TRACK = "serve loop"
HOST_SPANS_MAX = 1 << 18       # the process-wide log's bound, in spans


class TraceRecorder:
    """Collects typed spans/instants; exports Chrome trace-event JSON.

    All times are in (modelled or wall) seconds; the export converts to
    the format's microseconds. Tracks are named lanes (``"fleet"``,
    ``"replica 0"``, ...) assigned thread ids in first-registration
    order: register tracks up front (the serve loops do) so ids do
    not depend on event order.
    """

    PID = 1

    def __init__(self, process_name: str = "repro_torch.serve"):
        self.process_name = process_name
        self._events: List[dict] = []
        self._tracks: Dict[str, int] = {}
        self._meta: Dict[str, object] = {}
        self._seq = 0
        self._host: List[tuple] = []    # host spans of the serves it saw

    # -- tracks ------------------------------------------------------------

    def track(self, name: str) -> int:
        """Thread id for a named track (registering it on first use)."""
        if name not in self._tracks:
            self._tracks[name] = len(self._tracks)
        return self._tracks[name]

    # -- emission ----------------------------------------------------------

    def _emit(self, ev: dict) -> None:
        ev["pid"] = self.PID
        ev["seq"] = self._seq
        self._seq += 1
        self._events.append(ev)

    def span(self, name: str, t0: float, t1: float, *,
             track: str, cat: str = CAT_ROUND,
             args: Optional[dict] = None) -> None:
        """A complete event (``ph: "X"``) on ``track``: [t0, t1] seconds."""
        ev = {"name": name, "cat": cat, "ph": "X",
              "ts": t0 * 1e6, "dur": (t1 - t0) * 1e6,
              "tid": self.track(track)}
        if args:
            ev["args"] = dict(args)
        self._emit(ev)

    def instant(self, name: str, t: float, *,
                track: str = FLEET_TRACK, cat: str = CAT_FLEET,
                args: Optional[dict] = None) -> None:
        """A thread-scoped instant event (``ph: "i"``) at ``t`` seconds."""
        ev = {"name": name, "cat": cat, "ph": "i", "s": "t",
              "ts": t * 1e6, "tid": self.track(track)}
        if args:
            ev["args"] = dict(args)
        self._emit(ev)

    def set_meta(self, key: str, value) -> None:
        """Attach run-level metadata (exported under ``otherData``), e.g.
        the compiled plan provenance and roofline breakdown, so the trace
        records which plans its spans executed."""
        self._meta[key] = value

    # -- counts (reconciliation helpers) -----------------------------------

    def count(self, name: str) -> int:
        """How many events named ``name`` were recorded: the counts the
        validator reconciles against ``FleetReport`` (host spans aside)."""
        return sum(1 for e in self._events if e["name"] == name)

    def __len__(self) -> int:
        return len(self._events)

    # -- export ------------------------------------------------------------

    def to_chrome(self) -> dict:
        """The trace as a Chrome trace-event document (Perfetto-loadable).

        Events are ordered by ``(ts, tid, seq)``: per-track timestamps
        are monotone non-decreasing in file order, which the validator
        asserts. Metadata events name the process and every track. Host
        spans, where the recorder saw any, follow as the second process.
        """
        meta_events = [{"name": "process_name", "ph": "M", "pid": self.PID,
                       "tid": 0, "args": {"name": self.process_name}}]
        for name, tid in sorted(self._tracks.items(), key=lambda kv: kv[1]):
            meta_events.append({"name": "thread_name", "ph": "M",
                                "pid": self.PID, "tid": tid,
                                "args": {"name": name}})
        body = sorted(self._events,
                      key=lambda e: (e["ts"], e["tid"], e["seq"]))
        events = meta_events + [{k: v for k, v in e.items() if k != "seq"}
                                for e in body]
        if self._host:
            events += _host_events(self._host)
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": dict(self._meta)}

    def to_json(self) -> str:
        """Canonical JSON (sorted keys): byte-identical across identical
        runs on the modelled clock, the determinism contract."""
        return json.dumps(self.to_chrome(), sort_keys=True, indent=1) + "\n"

    def save(self, path: str) -> str:
        with open(path, "w") as f:
            f.write(self.to_json())
        return path


class NullRecorder:
    """A recorder that keeps nothing: what the serving loops record into
    when the caller passed none (their report reads the metrics registry,
    never the trace)."""

    def track(self, name: str) -> int:
        return 0

    def span(self, *args, **kwargs) -> None:
        pass

    def instant(self, *args, **kwargs) -> None:
        pass

    def set_meta(self, key: str, value) -> None:
        pass


NULL_RECORDER = NullRecorder()


# -- host spans on the epoch clock ----------------------------------------

_host_log: deque = deque(maxlen=HOST_SPANS_MAX)
_host_dropped = 0
_call_ids = itertools.count()


def now_ns() -> int:
    """The host spans' clock: epoch nanoseconds, ``torch.profiler``'s."""
    # repro: allow[RPA102] host spans sit on the profiler's epoch clock
    return time.time_ns()


class HostCall:
    """One ``serve`` call's host spans. The loop sets ``rnd`` to the round
    it is in; :meth:`span` closes a span begun at ``t0`` (a
    :func:`now_ns` reading) now, in that round, and returns its end."""

    __slots__ = ("call", "rnd", "t0", "_sink")

    def __init__(self, recorder: Optional[TraceRecorder] = None):
        self.call = next(_call_ids)
        self.rnd: Optional[int] = None
        self._sink = recorder._host if recorder is not None else None
        self.t0 = now_ns()

    def span(self, name: str, t0: int, args: Optional[dict] = None) -> int:
        global _host_dropped
        t1 = now_ns()
        sp = (name, t0, t1, self.call, self.rnd, args)
        if len(_host_log) == _host_log.maxlen:
            _host_dropped += 1
        _host_log.append(sp)
        if self._sink is not None:
            self._sink.append(sp)
        return t1


def host_call(recorder: Optional[TraceRecorder] = None
              ) -> Optional[HostCall]:
    """The host spans of a ``serve`` call that starts now, or None when
    nothing would read them: no recorder given and no torch profile
    running (the check ``record_function`` makes)."""
    if recorder is None and not torch._C._autograd._profiler_enabled():
        return None
    return HostCall(recorder)


def host_spans(t0_ns: Optional[int] = None,
               t1_ns: Optional[int] = None) -> List[tuple]:
    """The logged host spans that lie wholly inside ``[t0_ns, t1_ns]``
    (either end open when None), in the order they closed."""
    lo = -1 if t0_ns is None else t0_ns
    hi = float("inf") if t1_ns is None else t1_ns
    return [s for s in _host_log if lo <= s[1] and s[2] <= hi]


def host_spans_dropped() -> int:
    """How many of the oldest spans the log's bound has dropped."""
    return _host_dropped


def _host_events(spans: List[tuple]) -> List[dict]:
    """Host spans as the Chrome document's second process: parents before
    the children they start with, ``ts`` in epoch microseconds."""
    out = [{"name": "process_name", "ph": "M", "pid": HOST_PID, "tid": 0,
            "args": {"name": HOST_PROCESS}},
           {"name": "thread_name", "ph": "M", "pid": HOST_PID, "tid": 0,
            "args": {"name": HOST_TRACK}}]
    for name, t0, t1, call, rnd, args in sorted(
            spans, key=lambda s: (s[1], -s[2])):
        a = {"call": call} if rnd is None else {"call": call, "round": rnd}
        out.append({"name": name, "cat": CAT_HOST, "ph": "X",
                    "ts": t0 / 1e3, "dur": (t1 - t0) / 1e3,
                    "pid": HOST_PID, "tid": 0, "args": {**a, **(args or {})}})
    return out
