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
``clock="measured"`` spans carry wall times and two runs differ.

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
"""
from __future__ import annotations

import json
from typing import Dict, List, Optional

# Event categories (the "cat" field): filterable lanes in Perfetto.
CAT_REQUEST = "request"        # per-request lifecycle events
CAT_ROUND = "round"            # gang-round execution spans
CAT_FLEET = "fleet"            # fleet mutations (faults, swaps, scaling)
CAT_COMPILE = "compile"        # compile-phase spans (DSE sweep, measure)

FLEET_TRACK = "fleet"          # the non-replica instant track
COMPILE_TRACK = "compile"      # the compile-phase span track


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
        validator reconciles against ``FleetReport``."""
        return sum(1 for e in self._events if e["name"] == name)

    def __len__(self) -> int:
        return len(self._events)

    # -- export ------------------------------------------------------------

    def to_chrome(self) -> dict:
        """The trace as a Chrome trace-event document (Perfetto-loadable).

        Events are ordered by ``(ts, tid, seq)``: per-track timestamps
        are monotone non-decreasing in file order, which the validator
        asserts. Metadata events name the process and every track.
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
