"""Metric streams for the serving stack: one registry, one truth.

The port's copy of the JAX package's ``obs/metrics.py``. A
:class:`MetricsRegistry` holds the counters, gauges, fixed-bucket latency
histograms and bounded windows the serving loops increment as they run.
There is one source of truth: the continuous scheduler's
:class:`~repro_torch.serve.scheduler.AutoscalePolicy` reads its p95 and
load signals from the registry, and ``FleetReport`` is assembled from the
same counters the snapshot exports, so the report, the autoscaler and the
exported metrics cannot disagree (``obs.validate.reconcile`` checks it).

Exports: ``snapshot()`` is a canonical JSON document; ``to_prometheus()``
is the Prometheus text exposition format (``# HELP`` / ``# TYPE``,
cumulative ``_bucket{le=...}`` + ``_sum`` + ``_count`` for histograms).

Metric names the serving stack uses:

  counters    serve_done_total, serve_failed_total, serve_rejected_total,
              serve_retries_total, serve_steals_total,
              serve_failures_total, serve_recoveries_total,
              serve_swapped_total, serve_degraded_total,
              serve_scale_up_total, serve_scale_down_total,
              serve_rounds_total
  gauges      fleet_load, fleet_p95_window_s, fleet_replicas_serving
  histograms  request_latency_seconds
  windows     request_latency_window (the autoscaler's p95 source)
"""
from __future__ import annotations

import json
import math
from collections import deque
from typing import Dict, List, Optional, Sequence, Tuple

# Exponential latency buckets: 10 us .. ~84 s, factor 2 (the JAX
# package's). One bucket is the stated tolerance when a report percentile
# is read back from a snapshot: "within 2x" catches a wrong percentile and
# survives any workload.
DEFAULT_LATENCY_BUCKETS: Tuple[float, ...] = tuple(
    1e-5 * 2 ** k for k in range(24))


def _nearest_rank_index(n: int, q: float) -> int:
    """rank(q) = ceil(q*n) - 1, as ``serve.report.nearest_rank`` (kept
    here so ``repro_torch.obs`` never imports ``repro_torch.serve``)."""
    return min(max(0, math.ceil(q * n) - 1), n - 1)


class Counter:
    """Monotone event count."""

    def __init__(self, name: str, help: str = ""):
        self.name, self.help = name, help
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    """Last-written value of a continuous signal."""

    def __init__(self, name: str, help: str = ""):
        self.name, self.help = name, help
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Fixed-bucket histogram (upper bounds + overflow).

    ``counts[i]`` is the number of observations in
    ``(buckets[i-1], buckets[i]]``; ``counts[-1]`` the overflow past the
    last bound. ``percentile_bounds(q)`` brackets the nearest-rank
    sample: the exact ``FleetReport`` percentile lies inside (the
    one-bucket reconstruction contract).
    """

    def __init__(self, name: str, help: str = "",
                 buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS):
        self.name, self.help = name, help
        self.buckets = tuple(float(b) for b in buckets)
        self.counts = [0] * (len(self.buckets) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        self.sum += v
        self.count += 1
        for i, b in enumerate(self.buckets):
            if v <= b:
                self.counts[i] += 1
                return
        self.counts[-1] += 1

    def percentile_bounds(self, q: float) -> Tuple[float, float]:
        """(lo, hi] of the bucket holding the nearest-rank q sample."""
        if self.count == 0:
            return (float("nan"), float("nan"))
        rank = _nearest_rank_index(self.count, q)
        cum = 0
        for i, c in enumerate(self.counts):
            cum += c
            if rank < cum:
                lo = self.buckets[i - 1] if i > 0 else 0.0
                hi = (self.buckets[i] if i < len(self.buckets)
                      else float("inf"))
                return (lo, hi)
        return (self.buckets[-1], float("inf"))

    def percentile(self, q: float) -> float:
        """Bucket-upper-bound estimate of the q percentile."""
        return self.percentile_bounds(q)[1]


class WindowSeries:
    """Bounded window of recent observations (a deque, not a stream).

    The autoscaler's p95 signal: ``percentile`` is the same nearest rank
    over the sorted window the report percentiles use.
    """

    def __init__(self, name: str, size: int, help: str = ""):
        self.name, self.help = name, help
        self.size = int(size)
        self.values: deque = deque(maxlen=self.size)

    def observe(self, v: float) -> None:
        self.values.append(float(v))

    def __len__(self) -> int:
        return len(self.values)

    def percentile(self, q: float) -> float:
        if not self.values:
            return 0.0
        vs = sorted(self.values)
        return vs[_nearest_rank_index(len(vs), q)]


class MetricsRegistry:
    """The serving stack's metric namespace.

    ``counter``/``gauge``/``histogram``/``window`` register-or-return
    (idempotent by name), so the serve loop and the report assembly can
    both ask for ``serve_retries_total`` and get the same object.
    """

    def __init__(self):
        self.counters: Dict[str, Counter] = {}
        self.gauges: Dict[str, Gauge] = {}
        self.histograms: Dict[str, Histogram] = {}
        self.windows: Dict[str, WindowSeries] = {}

    def _reserve(self, name: str, kind: str) -> None:
        """One namespace across kinds: a name registered as one kind
        cannot be registered as another (shadowing would split the one
        source of truth)."""
        for k, d in (("counter", self.counters), ("gauge", self.gauges),
                     ("histogram", self.histograms),
                     ("window", self.windows)):
            if k != kind and name in d:
                raise ValueError(
                    f"metric {name!r} already registered as a {k}, "
                    f"cannot re-register as a {kind}")

    def counter(self, name: str, help: str = "") -> Counter:
        if name not in self.counters:
            self._reserve(name, "counter")
            self.counters[name] = Counter(name, help)
        return self.counters[name]

    def gauge(self, name: str, help: str = "") -> Gauge:
        if name not in self.gauges:
            self._reserve(name, "gauge")
            self.gauges[name] = Gauge(name, help)
        return self.gauges[name]

    def histogram(self, name: str, help: str = "",
                  buckets: Sequence[float] = DEFAULT_LATENCY_BUCKETS
                  ) -> Histogram:
        if name not in self.histograms:
            self._reserve(name, "histogram")
            self.histograms[name] = Histogram(name, help, buckets)
        return self.histograms[name]

    def window(self, name: str, size: int = 64,
               help: str = "") -> WindowSeries:
        if name not in self.windows:
            self._reserve(name, "window")
            self.windows[name] = WindowSeries(name, size, help)
        return self.windows[name]

    def value(self, name: str) -> float:
        """Read a counter or gauge by name (0 if never registered)."""
        if name in self.counters:
            return self.counters[name].value
        if name in self.gauges:
            return self.gauges[name].value
        return 0

    # -- export ------------------------------------------------------------

    def snapshot(self) -> dict:
        """The registry as one canonical JSON document."""
        return {
            "format": 1,
            "counters": {n: c.value
                         for n, c in sorted(self.counters.items())},
            "gauges": {n: g.value for n, g in sorted(self.gauges.items())},
            "histograms": {
                n: {"buckets": list(h.buckets), "counts": list(h.counts),
                    "sum": h.sum, "count": h.count}
                for n, h in sorted(self.histograms.items())},
            "windows": {
                n: {"size": w.size, "values": list(w.values)}
                for n, w in sorted(self.windows.items())},
        }

    def to_json(self) -> str:
        return json.dumps(self.snapshot(), sort_keys=True, indent=1) + "\n"

    def to_prometheus(self) -> str:
        """Prometheus text exposition (0.0.4): HELP/TYPE lines, counters
        and gauges verbatim, histograms as cumulative le-buckets."""
        out: List[str] = []
        for n, c in sorted(self.counters.items()):
            if c.help:
                out.append(f"# HELP {n} {c.help}")
            out.append(f"# TYPE {n} counter")
            out.append(f"{n} {c.value}")
        for n, g in sorted(self.gauges.items()):
            if g.help:
                out.append(f"# HELP {n} {g.help}")
            out.append(f"# TYPE {n} gauge")
            out.append(f"{n} {g.value}")
        for n, h in sorted(self.histograms.items()):
            if h.help:
                out.append(f"# HELP {n} {h.help}")
            out.append(f"# TYPE {n} histogram")
            cum = 0
            for b, c in zip(h.buckets, h.counts):
                cum += c
                out.append(f'{n}_bucket{{le="{b!r}"}} {cum}')
            out.append(f'{n}_bucket{{le="+Inf"}} {h.count}')
            out.append(f"{n}_sum {h.sum}")
            out.append(f"{n}_count {h.count}")
        return "\n".join(out) + "\n"

    def save(self, path: str) -> str:
        """Write the snapshot — Prometheus text for ``.prom`` paths,
        canonical JSON otherwise."""
        text = (self.to_prometheus() if str(path).endswith(".prom")
                else self.to_json())
        with open(path, "w") as f:
            f.write(text)
        return path


def record_report(metrics: MetricsRegistry, report) -> None:
    """Copy a ``FleetReport``'s derived summary numbers into the registry
    as gauges, so a metrics snapshot is self-contained (throughput and
    percentiles next to the counters they reconcile with)."""
    g = metrics.gauge
    g("fleet_throughput_img_s",
      "aggregate served throughput").set(report.throughput)
    g("fleet_p50_ms", "report p50 latency").set(report.p50_ms)
    g("fleet_p95_ms", "report p95 latency").set(report.p95_ms)
    g("fleet_makespan_s", "run length (modelled or wall)").set(report.makespan_s)
    g("fleet_replicas_final",
      "active replicas at run end").set(report.replicas_final)
    g("fleet_slo_violations",
      "ok completions over the SLO").set(report.slo_violations)
