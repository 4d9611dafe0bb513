"""The program's host spans over a traced window, for the metrics that
read them.

The port's gang serving loop times its own host work on the epoch clock
that ``torch.profiler``'s events and :class:`cnnbench.devtrace.PhaseLog`
share, whenever a torch profile runs, as it does over a traced window
(``repro_torch.obs.trace``): per ``serve`` call a ``serve`` span, per round
``drain``, ``pack``, ``h2d``, ``enqueue`` and ``sync``, then ``report``. A
span is ``(name, t0_ns, t1_ns, call, round, args)``. A program without
these spans gives None here, and each metric that reads them reads
nothing.

The first read of a window prints one line to standard error: the spans
in the window, those the log's bound dropped, and how their clock agrees
with the harness's (:func:`clock_checks`).
"""
from __future__ import annotations

import bisect
import sys
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

ROUND = ("h2d", "enqueue", "sync")      # the engine's measured round


def window(ctx: dict) -> Optional[List[tuple]]:
    """The host spans wholly inside the traced window, or None without a
    trace or without spans in it."""
    tr = ctx.get("trace")
    if tr is None:
        return None
    if "host_spans" not in ctx:
        try:
            from repro_torch.obs.trace import host_spans, host_spans_dropped
        except ImportError:
            ctx["host_spans"] = None
            return None
        ctx["host_spans"] = host_spans(tr.t0, tr.t1) or None
        if ctx["host_spans"] is not None:
            rounds = ctx.get("rounds")
            round_ms = ctx["round_s"] / rounds * 1e3 if rounds else None
            c = clock_checks(tr, ctx["host_spans"], round_ms)
            print(f"host spans: {len(ctx['host_spans'])} in the window, "
                  f"{host_spans_dropped()} dropped; " + ", ".join(
                      f"{k} {v!r}" for k, v in c.items()), file=sys.stderr)
    return ctx["host_spans"]


def dur(spans: List[tuple], names) -> float:
    """Seconds in the spans named ``names``."""
    return sum(s[2] - s[1] for s in spans if s[0] in names) / 1e9


def n_rounds(spans: List[tuple]) -> int:
    """Rounds in the spans: one ``drain`` a round."""
    return len({(s[3], s[4]) for s in spans if s[0] == "drain"})


def per_round_ms(ctx: dict, names) -> Optional[float]:
    """Mean ms a round in the spans named ``names``."""
    spans = window(ctx)
    n = n_rounds(spans) if spans else 0
    return dur(spans, names) / n * 1e3 if n else None


def loop_ms(spans: List[tuple]) -> Optional[float]:
    """Mean self time of a ``serve`` span, in ms: its duration less what
    its children (the spans of its call) cover of it."""
    kids: Dict[int, int] = defaultdict(int)
    calls = {}
    for name, t0, t1, call, _, _ in spans:
        if name == "serve":
            calls[call] = (t0, t1)
    for name, t0, t1, call, _, _ in spans:
        if name != "serve" and call in calls:
            a, b = calls[call]
            kids[call] += max(0, min(t1, b) - max(t0, a))
    if not calls:
        return None
    return sum(b - a - kids[c] for c, (a, b) in calls.items()) \
        / len(calls) / 1e6


def idle_inside(spans: List[Tuple[int, int]],
                busy: List[Tuple[int, int]]) -> int:
    """Nanoseconds of the sorted, disjoint intervals ``spans`` in which no
    interval of the sorted, merged ``busy`` runs."""
    idle, j = 0, 0
    for a, b in spans:
        while j < len(busy) and busy[j][1] <= a:
            j += 1
        cur, k = a, j
        while k < len(busy) and busy[k][0] < b:
            s, e = max(busy[k][0], a), min(busy[k][1], b)
            idle += max(0, s - cur)
            cur = max(cur, e)
            k += 1
        idle += max(0, b - cur)
    return idle


def serve_intervals(spans: List[tuple]) -> List[Tuple[int, int]]:
    return sorted((s[1], s[2]) for s in spans if s[0] == "serve")


def share_inside(events: List[Tuple[int, int]], spans: List[tuple],
                 names) -> float:
    """The share of ``events`` that lie wholly inside a span named
    ``names`` (such spans never overlap)."""
    ivs = sorted((s[1], s[2]) for s in spans if s[0] in names)
    starts = [a for a, _ in ivs]
    inside = 0
    for s, e in events:
        i = bisect.bisect_right(starts, s) - 1
        inside += i >= 0 and e <= ivs[i][1]
    return inside / len(events)


def clock_checks(tr, spans: List[tuple],
                 round_ms: Optional[float]) -> Dict[str, float]:
    """How the spans' clock agrees with the harness's, over a traced
    window: ``serve_over_phases``, the ``serve`` spans' time over the
    harness's ``CompiledCNN.serve`` phases'; ``memcpy_inside``, the share
    of the window's ``cudaMemcpy*`` runtime calls that lie inside an
    ``h2d`` or ``sync`` span, and ``memcpy_in_round``, inside an ``h2d``,
    ``enqueue`` or ``sync`` span; ``round_over_round_ms``, ``h2d`` +
    ``enqueue`` + ``sync`` a round over the engine's ``round_ms.serve``."""
    marks = [m for m in tr.phases.marks if tr.t0 <= m[0] <= tr.t1]
    ends = [m[0] for m in marks[1:]] + [tr.t1]
    phase_ns = sum(e - t for (t, name), e in zip(marks, ends)
                   if name == "CompiledCNN.serve")
    out = {}
    if phase_ns:
        out["serve_over_phases"] = sum(
            b - a for a, b in serve_intervals(spans)) / phase_ns
    memcpy = [(s, e) for s, e, n in tr.host
              if n.startswith("cudaMemcpy") and tr.t0 <= s and e <= tr.t1]
    if memcpy:
        out["memcpy_inside"] = share_inside(memcpy, spans, ("h2d", "sync"))
        out["memcpy_in_round"] = share_inside(memcpy, spans, ROUND)
    n = n_rounds(spans)
    if round_ms and n:
        out["round_over_round_ms"] = dur(spans, ROUND) / n * 1e3 / round_ms
    return out
