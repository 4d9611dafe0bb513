"""The device trace of a traced run (``--trace 1``): ``torch.profiler``
over the measured window, CUDA activity only (the kernels, copies and
fills on the card, and the host's CUDA runtime calls), so that tracing
costs the host little. Read from the profiler's raw events.

:class:`Trace` gives the device's busy time (the union of every device
operation's interval), the time by operation name, and the longest idle
gaps, each named by what the host was doing: the CUDA call in progress,
else the benchmark's own phase at that instant (the harness logs its
phases on the same epoch clock the profiler's timestamps use).
"""
from __future__ import annotations

import bisect
import time
from collections import defaultdict
from typing import Dict, List, Tuple

import torch


class PhaseLog:
    """The harness's phases on the epoch clock: ``mark(name)`` starts one."""

    def __init__(self):
        self.marks: List[Tuple[int, str]] = []

    def mark(self, name: str) -> None:
        self.marks.append((time.time_ns(), name))

    def at(self, t_ns: int) -> str:
        i = bisect.bisect_right(self.marks, (t_ns, "￿")) - 1
        return self.marks[i][1] if i >= 0 else "set-up"


def profiler():
    from torch.profiler import ProfilerActivity, profile
    return profile(activities=[ProfilerActivity.CUDA])


def warm_profiler(device) -> None:
    """One short profile at set-up, so that the window's does not pay the
    tracer's first start."""
    with profiler():
        torch.zeros(1, device=device).add_(1)
        torch.cuda.synchronize(device)


def _events(prof):
    try:
        return prof.profiler.kineto_results.events()
    except AttributeError:
        return prof.events()


class Trace:
    """Device and host events of one profile, cut to ``[t0_ns, t1_ns]``."""

    def __init__(self, prof, t0_ns: int, t1_ns: int, phases: PhaseLog):
        dev, host = [], []
        for e in _events(prof):
            s = e.start_ns()
            d = e.duration_ns()
            if e.device_type() == torch.autograd.DeviceType.CUDA:
                dev.append((s, s + d, e.name()))
            else:
                host.append((s, s + d, e.name()))
        self.device = sorted(dev)
        self.host = sorted(host)
        self.t0, self.t1 = t0_ns, t1_ns
        self.phases = phases

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def busy(self) -> List[Tuple[int, int]]:
        """The union of the device operations' intervals inside the
        window, merged."""
        out: List[List[int]] = []
        for s, e, _ in self.device:
            s, e = max(s, self.t0), min(e, self.t1)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [tuple(x) for x in out]

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy()) / 1e9

    def by_name(self) -> Dict[str, Tuple[int, float]]:
        """Device operation name -> (count, seconds)."""
        out: Dict[str, List] = defaultdict(lambda: [0, 0.0])
        for s, e, n in self.device:
            out[n][0] += 1
            out[n][1] += (e - s) / 1e9
        return {k: (c, t) for k, (c, t) in out.items()}

    def by_class(self) -> Dict[str, float]:
        """Device seconds by the port's kernel class: ``conv_pipe``,
        ``matmul_pipe``, ``lrn_pwl`` or ``other`` (every other operation)."""
        from cnnbench.program import kernel_class
        out: Dict[str, float] = defaultdict(float)
        for name, (_, t) in self.by_name().items():
            out[kernel_class(name)] += t
        return dict(out)

    def _host_doing(self, t: int) -> str:
        i = bisect.bisect_right(self.host, (t, 2 ** 63, "")) - 1
        while i >= 0 and t - self.host[i][0] < 10 ** 9:
            s, e, n = self.host[i]     # the latest call started by t
            if e > t:
                return n
            i -= 1
        return f"{self.phases.at(t)} (no CUDA call)"

    def gaps(self, k: int = 10) -> List[Tuple[str, float]]:
        """The ``k`` longest idle stretches of the device in the window, the
        window's edges included, each named by what the host was doing at
        its middle."""
        edges, prev = [], self.t0
        for s, e in self.busy():
            edges.append((prev, s))
            prev = e
        edges.append((prev, self.t1))
        top = sorted((g for g in edges if g[1] > g[0]),
                     key=lambda g: g[0] - g[1])[:k]
        return [(self._host_doing((s + e) // 2), (e - s) / 1e9)
                for s, e in top]

    def breakdown(self, k: int = 10) -> dict:
        """The ``k`` device operations that took most time (by
        :func:`short_name`) and the ``k`` longest idle gaps."""
        ops: Dict[str, float] = defaultdict(float)
        for name, (_, t) in self.by_name().items():
            ops[short_name(name)] += t
        top = sorted(ops.items(), key=lambda kv: -kv[1])[:k]
        return {"device_ops": [[n, t] for n, t in top],
                "idle_gaps": [[n, t] for n, t in self.gaps(k)]}


def short_name(name: str, limit: int = 160) -> str:
    """A kernel's name without its return type, anonymous namespace and
    argument list."""
    name = name.replace("void ", "", 1).replace("(anonymous namespace)::", "")
    depth = 0
    for i, ch in enumerate(name):
        depth += ch == "<"
        depth -= ch == ">"
        if ch == "(" and depth == 0 and i > 0 and name[i - 1] != " ":
            name = name[:i]
            break
    return name[:limit]


def roofline(ctx: dict, cls: str, kind: str):
    """Kernel class ``cls``'s share of its roofline over a traced window, in
    %: the bound of its ``kind`` groups (``conv`` or ``fc``;
    :func:`cnnbench.counts.group_counts`) times the window's forwards, over
    the device time the trace gives the class. None without a trace or
    without such kernels in it."""
    tr = ctx.get("trace")
    if tr is None or "forwards" not in ctx:
        return None
    t = tr.by_class().get(cls, 0.0)
    if t <= 0:
        return None
    bound = sum(g["bound_s"] for g in ctx["groups"] if g["kind"] == kind)
    return 100.0 * bound * ctx["forwards"] / t
