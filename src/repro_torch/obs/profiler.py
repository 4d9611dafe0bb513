"""Measured refinement of modelled plans, on the card.

The DSE (:mod:`repro_torch.kernels.autotune`) ranks plans by the cost
model alone; this module times them. It is the measurement half of the
JAX package's ``obs/profiler.py``: a deterministic warmup / iters /
trimmed-mean harness over ``autotune.measure_plan`` /
``measure_gemm_plan`` (CUDA events around back-to-back launches, never
the host clock), each number stamped with the card it was taken on, and
written into the plan table (format 3) beside the plan's modelled time.

* :func:`refine_plan`: one layer; shortlist the ``top_k`` best modelled
  plans and measure only those (the model proposes, the stopwatch
  disposes).
* :func:`profile_table`: measure every plan a compile resolved;
  ``compile_cnn(measure=True)`` calls it.

Measurements are memoised per ``(kind, shape, plan, device, harness)``,
so a warm recompile re-times nothing (hits are counted in
``autotune.measure_stats``). A compile seeded from a measured table never
reaches this module: it inherits the seed's measurements verbatim. The
JAX harness's ``interpret`` flag has no meaning here (every measurement
runs the compiled CUDA kernel), so it is not part of the options or the
records; the device is in the fingerprint.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

__all__ = [
    "MeasureOptions",
    "backend_fingerprint",
    "clear_measure_cache",
    "measure_record",
    "profile_table",
    "refine_plan",
    "shortlist",
    "trimmed_mean",
]


@dataclass(frozen=True)
class MeasureOptions:
    """The measurement protocol, as data: ``repeats`` samples, each
    ``warmup`` untimed launches then ``iters`` launches between one pair
    of CUDA events; the ``trim`` fastest and slowest samples are dropped
    and the rest meaned. ``top_k`` is :func:`refine_plan`'s shortlist."""
    warmup: int = 1
    iters: int = 3
    repeats: int = 5
    trim: int = 1
    top_k: int = 2

    def harness(self) -> dict:
        """The JSON view stored with each measurement."""
        return {"warmup": self.warmup, "iters": self.iters,
                "repeats": self.repeats, "trim": self.trim}


def backend_fingerprint(device=None) -> dict:
    """Where a measurement was taken: the card's name, compute capability
    and SM count, the torch and CUDA versions, and the timer. Stored in
    ``provenance["measurement"]["backend"]``: a time means something only
    beside the card it was taken on."""
    import torch
    dev = torch.device(device if device is not None else "cuda")
    props = torch.cuda.get_device_properties(dev)
    return {"platform": "cuda",
            "device": props.name,
            "capability": f"{props.major}.{props.minor}",
            "sms": props.multi_processor_count,
            "torch": torch.__version__,
            "cuda": torch.version.cuda,
            "timer": "cuda events"}


def trimmed_mean(samples: List[float], trim: int) -> float:
    """Mean after dropping the ``trim`` smallest and largest samples
    (kept whole when there are not enough samples to trim)."""
    vs = sorted(samples)
    if trim > 0 and len(vs) > 2 * trim:
        vs = vs[trim:-trim]
    return sum(vs) / len(vs)


# (kind, shape, plan, device, warmup, iters, repeats, trim) -> record
_CACHE: Dict[tuple, dict] = {}


def clear_measure_cache() -> None:
    _CACHE.clear()


def measure_record(kind: str, shape, plan, *,
                   opts: Optional[MeasureOptions] = None,
                   device=None) -> dict:
    """One plan's measured record: the trimmed-mean seconds a call on the
    card, ``t_model_call`` (the modelled time in the same per-call unit:
    a ``ConvPlan``'s per-image ``t_model`` times the batch) and the
    harness. ``kind`` is ``"conv"`` or ``"gemm"``."""
    import torch
    from repro_torch.kernels import autotune

    opts = opts or MeasureOptions()
    dev = str(torch.device(device if device is not None else "cuda"))
    key = (kind, shape, plan, dev, opts.warmup, opts.iters, opts.repeats,
           opts.trim)
    hit = _CACHE.get(key)
    if hit is not None:
        autotune.count_measure_hit(kind)
        return hit
    fn = (autotune.measure_plan if kind == "conv"
          else autotune.measure_gemm_plan)
    samples = [fn(shape, plan, iters=opts.iters, warmup=opts.warmup,
                  device=dev)
               for _ in range(max(1, opts.repeats))]
    record = {"t_measured": trimmed_mean(samples, opts.trim),
              "t_model_call": plan.t_model * (shape.b if kind == "conv"
                                              else 1),
              **opts.harness()}
    _CACHE[key] = record
    return record


def shortlist(shape, k: int, *, vmem_budget: Optional[int] = None,
              backend: Optional[str] = None) -> list:
    """The ``k`` best MODELLED plans of a layer: the hypotheses the
    stopwatch is spent on. Ties break toward larger tiles."""
    from repro_torch.kernels import autotune

    budget = autotune.DEFAULT_BUDGET if vmem_budget is None else vmem_budget
    if isinstance(shape, autotune.GemmShape):
        plans = autotune.enumerate_gemm_plans(shape, budget, backend=backend)
        vol = lambda p: p.tnf * p.ranks                  # noqa: E731
    else:
        plans = autotune.enumerate_plans(shape, budget, backend=backend)
        vol = lambda p: p.tp * p.tn                      # noqa: E731
    plans.sort(key=lambda p: (p.t_model, -vol(p)))
    return plans[:max(1, k)]


def refine_plan(shape, *, top_k: Optional[int] = None,
                vmem_budget: Optional[int] = None,
                opts: Optional[MeasureOptions] = None,
                backend: Optional[str] = None, device=None
                ) -> Tuple[object, List[dict]]:
    """Measure the ``top_k`` best modelled plans of one layer; returns
    ``(the fastest measured plan, records)``, one record a candidate in
    modelled rank order, with its plan, its measurement and whether it
    was the model's pick (``records[0]["model_pick"]``)."""
    from repro_torch.kernels import autotune

    opts = opts or MeasureOptions()
    k = opts.top_k if top_k is None else top_k
    kind = "gemm" if isinstance(shape, autotune.GemmShape) else "conv"
    cands = shortlist(shape, k, vmem_budget=vmem_budget, backend=backend)
    records = []
    for rank, plan in enumerate(cands):
        rec = measure_record(kind, shape, plan, opts=opts, device=device)
        records.append({"rank_model": rank, "plan": plan.to_dict(),
                        "model_pick": rank == 0, **rec})
    best = min(range(len(cands)), key=lambda i: records[i]["t_measured"])
    return cands[best], records


def profile_table(table, *, opts: Optional[MeasureOptions] = None,
                  device=None, trace=None, t0: Optional[float] = None):
    """Measure every port plan row of ``table`` on the card: the format-3
    table with each row's ``measured`` record and
    ``provenance["measurement"]`` (the backend fingerprint, the harness,
    and the measure-stat delta this pass ran). Rows of another backend
    (a JAX table's) are carried unmeasured. With ``trace``, one
    ``measure`` span a measured plan lands on the ``compile`` track, host
    wall time relative to ``t0`` (default: now)."""
    import time

    from repro_torch.kernels import autotune
    from repro_torch.obs.trace import CAT_COMPILE, COMPILE_TRACK
    from repro_torch.pipeline.plan_table import plan_key

    opts = opts or MeasureOptions()
    before = autotune.measure_stats()
    origin = time.perf_counter() if t0 is None else t0
    measured: Dict[str, dict] = {}
    for kind, rows, mk_shape, mk_plan in (
            ("conv", table.conv, autotune.ConvShape, autotune.ConvPlan),
            ("gemm", table.gemm, autotune.GemmShape, autotune.GemmPlan)):
        for row in rows:
            if not autotune.is_port_backend(row["backend"]):
                continue
            ts = time.perf_counter() - origin
            rec = measure_record(kind, mk_shape(**row["shape"]),
                                 mk_plan(**row["plan"]), opts=opts,
                                 device=device)
            if trace is not None:
                trace.span("measure", ts, time.perf_counter() - origin,
                           track=COMPILE_TRACK, cat=CAT_COMPILE,
                           args={"kind": kind, "plan": row["plan"],
                                 "t_measured": rec["t_measured"],
                                 "t_model_call": rec["t_model_call"]})
            measured[plan_key(row)] = rec
    after = autotune.measure_stats()
    provenance = dict(table.provenance)
    provenance["measurement"] = {
        "backend": backend_fingerprint(device),
        "harness": opts.harness(),
        "measure_stats": {k: after[k] - before[k] for k in sorted(after)},
    }
    return table.with_measurements(measured, provenance=provenance)
