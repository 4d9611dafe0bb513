"""Per-layer design-space exploration for the port's CUDA kernels.

The paper tunes its throughput parameters (VEC_SIZE, CU_NUM) with an
offline sweep against the FPGA's DSP budget (Fig. 7); the JAX package
sweeps its Pallas tilings against VMEM. Here the knobs are the ones the
CUDA kernels really take:

* a conv(+pool) launch: the tile, ``tp`` positions x ``tn`` channels
  (``conv_pipe.POSITIONS`` x ``conv_pipe.CHANNELS``, the instantiations in
  ``csrc/conv_pipe.cu``), and with a pool the ``tph`` x ``tpw`` pooled
  outputs a block (:func:`~repro_torch.kernels.conv_pipe.pool_tile`);
* an FC launch: the split, ``tnf`` features a cluster
  (``matmul_pipe.FC_FEATURES``) x ``ranks`` blocks a cluster, 1 to 8.

"Fits" means the instantiation's shared memory is within the budget a
block (``Tiling.vmem_budget``, the row field keeps the JAX name), a pool's
patch fits the tile's rows, and the FC ranks are at most 8 and at most one
a chunk of K. :func:`score_plan` / :func:`score_gemm_plan` price a plan on
the card's roofline (:mod:`repro_torch.core.roofline`): the operations
over the mode's peak, stretched by the wave quantisation of the plan's
grid over the SMs (fp32 tiles by their measured relative block cost,
``conv_pipe.FP32_BLOCK_COST``), against the bytes: x re-gathered once per
channel tile (FC: once per feature tile), w once per position tile (FC:
once per 8 rows), b once and the output once, over the memory rate, and
for the FC weight stream the busiest block's slab at
:data:`BLOCK_STREAM_BPS`. No term falls below the layer's bound (each
input read once, each output written once, at the peak rate).

:func:`best_plan` / :func:`best_gemm_plan` return the measured rules the
kernels launch with by default (``conv_tile``, ``fc_split``), so a compile
with the default plans launches the same tiles as a launch without one;
the model's own ranking is what :func:`repro_torch.obs.profiler.shortlist`
offers the stopwatch. The registry memoises one plan per ``(shape,
backend, vmem_budget)``; the backend is the card's tag
(``roofline.DeviceProfile.tag``, e.g. ``cuda:sm_90:132``), so a plan
tuned at another SM count never reaches this card. :func:`measure_plan` /
:func:`measure_gemm_plan` time one plan on the card with CUDA events.
"""
from __future__ import annotations

import contextlib
import dataclasses
import itertools
import zlib
from dataclasses import dataclass
from typing import Dict, Iterator, List, Optional, Tuple

import torch

from repro_torch.core.roofline import (H100, DeviceProfile, device_profile,
                                       profile_for, time_bounds)
from repro_torch.kernels import conv_pipe as cp
from repro_torch.kernels import matmul_pipe as mp

__all__ = [
    "ConvShape", "ConvPlan", "GemmShape", "GemmPlan",
    "conv_smem_bytes", "plan_fits", "score_plan", "conv_bound",
    "enumerate_plans", "rule_plan", "best_plan", "manual_plan",
    "gemm_smem_bytes", "gemm_plan_fits", "score_gemm_plan", "gemm_bound",
    "enumerate_gemm_plans", "rule_gemm_plan", "best_gemm_plan",
    "measure_plan", "measure_gemm_plan",
    "get_plan", "get_gemm_plan", "plan_for_layer", "gemm_plan_for_layer",
    "clear_registry", "registry_snapshot", "gemm_registry_snapshot",
    "seed_registry", "record_lookups", "default_backend", "is_port_backend",
    "sweep_stats", "reset_sweep_stats",
    "measure_stats", "reset_measure_stats", "count_measure_hit",
]

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "int8": torch.int8}
_DTYPE_BYTES = {"float32": 4, "bfloat16": 2, "float16": 2, "int8": 1}
# reduction chunk of each conv mode's kernel (csrc BKF, BK; int8 128 k with
# the vector gather, C/G % 16 == 0, else 64)
_CONV_CHUNK = {"float32": 16, "bfloat16": 32}
# What one block of a split-K FC kernel streams, bytes/s, whatever its
# tile, as tile_sweep.py measured it on an H100 (PERF.md section 7)
BLOCK_STREAM_BPS = 17e9
DEFAULT_BUDGET = H100.smem_per_block


@dataclass(frozen=True)
class ConvShape:
    """Static signature of one conv(+pool) layer: the registry key, with
    the JAX package's fields and names (the plan table's join key).
    ``b`` is the batch the layer is tuned for."""
    h: int
    w: int
    c: int                      # total input channels (all groups)
    kh: int
    kw: int
    m: int                      # total output channels (all groups)
    stride: int = 1
    pad: int = 0
    groups: int = 1
    pool: Optional[str] = None
    pool_k: int = 2
    pool_s: int = 2
    dtype: str = "float32"
    b: int = 1

    @property
    def oh(self) -> int:
        return (self.h + 2 * self.pad - self.kh) // self.stride + 1

    @property
    def ow(self) -> int:
        return (self.w + 2 * self.pad - self.kw) // self.stride + 1

    @property
    def ph(self) -> int:
        """Rows of the layer's output: pooled, or the conv's."""
        return (self.oh - self.pool_k) // self.pool_s + 1 if self.pool \
            else self.oh

    @property
    def pw(self) -> int:
        return (self.ow - self.pool_k) // self.pool_s + 1 if self.pool \
            else self.ow

    @property
    def macs(self) -> int:
        """Multiply-accumulates per image (grouped conv divides C)."""
        return (self.oh * self.ow * self.m * self.kh * self.kw
                * (self.c // self.groups))


@dataclass(frozen=True)
class ConvPlan:
    """One launch's tile: ``tp`` positions x ``tn`` channels, ``tph`` x
    ``tpw`` pooled outputs a block (1 x 1 without a pool); the shared
    memory it requests and its modelled time, seconds per image."""
    tp: int
    tn: int
    tph: int = 1
    tpw: int = 1
    smem_bytes: int = 0
    t_model: float = 0.0

    @property
    def tile(self) -> Tuple[int, int, int, int]:
        """What ``conv_pipe(tile=...)`` takes."""
        return (self.tp, self.tn, self.tph, self.tpw)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


@dataclass(frozen=True)
class GemmShape:
    """Static signature of one batched-FC launch: ``m`` rows (the serving
    micro-batch), ``k`` -> ``n`` features, ``dtype`` the compute mode."""
    m: int
    k: int
    n: int
    dtype: str = "float32"

    @property
    def macs(self) -> int:
        return self.m * self.k * self.n


@dataclass(frozen=True)
class GemmPlan:
    """One FC launch's split: ``tnf`` features a cluster of ``ranks``
    blocks, which split K; its shared memory a block and its modelled
    time, seconds per call."""
    tnf: int
    ranks: int
    smem_bytes: int = 0
    t_model: float = 0.0

    @property
    def split(self) -> Tuple[int, int]:
        """What ``matmul_pipe(split=...)`` takes."""
        return (self.tnf, self.ranks)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


def default_backend() -> str:
    """This process's backend tag: the CUDA device's, else the H100
    profile's (the card CPU compiles plan for)."""
    return device_profile().tag


def is_port_backend(tag: str) -> bool:
    """True for the port's tags (``cuda:sm_<cc>:<sms>``); False for the JAX
    package's ``"tpu"``, whose plans no CUDA kernel takes."""
    return isinstance(tag, str) and tag.startswith("cuda:sm_")


def _profile(backend: Optional[str]) -> DeviceProfile:
    return profile_for(backend or default_backend())


# ---------------------------------------------------------------------------
# conv plans
# ---------------------------------------------------------------------------

def conv_smem_bytes(shape: ConvShape, tp: int, tn: int) -> int:
    """Shared memory a block of tile ``tp`` x ``tn`` requests for this
    layer (0 where no kernel is instantiated)."""
    return cp.conv_smem(_DTYPES[shape.dtype], tp, tn,
                        shape.c // shape.groups)


def plan_fits(shape: ConvShape, plan: ConvPlan,
              vmem_budget: int = DEFAULT_BUDGET) -> bool:
    """Pure feasibility predicate: can the kernel launch ``plan`` on this
    layer within ``vmem_budget`` bytes of shared memory a block? The
    wrapper's own check (``conv_pipe.tile_problem``); no side effects."""
    return cp.tile_problem(plan.tile, _DTYPES[shape.dtype],
                           shape.c // shape.groups, shape.ph, shape.pw,
                           shape.pool, shape.pool_k, shape.pool_s,
                           vmem_budget) is None


def _position_blocks(shape: ConvShape, tp: int, tph: int, tpw: int) -> int:
    if shape.pool is None:
        return -(-shape.b * shape.oh * shape.ow // tp)
    return shape.b * -(-shape.ph // tph) * -(-shape.pw // tpw)


def _conv_bytes(shape: ConvShape) -> Tuple[int, int, int, int]:
    """(x, w, b, out) bytes of the layer, each once (int8: b and the
    requantize scale fp32, int8 output)."""
    es = _DTYPE_BYTES[shape.dtype]
    x = shape.b * shape.h * shape.w * shape.c * es
    w = shape.kh * shape.kw * (shape.c // shape.groups) * shape.m * es
    b = shape.m * (8 if shape.dtype == "int8" else es)
    out = shape.b * shape.ph * shape.pw * shape.m * es
    return x, w, b, out


def conv_bound(shape: ConvShape, profile: Optional[DeviceProfile] = None
               ) -> Tuple[float, float]:
    """(t_ops, t_bytes), seconds for the batch: the layer's operations
    (every conv position) at the mode's peak, and its bytes, each input
    read once and the output written once — the bound ``chip_smoke.py``
    prints for the layer."""
    return time_bounds(2 * shape.b * shape.macs, sum(_conv_bytes(shape)),
                       dtype=shape.dtype, profile=profile)


def score_plan(shape: ConvShape, tp: int, tn: int, tph: int = 1,
               tpw: int = 1, *, profile: Optional[DeviceProfile] = None
               ) -> Tuple[float, float]:
    """(t_compute, t_memory) of one tile, seconds PER IMAGE.

    Compute: rounds of blocks an SM (``ceil(blocks / sms)``) times one
    block's time, a block computing every row of its tile over K rounded
    up to the kernel's chunk at the SM's share of the peak (fp32: a
    128 x 128 block's, times ``FP32_BLOCK_COST`` of the tile); never below
    the layer's operations at the peak. Memory: x once per channel tile, w
    once per position tile, b and the output once."""
    p = profile or H100
    cg, mg = shape.c // shape.groups, shape.m // shape.groups
    n_pos = _position_blocks(shape, tp, tph, tpw)
    blocks = n_pos * shape.groups * -(-mg // tn)
    chunk = _CONV_CHUNK.get(shape.dtype, 128 if cg % 16 == 0 else 64)
    kp = -(-shape.kh * shape.kw * cg // chunk) * chunk
    sm_rate = p.peak_ops(shape.dtype) / p.sms
    if shape.dtype == "float32":
        t_block = cp.FP32_BLOCK_COST[(tp, tn)] * 2 * 128 * 128 * kp / sm_rate
    else:
        t_block = 2 * tp * tn * kp / sm_rate
    t_ops, _ = conv_bound(shape, p)
    tc = max(-(-blocks // p.sms) * t_block, t_ops)
    x, w, b, out = _conv_bytes(shape)
    tm = (-(-mg // tn) * x + n_pos * w + b + out) / p.hbm_bw
    return tc / shape.b, tm / shape.b


def _conv_plan(shape: ConvShape, tp: int, tn: int, tph: int, tpw: int,
               profile: DeviceProfile) -> ConvPlan:
    tc, tm = score_plan(shape, tp, tn, tph, tpw, profile=profile)
    return ConvPlan(tp, tn, tph, tpw, smem_bytes=conv_smem_bytes(shape, tp, tn),
                    t_model=max(tc, tm))


def enumerate_plans(shape: ConvShape, vmem_budget: int = DEFAULT_BUDGET, *,
                    backend: Optional[str] = None) -> List[ConvPlan]:
    """Every tile the kernels instantiate that fits this layer within the
    budget, each with ``pool_tile``'s pooled patch for its rows."""
    prof = _profile(backend)
    plans = []
    for tp, tn in itertools.product(cp.POSITIONS, cp.CHANNELS):
        tph = tpw = 1
        if shape.pool is not None:
            if shape.pool_k * shape.pool_k > tp:
                continue
            tph, tpw = cp.pool_tile(shape.ph, shape.pw, shape.pool_k,
                                    shape.pool_s, tp)
        plan = _conv_plan(shape, tp, tn, tph, tpw, prof)
        if plan_fits(shape, plan, vmem_budget):
            plans.append(plan)
    return plans


def rule_plan(shape: ConvShape, *, backend: Optional[str] = None
              ) -> ConvPlan:
    """The tile ``conv_pipe.conv_tile`` launches this layer with on the
    backend's card: the kernels' measured rule, priced by the model."""
    prof = _profile(backend)
    tile = cp.conv_tile(_DTYPES[shape.dtype], shape.b, shape.oh, shape.ow,
                        shape.m // shape.groups, shape.groups, shape.pool,
                        shape.pool_k, shape.pool_s, prof.sms,
                        shape.c // shape.groups)
    return _conv_plan(shape, *tile, prof)


def best_plan(shape: ConvShape, vmem_budget: int = DEFAULT_BUDGET, *,
              backend: Optional[str] = None) -> ConvPlan:
    """The default plan: the measured rule's tile where it fits the
    budget, else the lowest modelled time among the tiles that do (ties
    to larger tiles)."""
    rule = rule_plan(shape, backend=backend)
    if plan_fits(shape, rule, vmem_budget):
        return rule
    plans = enumerate_plans(shape, vmem_budget, backend=backend)
    if not plans:
        raise ValueError(f"no conv tile fits {shape} under {vmem_budget} B "
                         f"of shared memory a block")
    return min(plans, key=lambda p: (p.t_model, -p.tp * p.tn))


def manual_plan(shape: ConvShape, tn: int,
                vmem_budget: int = DEFAULT_BUDGET, *,
                backend: Optional[str] = None) -> ConvPlan:
    """``Tiling(autotune=False, cu_num=tn)``'s plan: the lowest modelled
    time among the fitting tiles with ``tn`` channels (the paper's CU_NUM
    pinned, the positions left to the model)."""
    plans = [p for p in enumerate_plans(shape, vmem_budget, backend=backend)
             if p.tn == tn]
    if not plans:
        raise ValueError(f"no conv tile with tn {tn} fits {shape} under "
                         f"{vmem_budget} B of shared memory a block")
    return min(plans, key=lambda p: (p.t_model, -p.tp))


# ---------------------------------------------------------------------------
# FC (GEMM) plans
# ---------------------------------------------------------------------------

def gemm_smem_bytes(shape: GemmShape, tnf: int) -> int:
    return mp.fc_smem(_DTYPES[shape.dtype], tnf)


def gemm_plan_fits(shape: GemmShape, plan: GemmPlan,
                   vmem_budget: int = DEFAULT_BUDGET) -> bool:
    """Pure feasibility predicate for an FC split (the wrapper's own
    check, ``matmul_pipe.split_problem``)."""
    return mp.split_problem(plan.split, _DTYPES[shape.dtype], shape.k,
                            vmem_budget) is None


def _gemm_bytes(shape: GemmShape) -> Tuple[int, int, int, int]:
    es = _DTYPE_BYTES[shape.dtype]
    b = shape.n * (8 if shape.dtype == "int8" else es)
    return (shape.m * shape.k * es, shape.k * shape.n * es, b,
            shape.m * shape.n * es)


def gemm_bound(shape: GemmShape, profile: Optional[DeviceProfile] = None
               ) -> Tuple[float, float]:
    """(t_ops, t_bytes) of the launch, each input read once and the output
    written once (int8: int8 out, fp32 b and scale)."""
    return time_bounds(2 * shape.macs, sum(_gemm_bytes(shape)),
                       dtype=shape.dtype, profile=profile)


def score_gemm_plan(shape: GemmShape, tnf: int, ranks: int, *,
                    profile: Optional[DeviceProfile] = None
                    ) -> Tuple[float, float]:
    """(t_compute, t_memory) of one split, seconds PER CALL.

    Compute: rounds of blocks an SM times one block's share (8 rows x
    ``tnf`` features x its chunks of K) at the SM's share of the peak,
    never below the launch's operations at the peak. Memory: w once per 8
    rows, x once per feature tile, b and y once, over the memory rate; and
    no faster than the busiest block streams its slab of w at
    :data:`BLOCK_STREAM_BPS`."""
    p = profile or H100
    dt = _DTYPES[shape.dtype]
    es = _DTYPE_BYTES[shape.dtype]
    rows = -(-shape.m // 8)
    feats = -(-shape.n // tnf)
    blocks = feats * rows * ranks
    chunk = mp.fc_chunk(dt, tnf)
    n_chunks = -(-shape.k // chunk)
    per_rank = -(-n_chunks // ranks) * chunk      # k the busiest block sums
    sm_rate = p.peak_ops(shape.dtype) / p.sms
    t_ops, _ = gemm_bound(shape, p)
    tc = max(-(-blocks // p.sms) * 2 * 8 * tnf * per_rank / sm_rate, t_ops)
    x, w, b, y = _gemm_bytes(shape)
    tm = max((rows * w + feats * x + b + y) / p.hbm_bw,
             per_rank * tnf * es / BLOCK_STREAM_BPS)
    return tc, tm


def _gemm_plan(shape: GemmShape, tnf: int, ranks: int,
               profile: DeviceProfile) -> GemmPlan:
    tc, tm = score_gemm_plan(shape, tnf, ranks, profile=profile)
    return GemmPlan(tnf, ranks, smem_bytes=gemm_smem_bytes(shape, tnf),
                    t_model=max(tc, tm))


def enumerate_gemm_plans(shape: GemmShape, vmem_budget: int = DEFAULT_BUDGET,
                         *, backend: Optional[str] = None) -> List[GemmPlan]:
    """Every split the kernels take at this shape within the budget: each
    instantiated feature tile x 1 to 8 ranks."""
    prof = _profile(backend)
    plans = []
    for tnf in mp.FC_FEATURES[_DTYPES[shape.dtype]]:
        for ranks in range(1, mp.FC_RANKS + 1):
            plan = _gemm_plan(shape, tnf, ranks, prof)
            if gemm_plan_fits(shape, plan, vmem_budget):
                plans.append(plan)
    return plans


def rule_gemm_plan(shape: GemmShape, *, backend: Optional[str] = None
                   ) -> GemmPlan:
    """The split ``matmul_pipe.fc_split`` launches with on the backend's
    card, priced by the model."""
    prof = _profile(backend)
    tnf, ranks = mp.fc_split(_DTYPES[shape.dtype], shape.m, shape.k,
                             shape.n, prof.sms)
    return _gemm_plan(shape, tnf, ranks, prof)


def best_gemm_plan(shape: GemmShape, vmem_budget: int = DEFAULT_BUDGET, *,
                   backend: Optional[str] = None) -> GemmPlan:
    """The default split: the measured rule's where it fits the budget,
    else the lowest modelled time among those that do."""
    rule = rule_gemm_plan(shape, backend=backend)
    if gemm_plan_fits(shape, rule, vmem_budget):
        return rule
    plans = enumerate_gemm_plans(shape, vmem_budget, backend=backend)
    if not plans:
        raise ValueError(f"no FC split fits {shape} under {vmem_budget} B "
                         f"of shared memory a block")
    return min(plans, key=lambda p: (p.t_model, -p.tnf * p.ranks))


# ---------------------------------------------------------------------------
# measurement on the card
# ---------------------------------------------------------------------------

# the operands of the shape measured last: repeated samples and every plan
# of one layer time the same bytes without drawing them again
_OPERANDS: Dict[tuple, tuple] = {}


def _measure_seed(shape) -> int:
    """Deterministic seed per shape: ``zlib.crc32`` of its repr, not
    ``hash()``, which is salted per process."""
    return zlib.crc32(repr(shape).encode())


def _cuda(device) -> torch.device:
    dev = torch.device(device if device is not None else "cuda")
    if dev.type != "cuda" or not torch.cuda.is_available():
        raise RuntimeError(
            "measure_plan times the CUDA kernel with CUDA events: it needs a "
            "CUDA device")
    return dev


def _operands(kind: str, shape, dev: torch.device) -> tuple:
    key = (kind, shape, str(dev))
    if key not in _OPERANDS:
        _OPERANDS.clear()
        gen = torch.Generator(device=dev).manual_seed(_measure_seed(shape))
        if kind == "conv":
            xs = (shape.b, shape.h, shape.w, shape.c)
            ws = (shape.kh, shape.kw, shape.c // shape.groups, shape.m)
            n = shape.m
        else:
            xs, ws, n = (shape.m, shape.k), (shape.k, shape.n), shape.n
        if shape.dtype == "int8":
            x = torch.randint(-127, 128, xs, generator=gen, device=dev,
                              dtype=torch.int8)
            w = torch.randint(-127, 128, ws, generator=gen, device=dev,
                              dtype=torch.int8)
            b = 0.1 * torch.randn(n, generator=gen, device=dev)
            q = dict(scale=torch.full((n,), 1e-4, device=dev),
                     out_scale=0.05)
        else:
            dt = _DTYPES[shape.dtype]
            x = torch.randn(xs, generator=gen, device=dev).to(dt)
            w = (0.1 * torch.randn(ws, generator=gen, device=dev)).to(dt)
            b = (0.1 * torch.randn(n, generator=gen, device=dev)).to(dt)
            q = {}
        _OPERANDS[key] = (x, w, b, q)
    return _OPERANDS[key]


def _time_calls(run, iters: int, warmup: int) -> float:
    """Seconds a call: one pair of CUDA events around ``iters`` calls,
    after ``warmup`` untimed ones."""
    for _ in range(max(1, warmup)):
        run()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(max(1, iters)):
        run()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3 / max(1, iters)


def measure_plan(shape: ConvShape, plan: ConvPlan, *, iters: int = 3,
                 warmup: int = 1, device=None) -> float:
    """Seconds a call of ``conv_pipe`` launched with ``plan`` on seeded
    operands of ``shape`` (int8: random codes, a requantize scale and int8
    output), timed on the card with CUDA events. Counted in
    :func:`measure_stats` (``conv_measured``)."""
    dev = _cuda(device)
    x, w, b, q = _operands("conv", shape, dev)

    def run():
        return cp.conv_pipe(x, w, b, stride=shape.stride, pad=shape.pad,
                            pool=shape.pool, pool_k=shape.pool_k,
                            pool_s=shape.pool_s, groups=shape.groups,
                            tile=plan.tile, **q)
    t = _time_calls(run, iters, warmup)
    _MEASURE_STATS["conv_measured"] += 1
    return t


def measure_gemm_plan(shape: GemmShape, plan: GemmPlan, *, iters: int = 3,
                      warmup: int = 1, device=None) -> float:
    """Seconds a call of ``matmul_pipe`` launched with ``plan``, as
    :func:`measure_plan` (``gemm_measured``)."""
    dev = _cuda(device)
    x, w, b, q = _operands("gemm", shape, dev)

    def run():
        return mp.matmul_pipe(x, w, b, relu=True, split=plan.split, **q)
    t = _time_calls(run, iters, warmup)
    _MEASURE_STATS["gemm_measured"] += 1
    return t


# ---------------------------------------------------------------------------
# the registry: (shape, backend, vmem_budget) -> plan
# ---------------------------------------------------------------------------

_REGISTRY: Dict[Tuple[ConvShape, str, int], ConvPlan] = {}
_GEMM_REGISTRY: Dict[Tuple[GemmShape, str, int], GemmPlan] = {}

# DSE accounting: sweeps that ran vs lookups the registry absorbed (a
# loaded plan table makes a compile all hits)
_SWEEP_STATS = {"conv_sweeps": 0, "conv_hits": 0,
                "gemm_sweeps": 0, "gemm_hits": 0}
# measurements that ran vs those the profiler's cache absorbed
_MEASURE_STATS = {"conv_measured": 0, "conv_measure_hits": 0,
                  "gemm_measured": 0, "gemm_measure_hits": 0}


def sweep_stats() -> Dict[str, int]:
    """A snapshot of the DSE sweep/cache-hit counters."""
    return dict(_SWEEP_STATS)


def reset_sweep_stats() -> None:
    for k in _SWEEP_STATS:
        _SWEEP_STATS[k] = 0


def measure_stats() -> Dict[str, int]:
    """A snapshot of the kernel-measurement/cache-hit counters."""
    return dict(_MEASURE_STATS)


def reset_measure_stats() -> None:
    for k in _MEASURE_STATS:
        _MEASURE_STATS[k] = 0


def count_measure_hit(kind: str) -> None:
    """Record a profiler measurement-cache hit (``kind`` conv|gemm)."""
    _MEASURE_STATS[f"{kind}_measure_hits"] += 1


# open lookup recorders: every get_plan / get_gemm_plan resolution, hit or
# sweep, is appended to each, in snapshot format (compile_cnn opens one)
_RECORDERS: List[Dict[str, list]] = []


@contextlib.contextmanager
def record_lookups() -> Iterator[Dict[str, list]]:
    """Record every plan lookup inside the block: yields ``{"conv": [...],
    "gemm": [...]}`` rows in :func:`registry_snapshot`'s format
    (duplicates included)."""
    rows: Dict[str, list] = {"conv": [], "gemm": []}
    _RECORDERS.append(rows)
    try:
        yield rows
    finally:
        _RECORDERS[:] = [r for r in _RECORDERS if r is not rows]


def _record(kind: str, shape, backend: str, vmem_budget: int, plan) -> None:
    if _RECORDERS:
        row = {"shape": dataclasses.asdict(shape), "backend": backend,
               "vmem_budget": vmem_budget, "plan": plan.to_dict()}
        for rec in _RECORDERS:
            rec[kind].append(row)


def get_plan(shape: ConvShape, *, vmem_budget: int = DEFAULT_BUDGET,
             backend: Optional[str] = None) -> ConvPlan:
    """Memoised default plan of a layer (:func:`best_plan`), keyed by
    shape (dtype and batch inside), backend and budget."""
    backend = backend or default_backend()
    key = (shape, backend, vmem_budget)
    plan = _REGISTRY.get(key)
    if plan is None:
        _SWEEP_STATS["conv_sweeps"] += 1
        plan = best_plan(shape, vmem_budget, backend=backend)
        _REGISTRY[key] = plan
    else:
        _SWEEP_STATS["conv_hits"] += 1
    _record("conv", shape, backend, vmem_budget, plan)
    return plan


def plan_for_layer(x_shape: Tuple[int, ...], w_shape: Tuple[int, ...], *,
                   stride: int = 1, pad: int = 0, groups: int = 1,
                   pool: Optional[str] = None, pool_k: int = 2,
                   pool_s: int = 2, dtype: str = "float32",
                   vmem_budget: int = DEFAULT_BUDGET,
                   backend: Optional[str] = None) -> ConvPlan:
    """Build the ConvShape key from NHWC x and HWIO w shapes and look it
    up; the batch in ``x_shape`` is part of the key."""
    b, h, w, c = x_shape
    kh, kw, _, m = w_shape
    shape = ConvShape(h=h, w=w, c=c, kh=kh, kw=kw, m=m, stride=stride,
                      pad=pad, groups=groups, pool=pool, pool_k=pool_k,
                      pool_s=pool_s, dtype=dtype, b=b)
    return get_plan(shape, vmem_budget=vmem_budget, backend=backend)


def get_gemm_plan(shape: GemmShape, *, vmem_budget: int = DEFAULT_BUDGET,
                  backend: Optional[str] = None) -> GemmPlan:
    """Memoised default split of an FC launch (:func:`best_gemm_plan`)."""
    backend = backend or default_backend()
    key = (shape, backend, vmem_budget)
    plan = _GEMM_REGISTRY.get(key)
    if plan is None:
        _SWEEP_STATS["gemm_sweeps"] += 1
        plan = best_gemm_plan(shape, vmem_budget, backend=backend)
        _GEMM_REGISTRY[key] = plan
    else:
        _SWEEP_STATS["gemm_hits"] += 1
    _record("gemm", shape, backend, vmem_budget, plan)
    return plan


def gemm_plan_for_layer(m: int, k: int, n: int, *, dtype: str = "float32",
                        vmem_budget: int = DEFAULT_BUDGET,
                        backend: Optional[str] = None) -> GemmPlan:
    """Look up one FC layer: ``m`` rows, ``k`` -> ``n`` features."""
    return get_gemm_plan(GemmShape(m=m, k=k, n=n, dtype=dtype),
                         vmem_budget=vmem_budget, backend=backend)


def clear_registry() -> None:
    _REGISTRY.clear()
    _GEMM_REGISTRY.clear()


def _snapshot(registry) -> List[dict]:
    return [{"shape": dataclasses.asdict(k[0]), "backend": k[1],
             "vmem_budget": k[2], "plan": p.to_dict()} for k, p in sorted(
                 registry.items(), key=lambda kv: repr(kv[0]))]


def registry_snapshot() -> List[dict]:
    """JSON-serialisable view of every conv plan in the registry."""
    return _snapshot(_REGISTRY)


def gemm_registry_snapshot() -> List[dict]:
    """JSON-serialisable view of every FC plan in the registry."""
    return _snapshot(_GEMM_REGISTRY)


def seed_registry(conv_rows=(), gemm_rows=()) -> int:
    """Insert serialised plan rows into the registries (the inverse of the
    snapshots), so a saved table satisfies every lookup without a sweep.
    Only the port's rows (:func:`is_port_backend`) are read: a JAX table's
    ``"tpu"`` rows hold Pallas blockings no CUDA kernel takes. Keys already
    present win; returns the number inserted."""
    inserted = 0
    for rows, registry, mk_shape, mk_plan in (
            (conv_rows, _REGISTRY, ConvShape, ConvPlan),
            (gemm_rows, _GEMM_REGISTRY, GemmShape, GemmPlan)):
        for row in rows:
            if not is_port_backend(row["backend"]):
                continue
            key = (mk_shape(**row["shape"]), row["backend"],
                   row["vmem_budget"])
            if key not in registry:
                registry[key] = mk_plan(**row["plan"])
                inserted += 1
    return inserted
