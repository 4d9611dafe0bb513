"""Partition a CNN into balanced pipeline stages, on the card's cost model.

The JAX package's ``serve/stage_planner.py`` over the port's DSE: the
GPipe round time is ``(M + S - 1) * max_s t_stage``, so the slowest stage
sets the fleet's rate. Fusion groups (``models.cnn.fuse_plan``: a fused
conv(+pool) launch, a standalone LRN or pool, an FC layer) are sliced into
S contiguous chunks minimising the largest modelled stage time, with the
same per-layer model the DSE prices plans with
(:mod:`repro_torch.kernels.autotune`):

* conv groups: the registry plan's ``t_model`` (per image) times the
  batch;
* fc groups: the registry split's ``t_model`` (per call);
* standalone pool / LRN: their bytes (read in, write out) over the memory
  rate; the LRN at 4 bytes an element, as the JAX package prices it.

:func:`total_cost` (one replica's round) is the modelled clock's service
time (``Serving(clock="modeled")``).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

from repro_torch.core.config import CNNConfig
from repro_torch.core.roofline import pipeline_bubble_fraction, profile_for
from repro_torch.kernels.autotune import (_DTYPE_BYTES, DEFAULT_BUDGET,
                                          ConvShape, GemmShape,
                                          default_backend, get_gemm_plan,
                                          get_plan)
from repro_torch.models.cnn import fuse_plan


def group_io_shapes(cfg: CNNConfig) -> List[Tuple[Tuple[int, ...],
                                                  Tuple[int, ...],
                                                  Tuple[int, ...]]]:
    """Per fusion group: ``(group, in_shape, out_shape)`` per image:
    ``(H, W, C)`` between spatial groups, ``(features,)`` after an FC."""
    out = []
    hw, c = cfg.input_hw, cfg.input_ch
    for group in fuse_plan(cfg):
        in_shape: Tuple[int, ...] = (hw, hw, c)
        for i in group:
            l = cfg.layers[i]
            if l.kind == "conv":
                hw = (hw + 2 * l.pad - l.kernel) // l.stride + 1
                c = l.out_ch
            elif l.kind == "pool":
                hw = (hw - l.kernel) // l.stride + 1
            elif l.kind == "fc":
                hw, c = 1, l.out_ch
        out_shape = (c,) if cfg.layers[group[-1]].kind == "fc" \
            else (hw, hw, c)
        if cfg.layers[group[0]].kind == "fc":
            in_shape = out[-1][2] if out else in_shape
        out.append((group, in_shape, out_shape))
    return out


def group_shape(cfg: CNNConfig, group: Tuple[int, ...],
                in_shape: Tuple[int, ...], out_shape: Tuple[int, ...],
                batch: int, dtype: str):
    """The DSE key of a conv(+pool) or fc group at (batch, dtype): a
    ``ConvShape`` or a ``GemmShape``; None for a standalone pool or LRN."""
    l = cfg.layers[group[0]]
    if l.kind == "conv":
        h, w, c = in_shape
        pool = cfg.layers[group[1]] if len(group) == 2 else None
        return ConvShape(
            h=h, w=w, c=c, kh=l.kernel, kw=l.kernel, m=l.out_ch,
            stride=l.stride, pad=l.pad, groups=l.groups,
            pool=(pool.pool if pool else None),
            pool_k=(pool.kernel if pool else 2),
            pool_s=(pool.stride if pool else 2), dtype=dtype, b=batch)
    if l.kind == "fc":
        k = 1
        for d in in_shape:
            k *= d
        return GemmShape(m=batch, k=k, n=out_shape[-1], dtype=dtype)
    return None


def group_cost(cfg: CNNConfig, group: Tuple[int, ...],
               in_shape: Tuple[int, ...], out_shape: Tuple[int, ...],
               batch: int, *, dtype: str = "float32",
               vmem_budget: int = DEFAULT_BUDGET,
               backend: Optional[str] = None) -> float:
    """Modelled seconds to run one fusion group over ``batch`` images."""
    backend = backend or default_backend()
    shape = group_shape(cfg, group, in_shape, out_shape, batch, dtype)
    if isinstance(shape, ConvShape):
        return get_plan(shape, vmem_budget=vmem_budget,
                        backend=backend).t_model * batch
    if isinstance(shape, GemmShape):
        return get_gemm_plan(shape, vmem_budget=vmem_budget,
                             backend=backend).t_model
    n_in = n_out = 1
    for d in in_shape:
        n_in *= d
    for d in out_shape:
        n_out *= d
    el = 4 if cfg.layers[group[0]].kind == "lrn" else _DTYPE_BYTES.get(
        dtype, 4)
    return batch * (n_in + n_out) * el / profile_for(backend).hbm_bw


@dataclass(frozen=True)
class Stage:
    """One pipeline stage: a contiguous run of fusion groups."""
    groups: Tuple[Tuple[int, ...], ...]
    in_shape: Tuple[int, ...]          # per-image boundary entering
    out_shape: Tuple[int, ...]
    t_model: float                     # modelled seconds per microbatch


@dataclass(frozen=True)
class StagePlan:
    """A balanced S-way slicing of the network."""
    stages: Tuple[Stage, ...]
    batch: int                         # images per stage invocation
    dtype: str

    @property
    def n_stages(self) -> int:
        return len(self.stages)

    @property
    def t_stage_max(self) -> float:
        return max(s.t_model for s in self.stages)

    @property
    def t_sum(self) -> float:
        return sum(s.t_model for s in self.stages)

    @property
    def balance(self) -> float:
        """mean/max stage time: 1.0 is a level pipeline."""
        return self.t_sum / (self.n_stages * self.t_stage_max)

    def max_boundary_elems(self) -> int:
        """Largest per-image activation crossing any stage boundary."""
        best = 0
        for s in self.stages:
            for shape in (s.in_shape, s.out_shape):
                n = 1
                for d in shape:
                    n *= d
                best = max(best, n)
        return best

    def round_time(self, n_microbatches: int) -> float:
        """Modelled fill-drain round: (M + S - 1) * t_stage_max."""
        return (n_microbatches + self.n_stages - 1) * self.t_stage_max

    def bubble(self, n_microbatches: int) -> float:
        return pipeline_bubble_fraction(self.n_stages, n_microbatches)


def _min_max_partition(costs: List[float], k: int) -> List[int]:
    """Start indices of the contiguous k-partition minimising the largest
    chunk sum (exact DP; the first is 0)."""
    n = len(costs)
    prefix = [0.0]
    for c in costs:
        prefix.append(prefix[-1] + c)
    inf = float("inf")
    dp = [[inf] * (n + 1) for _ in range(k + 1)]
    cut = [[0] * (n + 1) for _ in range(k + 1)]
    dp[0][0] = 0.0
    for j in range(1, k + 1):
        for i in range(j, n + 1):
            for s in range(j - 1, i):
                cand = max(dp[j - 1][s], prefix[i] - prefix[s])
                if cand < dp[j][i]:
                    dp[j][i] = cand
                    cut[j][i] = s
    bounds = []
    i = n
    for j in range(k, 0, -1):
        s = cut[j][i]
        bounds.append(s)
        i = s
    return bounds[::-1]


def plan_stages(cfg: CNNConfig, n_stages: int, *, batch: int = 1,
                dtype: str = "float32", vmem_budget: int = DEFAULT_BUDGET,
                backend: Optional[str] = None) -> StagePlan:
    """Slice the network into ``n_stages`` roofline-balanced stages of
    indivisible fusion groups, costed at the microbatch ``batch``."""
    shapes = group_io_shapes(cfg)
    if n_stages < 1 or n_stages > len(shapes):
        raise ValueError(
            f"n_stages={n_stages} not in [1, {len(shapes)}] "
            f"(the network has {len(shapes)} indivisible fusion groups)")
    costs = [group_cost(cfg, g, i, o, batch, dtype=dtype,
                        vmem_budget=vmem_budget, backend=backend)
             for g, i, o in shapes]
    starts = _min_max_partition(costs, n_stages)
    stages = []
    for si, s in enumerate(starts):
        e = starts[si + 1] if si + 1 < len(starts) else len(shapes)
        chunk = shapes[s:e]
        stages.append(Stage(
            groups=tuple(g for g, _, _ in chunk),
            in_shape=chunk[0][1], out_shape=chunk[-1][2],
            t_model=sum(costs[s:e])))
    return StagePlan(stages=tuple(stages), batch=batch, dtype=dtype)


def total_cost(cfg: CNNConfig, batch: int, *, dtype: str = "float32",
               vmem_budget: int = DEFAULT_BUDGET,
               backend: Optional[str] = None) -> float:
    """Modelled seconds for one replica to serve a ``batch`` micro-batch:
    the sum of every group's cost (the modelled clock's round time)."""
    return sum(group_cost(cfg, g, i, o, batch, dtype=dtype,
                          vmem_budget=vmem_budget, backend=backend)
               for g, i, o in group_io_shapes(cfg))
