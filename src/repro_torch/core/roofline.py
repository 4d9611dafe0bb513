"""The card's roofline: peak rates, memory rate, the per-kernel terms, and
the three-term report of a traced step.

The JAX package's ``core/roofline.py`` holds a TPU v5e's constants (its
MXU rates, 16 MiB of VMEM) and parses XLA's HLO for collectives. The port
keeps the two functions its cost model needs, :func:`time_bounds` and
:func:`pipeline_bubble_fraction`, over the card's numbers, bundled as a
:class:`DeviceProfile`:

* fp32 FFMA: 128 lanes an SM, 2 FLOP a lane a clock;
* dense bf16 tensor cores: 4096 FLOP a clock an SM;
* dense int8 tensor cores: 8192 ops a clock an SM;
* device memory at the published rate of the card (NVIDIA data sheets);
* the opt-in shared memory a block (the CUDA kernels' on-chip budget,
  the counterpart of the TPU's VMEM).

:data:`H100` is the named profile of an NVIDIA H100 80GB HBM3 at 700 W:
132 SMs at 1980 MHz, 66.9 TFLOP/s fp32, 1070.5 TFLOP/s bf16, 2141 TOP/s
int8, 3.35 TB/s, 227 KB a block. CPU compiles and tests use it; on the
card, :func:`device_profile` reads the SM count, the clock and the shared
memory from ``torch.cuda.get_device_properties``.

The report half (:class:`RooflineReport`, :func:`analyze_trace`) is the
JAX package's with the card's rates: ``T_compute`` = products over the
bf16 tensor-core peak, ``T_memory`` = bytes over the memory rate,
``T_collective`` = collective bytes over :data:`NVLINK_BW`. JAX fills it
from XLA (``analyze_compiled`` over ``cost_analysis_dict`` and
``collective_bytes_from_hlo``); the port has no XLA and fills it from a
:class:`TraceCounter`, a dispatch mode that sees one rank's local ops
of a DTensor trace. The TPU's ``mxu_utilization``, ``MXU_DIM``,
``VMEM_BYTES`` and ``ICI_BW`` have no meaning on the card and are left
out, as are the XLA readers.
"""
from __future__ import annotations

import dataclasses
import functools
import re
import weakref
from dataclasses import dataclass, replace
from typing import Dict, Optional, Tuple

__all__ = ["COLLECTIVES", "DeviceProfile", "H100", "KINDS", "MEM_BW",
           "NVLINK_BW",
           "RooflineReport", "TraceCounter", "analyze_trace", "call_site",
           "device_profile", "pipeline_bubble_fraction", "profile_for",
           "time_bounds"]

# published device-memory rates (bytes/s, NVIDIA data sheets), by a part of
# the name the card reports
MEM_BW = {"H100 80GB HBM3": 3.35e12, "H100 PCIe": 2.0e12,
          "H100 NVL": 3.9e12, "H200": 4.8e12}


# NVLink 4 between H100 SXM cards: 450 GB/s a direction (NVIDIA H100 SXM
# data sheet, 900 GB/s both ways); the card's counterpart of JAX's ICI_BW
NVLINK_BW = 450e9


@dataclass(frozen=True)
class DeviceProfile:
    """One card's rates. ``peak_ops(dtype)`` is the dense rate of the
    mode's unit (FFMA for float32, the tensor cores for bfloat16 and
    int8); ``tag`` keys the plan registry, so plans tuned for another SM
    count are never handed to this card."""
    name: str
    sms: int
    clock_mhz: float
    hbm_bw: float                      # bytes/s
    smem_per_block: int                # opt-in dynamic shared memory, bytes
    capability: Tuple[int, int] = (9, 0)
    ffma_per_clock_sm: float = 128     # fp32 lanes (2 FLOP each a clock)
    bf16_per_clock_sm: float = 4096    # dense bf16 FLOP
    int8_per_clock_sm: float = 8192    # dense int8 ops

    def peak_ops(self, dtype: str = "bfloat16") -> float:
        """Operations a second of the unit the ``dtype`` mode runs on."""
        hz = self.sms * self.clock_mhz * 1e6
        if dtype == "int8":
            return self.int8_per_clock_sm * hz
        if dtype == "float32":
            return 2 * self.ffma_per_clock_sm * hz
        return self.bf16_per_clock_sm * hz

    @property
    def tag(self) -> str:
        """The registry's backend tag, e.g. ``cuda:sm_90:132``."""
        return f"cuda:sm_{self.capability[0]}{self.capability[1]}:{self.sms}"


H100 = DeviceProfile(name="NVIDIA H100 80GB HBM3, 700 W", sms=132,
                     clock_mhz=1980.0, hbm_bw=MEM_BW["H100 80GB HBM3"],
                     smem_per_block=227 * 1024)

_PROFILES: Dict[str, DeviceProfile] = {H100.tag: H100}


@functools.lru_cache(maxsize=None)
def _cuda_profile(index: int) -> DeviceProfile:
    import torch
    props = torch.cuda.get_device_properties(index)
    name = props.name
    bw = next((v for k, v in MEM_BW.items() if k in name), H100.hbm_bw)
    # clock_rate is in kHz where torch reports it
    khz = getattr(props, "clock_rate", 0)
    prof = DeviceProfile(
        name=name, sms=props.multi_processor_count,
        clock_mhz=khz / 1e3 if khz else H100.clock_mhz, hbm_bw=bw,
        smem_per_block=getattr(props, "shared_memory_per_block_optin",
                               H100.smem_per_block),
        capability=(props.major, props.minor))
    _PROFILES.setdefault(prof.tag, prof)
    return prof


def device_profile(device=None) -> DeviceProfile:
    """The profile of ``device``: a CUDA device's own (memoised), else
    (``None`` without a card, or a CPU device) :data:`H100`, the card the
    plain versions stand in for."""
    import torch
    if device is None:
        if not torch.cuda.is_available():
            return H100
        device = torch.device("cuda")
    device = torch.device(device)
    if device.type != "cuda":
        return H100
    index = device.index if device.index is not None \
        else torch.cuda.current_device()
    return _cuda_profile(index)


def profile_for(tag: str) -> DeviceProfile:
    """The profile a backend tag names: one seen in this process, else
    :data:`H100` with the tag's capability and SM count (a table tuned on
    another card prices its plans at that card's SM count)."""
    if tag in _PROFILES:
        return _PROFILES[tag]
    try:
        _, sm, sms = tag.split(":")
        prof = replace(H100, sms=int(sms),
                       capability=(int(sm[3:-1]), int(sm[-1])))
    except ValueError as e:
        raise ValueError(f"not a backend tag of the port: {tag!r}") from e
    return _PROFILES.setdefault(tag, prof)


def time_bounds(flops: float, hbm_bytes: float, *, mxu_util: float = 1.0,
                dtype: str = "bfloat16",
                profile: Optional[DeviceProfile] = None
                ) -> "tuple[float, float]":
    """(t_compute, t_memory) roofline terms for one kernel launch: the
    operations over the mode's peak (times ``mxu_util``, the share of the
    unit the tile keeps busy), and the bytes over the memory rate. The
    JAX package's function, over ``profile`` (default :data:`H100`)."""
    p = profile or H100
    return (flops / (p.peak_ops(dtype) * max(mxu_util, 1e-9)),
            hbm_bytes / p.hbm_bw)


def pipeline_bubble_fraction(n_stages: int, n_microbatches: int) -> float:
    """GPipe fill-drain bubble fraction: (S-1)/(M+S-1), the share of a
    pipeline round spent filling and draining."""
    return (n_stages - 1) / (n_microbatches + n_stages - 1)


# ---------------------------------------------------------------------------
# The report of a traced step
# ---------------------------------------------------------------------------

# JAX's collective kinds (``_COLLECTIVES`` of its roofline)
KINDS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
         "collective-permute")
# the kind of each functional collective; another (a broadcast) is counted
# under its own name
COLLECTIVES = {"all_gather_into_tensor": "all-gather",
               "all_gather_into_tensor_coalesced": "all-gather",
               "all_reduce": "all-reduce",
               "all_reduce_coalesced": "all-reduce",
               "reduce_scatter_tensor": "reduce-scatter",
               "reduce_scatter_tensor_coalesced": "reduce-scatter",
               "all_to_all_single": "all-to-all"}
PRODUCTS = ("mm", "bmm", "addmm", "baddbmm")


def _tensors(x):
    import torch
    if isinstance(x, torch.Tensor):
        yield x
    elif isinstance(x, (list, tuple)):
        for a in x:
            yield from _tensors(a)


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


# the port's own plumbing, never a collective's site
_PLUMBING = ("core/roofline.py", "parallel/sharding.py")
_FRAME = re.compile(r'File "([^"]+)", line (\d+), in (\S+)')


def call_site() -> str:
    """Where the running op was asked for: the innermost frame of the
    port's model code (``path:line function``, the path from the package's
    root), outside :mod:`~repro_torch.parallel.sharding` and this module,
    then the sharding helper it went through, if any (``< shard``). In a
    backward, ``grad of`` the forward's site, from the autograd node's
    traceback (kept only under anomaly mode; without it, the site that
    called ``backward``)."""
    import sys

    import torch
    frames = []                          # (path, line, function), innermost
    node = torch._C._current_autograd_node()
    tb = node.metadata.get("traceback_") if node is not None else None
    if tb:
        frames = [(m.group(1), int(m.group(2)), m.group(3)) for m in
                  map(_FRAME.search, reversed(tb)) if m]
    else:
        f = sys._getframe(1)
        while f is not None:
            frames.append((f.f_code.co_filename, f.f_lineno,
                           f.f_code.co_name))
            f = f.f_back
    helper = ""
    for path, line, fn in frames:
        path = path.replace("\\", "/")
        if "/repro_torch/" not in path:
            continue
        rel = path.rsplit("/repro_torch/", 1)[1]
        if rel in _PLUMBING:
            if rel == "parallel/sharding.py":
                helper = fn              # the outermost: the one called
            continue
        site = f"{rel}:{line} {fn}" + (f" < {helper}" if helper else "")
        return ("grad of " if tb else "") + site
    return "?"


class TraceCounter:
    """A dispatch mode counting what one rank runs, op by op:

    * ``ops``: products (``mm``, ``addmm``, ``bmm``, ``baddbmm``: 2 x M x
      K x N, batches too) by the first operand's dtype: forward, remat
      recompute and backward alike;
    * ``bytes``: each other op's tensor arguments read once and results
      written once (views, ``empty``, the collectives and ops returning
      no tensor move nothing): the traffic of the unfused eager step;
    * ``coll`` / ``coll_count``: each functional collective's operand
      bytes and calls, by JAX's kind names (:data:`KINDS`,
      :data:`COLLECTIVES`);
    * ``peak``: the high-water mark of live bytes, a storage counted from
      the op that makes it until its last tensor dies, plus what
      :meth:`track` registered as live before the run (the arguments);
    * ``sites`` (with ``sites=True``): each collective's bytes by kind
      under the model code that issued it (:func:`call_site`); a
      backward's collective under its forward's site, read from the
      autograd node's traceback, so run the step under
      ``torch.autograd.detect_anomaly(check_nan=False)``.

    On a DTensor the mode steps aside (returns ``NotImplemented``), so it
    sees the rank's local tensors and the collectives a redistribute
    issues: per-device numbers."""

    def __init__(self, sites: bool = False):
        from torch.utils._python_dispatch import TorchDispatchMode
        counter = self

        class _Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                return counter._dispatch(func, types, args, kwargs or {})

        self._mode = _Mode()
        self.ops: Dict[str, int] = {}
        self.bytes = 0
        self.coll: Dict[str, int] = dict.fromkeys(KINDS, 0)
        self.coll_count: Dict[str, int] = dict.fromkeys(KINDS, 0)
        self.live = 0
        self.peak = 0
        self.paused = False      # ops run, uncounted (DTensor's own probes)
        self.sites: Optional[Dict[str, Dict[str, int]]] = {} if sites \
            else None
        self._seen = set()

    def __enter__(self):
        self._mode.__enter__()
        return self

    def __exit__(self, *exc):
        return self._mode.__exit__(*exc)

    def track(self, tensors) -> None:
        """Count ``tensors`` (local tensors of the run's arguments) as
        live from now on."""
        for t in tensors:
            self._alloc(t)

    def _alloc(self, t) -> None:
        st = t.untyped_storage()
        key = st._cdata
        if key in self._seen:
            return
        n = st.nbytes()
        self._seen.add(key)
        self.live += n
        self.peak = max(self.peak, self.live)
        weakref.finalize(st, self._free, key, n)

    def _free(self, key, n) -> None:
        self._seen.discard(key)
        self.live -= n

    def _dispatch(self, func, types, args, kwargs):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if self.paused:
            return out
        name = func.overloadpacket.__name__
        if func.namespace in ("_c10d_functional", "c10d_functional"):
            if name != "wait_tensor":
                kind = COLLECTIVES.get(name, name)
                n = sum(_nbytes(t) for t in _tensors(args[0]))
                self.coll[kind] = self.coll.get(kind, 0) + n
                self.coll_count[kind] = self.coll_count.get(kind, 0) + 1
                if self.sites is not None:
                    at = self.sites.setdefault(call_site(), {})
                    at[kind] = at.get(kind, 0) + n
            return out
        if name in PRODUCTS:
            a = args[1] if name in ("addmm", "baddbmm") else args[0]
            dt = str(a.dtype).removeprefix("torch.")
            self.ops[dt] = self.ops.get(dt, 0) + 2 * a.numel() * \
                out.shape[-1]
        results = list(_tensors(out))
        if func.is_view or name.startswith("empty") or not results:
            return out
        self.bytes += sum(_nbytes(t) for t in _tensors(list(args)
                                                       + list(kwargs.values())))
        self.bytes += sum(_nbytes(t) for t in results)
        for t in results:
            self._alloc(t)
        return out


@dataclasses.dataclass
class RooflineReport:
    """JAX's report, with the card's rates (``profile``, default
    :data:`H100`) and :data:`NVLINK_BW`."""
    arch: str
    shape: str
    mesh: str
    chips: int
    flops_per_device: float
    bytes_per_device: float
    collective_bytes_per_device: float
    coll_breakdown: Dict[str, int]
    peak_memory_per_device: float
    model_flops: float                     # 6·N·D or serving equivalent

    @property
    def t_compute(self) -> float:
        return self.flops_per_device / H100.peak_ops("bfloat16")

    @property
    def t_memory(self) -> float:
        return self.bytes_per_device / H100.hbm_bw

    @property
    def t_collective(self) -> float:
        return self.collective_bytes_per_device / NVLINK_BW

    @property
    def bottleneck(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def t_bound(self) -> float:
        return max(self.t_compute, self.t_memory, self.t_collective)

    @property
    def useful_flops_ratio(self) -> float:
        global_flops = self.flops_per_device * self.chips
        return self.model_flops / global_flops if global_flops else 0.0

    @property
    def roofline_fraction(self) -> float:
        """Fraction of the compute roofline achieved at the bound:
        useful-FLOPs time / bound time."""
        t_useful = self.model_flops / (self.chips * H100.peak_ops("bfloat16"))
        return t_useful / self.t_bound if self.t_bound else 0.0

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d.update(t_compute=self.t_compute, t_memory=self.t_memory,
                 t_collective=self.t_collective, bottleneck=self.bottleneck,
                 useful_flops_ratio=self.useful_flops_ratio,
                 roofline_fraction=self.roofline_fraction)
        return d


def analyze_trace(counter: TraceCounter, *, arch: str, shape: str,
                  mesh_name: str, chips: int,
                  model_flops: float) -> RooflineReport:
    """The report of one rank's trace (JAX's ``analyze_compiled``):
    products of every dtype, the eager step's bytes, the collectives'
    operand bytes and the live-bytes peak, all a device."""
    return RooflineReport(
        arch=arch, shape=shape, mesh=mesh_name, chips=chips,
        flops_per_device=float(sum(counter.ops.values())),
        bytes_per_device=float(counter.bytes),
        collective_bytes_per_device=float(sum(counter.coll.values())),
        coll_breakdown=dict(counter.coll),
        peak_memory_per_device=float(counter.peak),
        model_flops=model_flops)
