"""The card's roofline: peak rates, memory rate and the per-kernel terms.

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
"""
from __future__ import annotations

import functools
from dataclasses import dataclass, replace
from typing import Dict, Optional, Tuple

__all__ = ["DeviceProfile", "H100", "MEM_BW", "device_profile",
           "pipeline_bubble_fraction", "profile_for", "time_bounds"]

# published device-memory rates (bytes/s, NVIDIA data sheets), by a part of
# the name the card reports
MEM_BW = {"H100 80GB HBM3": 3.35e12, "H100 PCIe": 2.0e12,
          "H100 NVL": 3.9e12, "H200": 4.8e12}


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
