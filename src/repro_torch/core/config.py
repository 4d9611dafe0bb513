"""Configuration for the PyTorch port.

A copy of the JAX package's ``core/config.py``, in two halves:

* :class:`ModelConfig`, the LM-family architectures, with ``smoke()``,
  cut to the fields the attention slice reads. The other fields and the
  analytic parameter counts wait for the LM model (``models/lm.py``,
  ROADMAP.md Queue 1 slice 8).
* The paper's CNNs: the layer record, the fusion grouping, the
  architecture config and the FLOP count. The runtime knobs the JAX
  ``CNNConfig`` also carries (tiling, placement, serving) live only in
  :class:`repro_torch.pipeline.ExecutionSpec` here.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import List, Sequence, Tuple

LAYER_KINDS = ("conv", "pool", "lrn", "fc")
FAMILIES = ("dense", "moe", "ssm", "hybrid", "vlm", "audio")


class SpecError(ValueError):
    """A config/spec field failed validation.

    ``.field`` carries the dotted name of the offending knob (for example
    ``"Precision.quant"``), with the same names the JAX package uses.
    """

    def __init__(self, field: str, message: str):
        self.field = field
        super().__init__(message)


@dataclass(frozen=True)
class ModelConfig:
    """The LM-family architecture record, cut to the fields the attention
    slice reads. The JAX config's MoE, SSM, xLSTM, frontend, memory and
    technique fields come with the LM model that reads them (ROADMAP.md
    Queue 1 slice 8); the fields kept here carry the JAX names and
    defaults."""

    name: str
    family: str                       # one of FAMILIES
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int                         # dense FFN width (0 => no FFN, e.g. xLSTM)
    vocab: int

    # --- attention details ---
    d_head: int = 0                   # 0 => d_model // n_heads
    qk_norm: bool = False             # RMSNorm on q/k per head (Qwen3)
    rope_theta: float = 1e6
    norm_eps: float = 1e-6

    dtype: str = "bfloat16"           # activation/param compute dtype
    attention_impl: str = "chunked"   # "chunked" (online-softmax) | "naive"
    attn_chunk: int = 1024            # KV chunk for chunked attention

    def __post_init__(self):
        if self.family not in FAMILIES:
            raise ValueError(f"unknown family {self.family!r}")
        if self.d_head == 0 and self.n_heads:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)

    # -- smoke-test reduction -------------------------------------------------
    def smoke(self) -> "ModelConfig":
        """A tiny config of the same family for CPU smoke tests."""
        nh = min(self.n_heads, 4) or 4
        nkv = max(1, min(self.n_kv_heads, 2))
        if self.n_kv_heads == self.n_heads:   # MHA stays MHA
            nkv = nh
        return replace(
            self,
            n_layers=4 if self.family == "ssm" else 2,
            d_model=64,
            n_heads=nh,
            n_kv_heads=nkv,
            d_head=16,
            d_ff=0 if self.d_ff == 0 else 128,
            vocab=512,
            attn_chunk=16,
            dtype="float32",
        )


@dataclass(frozen=True)
class ConvLayer:
    kind: str                         # "conv" | "pool" | "lrn" | "fc"
    out_ch: int = 0
    kernel: int = 0
    stride: int = 1
    pad: int = 0
    groups: int = 1                   # AlexNet conv2/4/5 use groups=2
    pool: str = "max"                 # for kind == "pool": "max" | "avg"
    relu: bool = True


def fuse_groups(layers: Sequence[ConvLayer]) -> List[Tuple[int, ...]]:
    """Group layer indices into PipeCNN pipeline stages.

    conv immediately followed by pool -> one fused conv(+pool) launch;
    lrn, a standalone pool and fc each form their own group.
    """
    plan: List[Tuple[int, ...]] = []
    i = 0
    while i < len(layers):
        if (layers[i].kind == "conv" and i + 1 < len(layers)
                and layers[i + 1].kind == "pool"):
            plan.append((i, i + 1))
            i += 2
        else:
            plan.append((i,))
            i += 1
    return plan


@dataclass(frozen=True)
class CNNConfig:
    name: str
    input_hw: int
    input_ch: int
    n_classes: int
    layers: Tuple[ConvLayer, ...]
    use_lrn: bool = False

    def __post_init__(self):
        for i, l in enumerate(self.layers):
            if l.kind not in LAYER_KINDS:
                raise SpecError(
                    "CNNConfig.layers",
                    f"layer {i} of {self.name!r} has kind {l.kind!r}: "
                    f"expected one of {LAYER_KINDS}")

    @property
    def n_fuse_groups(self) -> int:
        return len(fuse_groups(self.layers))

    def smoke(self) -> "CNNConfig":
        """Shrink channel counts for CPU tests (same topology)."""
        def shrink(l: ConvLayer) -> ConvLayer:
            return replace(l, out_ch=max(8, l.out_ch // 16) if l.out_ch else 0)
        return replace(self, layers=tuple(shrink(l) for l in self.layers),
                       n_classes=16, input_hw=min(self.input_hw, 67))


def flops_per_image(cfg: CNNConfig) -> int:
    """Multiply-accumulate op count (2 ops per MAC), as GOPS in the paper."""
    h = w = cfg.input_hw
    c = cfg.input_ch
    total = 0
    for l in cfg.layers:
        if l.kind == "conv":
            h = (h + 2 * l.pad - l.kernel) // l.stride + 1
            w = (w + 2 * l.pad - l.kernel) // l.stride + 1
            total += 2 * h * w * l.out_ch * l.kernel * l.kernel \
                * (c // l.groups)
            c = l.out_ch
        elif l.kind == "pool":
            h = (h - l.kernel) // l.stride + 1
            w = (w - l.kernel) // l.stride + 1
        elif l.kind == "fc":
            total += 2 * c * h * w * l.out_ch
            h = w = 1
            c = l.out_ch
    return total
