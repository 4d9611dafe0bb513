"""Configuration for the PyTorch port.

A copy of the JAX package's ``core/config.py``, in two halves:

* :class:`ModelConfig`, the LM-family architectures, with ``smoke()``,
  the analytic parameter counts, and the assigned input shapes
  (:data:`SHAPES`).
* The paper's CNNs: the layer record, the fusion grouping, the
  architecture config and the FLOP count. The runtime knobs the JAX
  ``CNNConfig`` also carries (tiling, placement, serving) live only in
  :class:`repro_torch.pipeline.ExecutionSpec` here.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import List, Optional, Sequence, Tuple

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
    """Unified configuration for every supported LM-family architecture:
    the JAX record field for field, with its names and defaults. The
    serving path reads the architecture, MoE, SSM, hybrid, xLSTM and
    frontend fields, ``dtype``, ``attention_impl`` and ``attn_chunk``;
    ``opt_state_dtype`` and ``remat*`` are for training, ``use_pallas``
    is read by no LM module (as in JAX) and ``scan_layers`` means nothing
    to the port's Python loops. They are carried so that the configs
    compare equal to JAX's."""

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

    # --- MoE ---
    n_experts: int = 0
    top_k: int = 0
    moe_dense_residual: bool = False  # Arctic: dense FFN in parallel with MoE
    # dispatch groups: expert capacity is enforced per group of tokens
    moe_groups: int = 1

    # --- SSM (Mamba2) ---
    ssm_state: int = 0                # d_state
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_chunk: int = 128              # chunk length for the chunked scan
    ssm_conv_width: int = 4

    # --- hybrid (Zamba2): shared attention block applied every k SSM blocks
    attn_every: int = 0               # 0 => no interleaved attention

    # --- xLSTM: alternate mLSTM / sLSTM blocks (1:1)
    xlstm_slstm_every: int = 2        # every 2nd block is an sLSTM

    # --- modality frontend stubs (backbone only) ---
    frontend: Optional[str] = None    # "patch_embed" (vlm) | "frame_embed" (audio)
    frontend_len: int = 0             # number of precomputed embedding positions

    # --- numerics / memory ---
    dtype: str = "bfloat16"           # activation/param compute dtype
    opt_state_dtype: str = "float32"  # AdamW m/v dtype (bf16 for very large models)
    remat: bool = True                # activation checkpointing over blocks
    remat_policy: str = "full"        # "full" | "dots" (save dot outputs)

    # --- technique flags ---
    use_pallas: bool = False          # the JAX package's kernel flag
    fused_block: bool = True          # PipeCNN-style stage fusion inside blocks
    attention_impl: str = "chunked"   # "chunked" (online-softmax) | "naive"
    attn_chunk: int = 1024            # KV chunk for chunked attention
    scan_layers: bool = True          # the JAX package's scan-or-unroll flag

    def __post_init__(self):
        if self.family not in FAMILIES:
            raise ValueError(f"unknown family {self.family!r}")
        if self.d_head == 0 and self.n_heads:
            object.__setattr__(self, "d_head", self.d_model // self.n_heads)

    # -- derived quantities -------------------------------------------------
    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def is_ssm(self) -> bool:
        return self.family in ("ssm", "hybrid")

    @property
    def ssm_d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return max(1, self.ssm_d_inner // self.ssm_headdim)

    def supports_long_context(self) -> bool:
        """Sub-quadratic sequence mixing => can run the 500k decode shape."""
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Analytic parameter count (matches init_params)."""
        from repro_torch.models.lm import count_params  # avoid a cycle
        return count_params(self)

    def active_param_count(self) -> int:
        """Params touched per token (MoE: only top_k experts)."""
        from repro_torch.models.lm import count_params
        return count_params(self, active_only=True)

    # -- smoke-test reduction -------------------------------------------------
    def smoke(self) -> "ModelConfig":
        """A tiny config of the same family for CPU smoke tests."""
        nh = min(self.n_heads, 4) or 4
        nkv = max(1, min(self.n_kv_heads, 2))
        if self.n_kv_heads == self.n_heads:   # MHA stays MHA
            nkv = nh
        n_layers = 4 if self.attn_every or self.family == "ssm" else 2
        return replace(
            self,
            n_layers=n_layers,
            d_model=64,
            n_heads=nh,
            n_kv_heads=nkv,
            d_head=16,
            d_ff=0 if self.d_ff == 0 else 128,
            vocab=512,
            n_experts=min(self.n_experts, 4),
            top_k=min(self.top_k, 2),
            ssm_state=min(self.ssm_state, 16) if self.ssm_state else 0,
            ssm_headdim=16,
            ssm_chunk=8,
            attn_every=2 if self.attn_every else 0,
            frontend_len=8 if self.frontend_len else 0,
            attn_chunk=16,
            dtype="float32",
            remat=False,
        )


# ---------------------------------------------------------------------------
# Input-shape specifications (the assigned shapes)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str                          # "train" | "prefill" | "decode"

    @property
    def tokens(self) -> int:
        return self.seq_len * self.global_batch


SHAPES: Tuple[ShapeSpec, ...] = (
    ShapeSpec("train_4k", 4_096, 256, "train"),
    ShapeSpec("prefill_32k", 32_768, 32, "prefill"),
    ShapeSpec("decode_32k", 32_768, 128, "decode"),
    ShapeSpec("long_500k", 524_288, 1, "decode"),
)


def get_shape(name: str) -> ShapeSpec:
    for s in SHAPES:
        if s.name == name:
            return s
    raise KeyError(name)


def applicable_shapes(cfg: ModelConfig) -> Tuple[ShapeSpec, ...]:
    """The shapes this architecture runs (long_500k only for sub-quadratic)."""
    return tuple(s for s in SHAPES
                 if s.name != "long_500k" or cfg.supports_long_context())


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
