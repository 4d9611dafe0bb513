"""int8 error-feedback gradient compression: a copy of the JAX package's
``optim/compress.py``.

Each gradient leaf, plus the residual carried from the step before, is
quantized per ``BLOCK``-element block to symmetric int8 with one fp32
scale (``quant.core.quantize_blocks``) and dequantized; what the
quantization lost is the new residual, added back next step.
``compressed_bytes`` is the payload a pod-crossing all-reduce of the
codes and scales would move. :class:`repro_torch.train.loop.ResilientLoop`
carries the residual from step to step, as this scheme says.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from repro_torch.models.lm import tree_leaves, tree_map
from repro_torch.quant.core import dequantize_blocks, quantize_blocks

BLOCK = 2048


class CompressionState(NamedTuple):
    error: Any            # tree like grads: error-feedback residual (fp32)


def init_compression(grads_like) -> CompressionState:
    return CompressionState(tree_map(
        lambda g: torch.zeros(g.shape, dtype=torch.float32, device=g.device),
        grads_like))


@torch.no_grad()
def compress_grads(grads, state: CompressionState
                   ) -> Tuple[Any, CompressionState]:
    """Returns (quantize-dequantized grads, new error state)."""
    def one(g, e):
        gf = g.float() + e
        q, s = quantize_blocks(gf, BLOCK)
        deq = dequantize_blocks(q, s, g.shape)
        return deq.to(g.dtype), gf - deq

    pairs = tree_map(one, grads, state.error)
    return (tree_map(lambda t: t[0], pairs),
            CompressionState(tree_map(lambda t: t[1], pairs)))


def compressed_bytes(grads) -> int:
    """Payload size if the pod-crossing all-reduce moved int8+scales."""
    total = 0
    for _, g in tree_leaves(grads):
        n = g.numel()
        total += n + 4 * (-(-n // BLOCK))             # int8 + fp32 scale
    return total
