"""Fixed-point (int8) inference of the port -- the paper's precision trade.

A copy of the JAX package's ``quant`` package:

* :mod:`.core` -- symmetric quantize / dequantize / fake-quant, and the
  block-granular variants of the gradient compression;
* :mod:`.observers` -- calibration range observers;
* :mod:`.calibrate` -- activation calibration + per-channel weight
  quantization -> :class:`QuantizedCNNParams`;
* :mod:`.ref` -- the exact-int32 and fake-quant references, the plain
  versions of the int8 modes of ``conv_pipe`` and ``matmul_pipe``.
"""
from repro_torch.quant.calibrate import (QuantizedCNNParams, QuantLayer,
                                         calibrate_cnn, group_forward_ref,
                                         qparams_from_jax)
from repro_torch.quant.core import (QMAX, abs_max_scale, dequantize,
                                    dequantize_blocks, fake_quant, quantize,
                                    quantize_blocks, quantize_channelwise)
from repro_torch.quant.observers import (AbsMaxObserver,
                                         MovingAverageAbsMaxObserver,
                                         make_observer)

__all__ = [
    "QMAX", "AbsMaxObserver", "MovingAverageAbsMaxObserver", "QuantLayer",
    "QuantizedCNNParams", "abs_max_scale", "calibrate_cnn", "dequantize",
    "dequantize_blocks", "fake_quant", "group_forward_ref", "make_observer",
    "qparams_from_jax", "quantize", "quantize_blocks", "quantize_channelwise",
]
