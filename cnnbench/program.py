"""The system under test, as the benchmark reaches it: the port's
``compile_cnn`` and the ``CompiledCNN`` it returns, its kernel build, and
the kernels' names. The one module of the benchmark that imports the
program (``repro_torch``, from ``src/``).
"""
from __future__ import annotations

import dataclasses
import time
from typing import List

import numpy as np
import torch

from cnnbench.config import layers


def port_config(cfg: dict):
    """The program's ``CNNConfig`` of a configuration file. A layer's
    ``input`` and ``residual`` are passed only where the layer has them;
    a key the program's ``ConvLayer`` has no field for raises."""
    from repro_torch.core.config import CNNConfig, ConvLayer
    have = {f.name for f in dataclasses.fields(ConvLayer)}
    for l in layers(cfg):
        missing = sorted(set(l) - have)
        if missing:
            raise TypeError(f"cnnbench: the program's ConvLayer has no "
                            f"field {missing[0]!r}")
    return CNNConfig(
        name=cfg["name"], input_hw=cfg["input_hw"],
        input_ch=cfg["input_ch"], n_classes=cfg["n_classes"],
        use_lrn=any(l["kind"] == "lrn" for l in cfg["layers"]),
        layers=tuple(ConvLayer(**l) for l in layers(cfg)))


def compile_model(cfg: dict, params, batch: int, device, calib=None):
    """``compile_cnn`` at the configuration's precision and ``batch``;
    returns ``(compiled, seconds)`` on the host clock, calibration
    included. A fixed-point configuration calibrates on ``calib``."""
    from repro_torch.pipeline import (ExecutionSpec, Precision, Serving,
                                      compile_cnn)
    p = cfg["precision"]
    spec = ExecutionSpec(
        precision=Precision(dtype=p["dtype"], quant=p.get("quant", "none"),
                            calib=p.get("calib_images", 8)),
        serving=Serving(batch=batch))
    arg = (params, calib) if p.get("quant", "none") != "none" else params
    t0 = time.perf_counter()
    compiled = compile_cnn(port_config(cfg), spec, arg, device=device)
    if compiled.device.type == "cuda":
        torch.cuda.synchronize(compiled.device)
    return compiled, time.perf_counter() - t0


def requests(pool: np.ndarray, idx: np.ndarray, rids) -> List:
    """Requests for pool images ``idx``, all due now: the benchmark keeps
    the schedule itself, so the engine's own clock starts at each call."""
    from repro_torch.serve.router import Request
    return [Request(rid=int(r), image=pool[i], t_arrival=0.0)
            for r, i in zip(rids, idx)]


def build_kernels() -> None:
    """Build (or find built) the kernel libraries: the first run in a
    checkout compiles them here, inside set-up."""
    from repro_torch.kernels import build
    build.build_all()


# the three kernels of the port's CNN path, by the name each CUDA kernel
# function carries in a device trace
KERNEL_CLASSES = (("conv_pipe", ("conv_f32_kernel", "conv_bf16_mma_kernel",
                                 "conv_s8_mma_kernel")),
                  ("matmul_pipe", ("matmul_f32_kernel", "matmul_bf16_kernel",
                                   "matmul_s8_kernel")),
                  ("lrn_pwl", ("lrn_pwl_kernel", "lrn_pwl_vec_kernel")))


def kernel_class(name: str) -> str:
    """``conv_pipe``, ``matmul_pipe``, ``lrn_pwl`` or ``other``."""
    for cls, fns in KERNEL_CLASSES:
        if any(f"{fn}<" in name or name.endswith(fn) for fn in fns):
            return cls
    return "other"
