"""CNN serving launcher of the port — a thin CLI over ``compile_cnn``.

    PYTHONPATH=src python -m repro_torch.launch.serve_cnn --arch alexnet \\
        [--smoke] [--batch 8] [--requests N] [--rate 200] [--device cpu] \\
        [--quant int8 [--calib 8]]

Compiles the model once (random weights from ``--seed``; with
``--quant int8`` calibrated on ``--calib`` synthetic images and served by
the int8 kernel pipeline), serves a synthetic request stream
(exponential inter-arrival times) on the measured clock, and prints the
report. Runs on the CUDA device unless ``--device`` says otherwise.
"""
from __future__ import annotations

import argparse
from typing import List

import numpy as np
import torch

from repro_torch.configs import CNN_IDS, get_config
from repro_torch.core.config import flops_per_image
from repro_torch.pipeline import (ExecutionSpec, Precision, Serving,
                                  compile_cnn)
from repro_torch.serve import Request, latency_report


def synthetic_requests(n: int, hw: int, ch: int, rate: float,
                       seed: int = 0) -> List[Request]:
    """n requests with exponential inter-arrival times (mean 1/rate s) and
    standard-normal images; the same stream as the JAX launcher's for the
    same seed."""
    rng = np.random.default_rng(seed)
    t = 0.0
    out = []
    for i in range(n):
        t += rng.exponential(1.0 / rate)
        out.append(Request(rid=i, t_arrival=t,
                           image=rng.standard_normal(
                               (hw, hw, ch)).astype(np.float32)))
    return out


def default_request_count(batch: int, replicas: int = 1) -> int:
    """Two full micro-batches per replica plus a non-dividing remainder,
    so every run exercises the pad-to-plan path."""
    return 2 * batch * replicas + 3


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="alexnet", choices=CNN_IDS)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced channel counts and input (CPU-friendly)")
    ap.add_argument("--batch", type=int, default=8,
                    help="micro-batch the queue pads requests to")
    ap.add_argument("--requests", type=int, default=0,
                    help="synthetic requests (default 2*batch + 3)")
    ap.add_argument("--rate", type=float, default=200.0,
                    help="request arrival rate (req/s)")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weights and of the request stream")
    ap.add_argument("--quant", choices=("none", "int8"), default="none",
                    help="serve in fixed-point: calibrate on a synthetic "
                         "batch, then run the int8 kernel pipeline")
    ap.add_argument("--calib", type=int, default=8,
                    help="calibration images for --quant int8")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    n_req = args.requests or default_request_count(args.batch)
    compiled = compile_cnn(cfg, ExecutionSpec(
        precision=Precision(quant=args.quant, calib=args.calib),
        serving=Serving(batch=args.batch)),
        generator=torch.Generator().manual_seed(args.seed),
        device=args.device)
    requests = synthetic_requests(n_req, cfg.input_hw, cfg.input_ch,
                                  args.rate, seed=args.seed)
    rep = compiled.serve(requests)
    if len(rep.completions) + rep.n_rejected != n_req:
        raise SystemExit(f"{n_req} requests but {len(rep.completions)} "
                         f"completions and {rep.n_rejected} rejections")
    gops = flops_per_image(cfg) * rep.throughput / 1e9
    print(f"[serve_cnn] {args.arch}{' (smoke)' if args.smoke else ''}: "
          f"{n_req} requests @ micro-batch {args.batch} on "
          f"{compiled.device}{', int8' if compiled.quant else ''}")
    if compiled.quant:
        qp = compiled.params
        n_conv = sum(1 for l in qp.layers
                     if l is not None and l.kind == "conv")
        print(f"[serve_cnn] int8 calibration: {args.calib} images, "
              f"{n_conv} conv layers quantized (per-channel weights, "
              f"per-tensor activations); input scale {qp.in_scale:.3g}")
    print(f"[serve_cnn] {rep.summary()}")
    print(f"[serve_cnn] latency_report {latency_report(rep.completions)}")
    print(f"[serve_cnn] {gops:.2f} GOPS at the reported throughput")


if __name__ == "__main__":
    main()
