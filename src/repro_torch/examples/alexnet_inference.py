"""The paper's own scenario: batched AlexNet image classification through
the PipeCNN pipeline (``compile_cnn(...).forward``).

Mirrors the paper's measurement: ms/image (batch 16 by default, the
paper's Fig. 8 batch) and GOPS, beside the paper's FPGA figure, plus the
fused-vs-unfused traffic model (``core/pipeline.py``) for this exact run.

Run:  PYTHONPATH=src python -m repro_torch.examples.alexnet_inference
      [--full] [--batch 16] [--device cpu]
      (--full is the real 227x227x(96..384ch) network)
"""
from __future__ import annotations

import argparse
import sys
import time

import torch

from repro_torch.configs import get_config
from repro_torch.core.pipeline import fusion_savings
from repro_torch.data.pipeline import image_batches
from repro_torch.examples import _common
from repro_torch.models.cnn import classification_flops, init_cnn_params
from repro_torch.pipeline import ExecutionSpec, Serving, compile_cnn
from repro_torch.pipeline.compile import resolve_device

TIMED_FORWARDS = 50             # after one untimed forward
# the paper's figure on its Altera Stratix-V FPGA, not the port's
PAPER_FPGA_MS, PAPER_FPGA_GOPS = 43.0, 33.9


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples."
                                      "alexnet_inference",
                                 description=__doc__)
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--batch", type=int, default=16)
    _common.add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config("alexnet") if args.full else get_config("alexnet").smoke()
    params = init_cnn_params(cfg, generator=torch.Generator(dev).manual_seed(0),
                             device=dev)
    stream = image_batches(args.batch, cfg.input_hw, cfg.input_ch, 1000)
    compiled = compile_cnn(cfg, ExecutionSpec(
        serving=Serving(batch=args.batch)), params, device=dev)

    # the batches are drawn and copied to the device before the clock
    # starts: the host's numpy draw would otherwise take most of the time
    batches = [torch.from_numpy(next(stream)["images"]).to(dev)
               for _ in range(1 + TIMED_FORWARDS)]
    compiled.forward(batches[0])                # the untimed forward
    _common.sync(dev)

    def forwards():                             # the last batch's preds
        return [compiled.forward(x).argmax(-1) for x in batches[1:]][-1]

    if dev.type == "cuda":                      # the card's own clock
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        start.record()
        preds = forwards()
        end.record()
        end.synchronize()
        dt, clock = start.elapsed_time(end) / 1e3, "CUDA events"
    else:
        # repro: allow[RPA102] the example's ms/image readout on the host
        t0 = time.perf_counter()
        preds = forwards()
        # repro: allow[RPA102] the example's ms/image readout on the host
        dt, clock = time.perf_counter() - t0, "host wall clock"
    dt /= TIMED_FORWARDS * args.batch

    ops = classification_flops(cfg)
    unf, fus, red = fusion_savings(cfg, batch=args.batch)
    print(f"AlexNet ({'full' if args.full else 'smoke'}), batch "
          f"{args.batch}: {dt * 1e3:.3f} ms/image, {ops / dt / 1e9:.2f} "
          f"GOPS ({clock} over {TIMED_FORWARDS} forwards of "
          f"batches already on the device, "
          f"{preds.numel()} predictions each) on {_common.where(dev)}")
    print(f"the paper's FPGA figure (Altera Stratix-V, full AlexNet; not "
          f"this port's): {PAPER_FPGA_MS} ms/image, {PAPER_FPGA_GOPS} GOPS")
    print(f"operations an image: {ops}")
    print(f"pipeline traffic at batch {args.batch}: fused {fus} B vs "
          f"unfused {unf} B ({red:.1%} saved)")
    print(f"plans in use: {compiled.plan_table.summary()} "
          f"(each conv group's tile, each fc group's split)")
    print(f"forwards: {1 + TIMED_FORWARDS}")
    print("alexnet_inference OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
