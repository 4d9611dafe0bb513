"""End-to-end driver (the paper is an inference accelerator, so the
end-to-end scenario is serving): batched request serving over the LM
stack or, for a CNN ``--arch``, over the paper's own batch-pipelined CNN
path.

* batched prefill (PipeCNN's batched-FC weight reuse at serving scale),
* batched greedy decode step by step with the KV/state cache,
* token throughput a phase, on the device it names,
* any ``--arch``: transformer / MoE / SSM / hybrid smoke configs, and the
  CNN configs (alexnet, vgg16), which go through ``compile_cnn(...)
  .serve`` (requests padded to the plan batch, batched-FC classifier).

Run:  PYTHONPATH=src python -m repro_torch.examples.serve_batched \\
          --arch zamba2-1.2b --batch 8 --prompt-len 64 --gen 32
      PYTHONPATH=src python -m repro_torch.examples.serve_batched \\
          --arch alexnet --batch 8          [--device cpu]
"""
from __future__ import annotations

import argparse
import dataclasses
import sys
import time

import torch

from repro_torch.configs import get_config
from repro_torch.core.config import CNNConfig
from repro_torch.examples import _common
from repro_torch.models import lm
from repro_torch.pipeline.compile import resolve_device
from repro_torch.train.steps import serve_decode, serve_prefill


def _serve_cnn(cfg, args, dev, g) -> int:
    """Compile once, then drain synthetic requests through the batched
    conv pipeline."""
    from repro_torch.launch.serve_cnn import (default_request_count,
                                              synthetic_requests)
    from repro_torch.models.cnn import init_cnn_params
    from repro_torch.pipeline import ExecutionSpec, Serving, compile_cnn

    params = init_cnn_params(cfg, generator=g, device=dev)
    n_req = default_request_count(args.batch)
    reqs = synthetic_requests(n_req, cfg.input_hw, cfg.input_ch, rate=200.0)
    compiled = compile_cnn(cfg, ExecutionSpec(
        serving=Serving(batch=args.batch)), params, device=dev)
    rep = compiled.serve(reqs)
    assert len(rep.completions) == n_req
    assert all(c.status == "ok" for c in rep.completions)
    print(f"arch={args.arch} (CNN smoke scale, batched conv pipeline)")
    print(f"served {n_req} requests @ micro-batch {args.batch}: "
          f"{rep.throughput:.0f} img/s, p50 {rep.p50_ms:.1f} ms, "
          f"p95 {rep.p95_ms:.1f} ms (measured clock) on "
          f"{_common.where(dev)}")
    print("serve_batched OK")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples."
                                      "serve_batched", description=__doc__)
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=64)
    ap.add_argument("--gen", type=int, default=32)
    _common.add_device_arg(ap)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    g = torch.Generator(dev).manual_seed(0)

    cfg = get_config(args.arch).smoke()
    if isinstance(cfg, CNNConfig):
        return _serve_cnn(cfg, args, dev, g)
    if cfg.frontend:            # vlm/audio: the frontend is stubbed
        cfg = dataclasses.replace(cfg, frontend=None, frontend_len=0)

    params = lm.init_params(cfg, g, dev)
    s_max = args.prompt_len + args.gen + 8
    # batched requests (a different prompt a row)
    prompts = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                            generator=g, device=dev)
    with torch.no_grad():
        _common.sync(dev)
        # repro: allow[RPA102] the example's tok/s readout
        t0 = time.perf_counter()
        ids, _, cache = serve_prefill(params, {"tokens": prompts}, cfg,
                                      s_max)
        _common.sync(dev)
        # repro: allow[RPA102] the example's tok/s readout
        t_prefill = time.perf_counter() - t0
        outs = [ids]
        # repro: allow[RPA102] the example's tok/s readout
        t0 = time.perf_counter()
        for _ in range(args.gen - 1):
            ids, _, cache = serve_decode(params, ids, cache, cfg)
            outs.append(ids)
        _common.sync(dev)
        # repro: allow[RPA102] the example's tok/s readout
        t_decode = time.perf_counter() - t0

    gen = torch.cat(outs, dim=1)
    ptoks = args.batch * args.prompt_len
    dtoks = args.batch * (args.gen - 1)
    where = _common.where(dev)
    print(f"arch={args.arch} family={cfg.family} (smoke scale)")
    print(f"prefill: {ptoks} tokens in {t_prefill:.2f}s "
          f"({ptoks / t_prefill:.0f} tok/s) on {where}")
    print(f"decode : {dtoks} tokens in {t_decode:.2f}s "
          f"({dtoks / max(t_decode, 1e-9):.0f} tok/s) on {where}")
    print(f"sample continuation: {gen[0, :12].tolist()} ...")
    assert int(cache.pos) == args.prompt_len + args.gen - 1
    assert gen.shape == (args.batch, args.gen)
    print("serve_batched OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
