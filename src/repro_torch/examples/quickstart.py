"""Quickstart: the two faces of the port in about a minute.

1. The paper's CNN pipeline through the compile-once API
   (``repro_torch.pipeline``): one ``compile_cnn(cfg, spec, params)``
   resolves precision, kernel plans and placement into a ``CompiledCNN``;
   the run phase is just ``.forward(x)`` / ``.serve(requests)``. The plan
   table round-trips through JSON, so a committed table skips the sweep.
2. The LM side: train a small qwen3-family model a few steps, then
   greedy-decode from it.

Run:  PYTHONPATH=src python -m repro_torch.examples.quickstart
      [--device cpu] [--out DIR]
"""
from __future__ import annotations

import argparse
import os
import shutil
import sys
import warnings

import torch

from repro_torch.configs import get_config
from repro_torch.examples import _common
from repro_torch.kernels import autotune
from repro_torch.models.cnn import cnn_forward, init_cnn_params
from repro_torch.pipeline import ExecutionSpec, Serving, compile_cnn
from repro_torch.pipeline.compile import resolve_device
from repro_torch.train.steps import (init_train_state, serve_decode,
                                     serve_prefill, train_step)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples."
                                      "quickstart", description=__doc__)
    _common.add_device_arg(ap, out=True)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    g = torch.Generator(dev).manual_seed(0)

    # ------------------------------------------------------------ CNN side
    print("== PipeCNN compile-once pipeline (AlexNet, reduced) ==")
    acfg = get_config("alexnet").smoke()
    aparams = init_cnn_params(acfg, generator=g, device=dev)
    images = torch.randn((4, acfg.input_hw, acfg.input_hw, acfg.input_ch),
                         generator=g, device=dev)

    # COMPILE: the spec declares everything up front (fp32, the kernels'
    # plans, single placement, batch 4); compile_cnn resolves it all now
    spec = ExecutionSpec(serving=Serving(batch=4))
    compiled = compile_cnn(acfg, spec, aparams, device=dev)
    print(f"compiled: {compiled}")

    # RUN: the kernel pipeline against the oracles' fold (the exact LRN,
    # not the paper's PWL) through the legacy shim compile_cnn replaces
    logits_k = compiled.forward(images)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        # repro: allow[RPA201] the legacy shim, shown beside compile_cnn
        logits = cnn_forward(aparams, images, acfg)
    print(f"logits {tuple(logits.shape)}; kernels-vs-oracles max diff "
          f"{float((logits - logits_k).abs().max()):.2e} on "
          f"{_common.where(dev)}")

    # the frozen plan table is data: save it, wipe the process registry
    # (standing in for a fresh process), reload; the compile is all cache
    # hits and no sweep (the committed-artifact path)
    out = _common.out_dir(args, "quickstart")
    os.makedirs(out, exist_ok=True)
    path = compiled.save_plan(os.path.join(out, "plans.json"))
    autotune.clear_registry()
    autotune.reset_sweep_stats()
    compile_cnn(acfg, spec, aparams, plan_path=path, device=dev)
    st = autotune.sweep_stats()
    print(f"recompile from saved plan table: "
          f"{st['conv_sweeps'] + st['gemm_sweeps']} DSE sweeps, "
          f"{st['conv_hits'] + st['gemm_hits']} cache hits")
    assert st["conv_sweeps"] + st["gemm_sweeps"] == 0
    if args.out is None:
        shutil.rmtree(out)

    # ------------------------------------------------------------- LM side
    print("\n== LM framework (qwen3 family, smoke scale) ==")
    cfg = get_config("qwen3-8b").smoke()
    state = init_train_state(cfg, g, device=dev)
    for i in range(5):
        toks = torch.randint(0, cfg.vocab, (4, 33), generator=g, device=dev)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        state, metrics = train_step(state, batch, cfg)
        print(f"step {i}: loss {float(metrics['loss']):.4f} "
              f"gnorm {float(metrics['grad_norm']):.3f}")

    print("\n== greedy decode ==")
    prompts = torch.randint(0, cfg.vocab, (2, 8), generator=g, device=dev)
    with torch.no_grad():
        ids, _, cache = serve_prefill(state.params, {"tokens": prompts},
                                      cfg, 32)
        gen = [ids]
        for _ in range(6):
            ids, _, cache = serve_decode(state.params, ids, cache, cfg)
            gen.append(ids)
    print("generated:", torch.cat(gen, dim=1)[0].tolist())
    print("\nquickstart OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
