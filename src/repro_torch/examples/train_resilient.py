"""Resilient training, end to end:

* the Markov-stream data pipeline (host-sharded, deterministic),
* AdamW with a cosine schedule and gradient clipping,
* asynchronous checkpoints every 10 steps,
* an injected failure mid-run -> automatic restore and continue,
* optional int8 error-feedback gradient compression (``--compress``),
  whose residual is checkpointed with the state, so the re-run steps
  repeat the losses of the run the failure interrupted.

Checkpoints go under ``--out`` (or a temporary directory), and with
``--out`` the log of (step, loss) lands in ``<out>/losses.json``.

Run:  PYTHONPATH=src python -m repro_torch.examples.train_resilient
      [--steps 60] [--compress] [--fail-at 25 | -1] [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import os
import shutil
import sys

from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.examples import _common
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.pipeline.compile import resolve_device
from repro_torch.train.loop import LoopConfig, ResilientLoop


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.examples."
                                      "train_resilient", description=__doc__)
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--fail-at", type=int, default=25,
                    help="the step whose start fails once (-1: none)")
    ap.add_argument("--compress", action="store_true")
    _common.add_device_arg(ap, out=True)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = get_config(args.arch).smoke()
    fail_once = {args.fail_at} if 0 <= args.fail_at < args.steps else set()

    def fault(step):
        if step in fail_once:
            fail_once.discard(step)
            print(f"*** injecting node failure at step {step} ***")
            raise RuntimeError("simulated preemption")

    root = _common.out_dir(args, "train_resilient")
    ckpt_dir = os.path.join(root, "ckpt")
    shutil.rmtree(ckpt_dir, ignore_errors=True)     # a fresh run
    loop = ResilientLoop(
        cfg,
        LoopConfig(total_steps=args.steps, ckpt_every=10,
                   ckpt_dir=ckpt_dir, log_every=10,
                   compress_grads=args.compress),
        DataConfig(vocab=cfg.vocab, seq_len=64, global_batch=8),
        ocfg=AdamWConfig(lr=2e-3, warmup_steps=5, total_steps=args.steps),
        fault_hook=fault, device=dev)
    out = loop.run()
    if args.out is None:
        shutil.rmtree(root, ignore_errors=True)
    else:
        with open(os.path.join(root, "losses.json"), "w") as f:
            json.dump(out["metrics"], f, sort_keys=True)

    losses = [m["loss"] for m in out["metrics"]]
    print(f"\nfinal step {out['final_step']}  restarts {out['restarts']}  "
          f"loss {losses[0]:.3f} -> {losses[-1]:.3f} on {_common.where(dev)}")
    assert out["restarts"] == (1 if 0 <= args.fail_at < args.steps else 0)
    assert out["final_step"] == args.steps
    assert losses[-1] < losses[0], "training must make progress"
    print("train_resilient OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
