"""Training launcher of the port: a copy of the JAX package's
``launch/train.py``. Runs the resilient loop (``train/loop.py``) for any
``--arch`` on the CUDA device, or on the device ``--device`` names.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-8b \\
        --steps 50 --smoke --batch 8 --seq 128 [--device cpu]

``--smoke`` runs the reduced config. The last line is the JAX
launcher's: ``[train] done: step N, loss A -> B, restarts=R``.
"""
from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig
from repro_torch.pipeline.compile import resolve_device
from repro_torch.train.loop import LoopConfig, ResilientLoop


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable)")
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    device = resolve_device(args.device)
    data_cfg = DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                          global_batch=args.batch)
    loop = ResilientLoop(
        cfg,
        LoopConfig(total_steps=args.steps, ckpt_every=args.ckpt_every,
                   ckpt_dir=args.ckpt_dir,
                   compress_grads=args.compress_grads),
        data_cfg, device=device)
    out = loop.run()
    losses = [m["loss"] for m in out["metrics"]]
    print(f"[train] done: step {out['final_step']}, "
          f"loss {losses[0]:.4f} -> {losses[-1]:.4f}, "
          f"restarts={out['restarts']}")


if __name__ == "__main__":
    main()
