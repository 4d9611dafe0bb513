"""LM serving launcher of the port: batched prefill + greedy decode over
the unified LM (``models/lm.py``), a copy of the JAX package's
``launch/serve.py``.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-8b \\
        [--smoke] [--batch 4] [--prompt-len 32] [--gen 16] [--device cpu]

Random weights and prompts come from a generator seeded with 0 on the
run's device (the CUDA device unless ``--device`` names another). A
vlm/audio config runs only as ``--smoke``, with its frontend stripped, as
in JAX. Prints the generated shape, the tokens/s and, on the card, its
name.
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch

from repro_torch.configs import get_config
from repro_torch.models import lm
from repro_torch.pipeline.compile import resolve_device
from repro_torch.train.steps import serve_decode, serve_prefill


def generate(params, prompts: torch.Tensor, cfg, gen_steps: int,
             s_max: int) -> torch.Tensor:
    """Greedy decode. prompts (B, S0) -> (B, S0+gen_steps)."""
    next_ids, _, cache = serve_prefill(params, {"tokens": prompts}, cfg,
                                       s_max)
    toks = [prompts, next_ids]
    cur = next_ids
    for _ in range(gen_steps - 1):
        cur, _, cache = serve_decode(params, cur, cache, cfg)
        toks.append(cur)
    return torch.cat(toks, dim=1)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-8b")
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA device)")
    args = ap.parse_args(argv)

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    if cfg.frontend and not args.smoke:
        ap.error("vlm/audio serving uses the smoke config (frontend "
                 "stubbed): add --smoke")
    if cfg.frontend:
        cfg = dataclasses.replace(cfg, frontend=None, frontend_len=0)

    device = resolve_device(args.device)
    g = torch.Generator(device).manual_seed(0)
    params = lm.init_params(cfg, g, device)
    prompts = torch.randint(0, cfg.vocab, (args.batch, args.prompt_len),
                            generator=g, device=device)
    s_max = args.prompt_len + args.gen + 8
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.synchronize(device)
    # repro: allow[RPA102] user-facing tok/s readout
    t0 = time.perf_counter()
    out = generate(params, prompts, cfg, args.gen, s_max)
    if on_card:
        torch.cuda.synchronize(device)
    # repro: allow[RPA102] user-facing tok/s readout
    dt = time.perf_counter() - t0
    where = f" on {torch.cuda.get_device_name(device)}" if on_card else ""
    print(f"[serve] {args.arch}: generated {tuple(out.shape)} in {dt:.2f}s "
          f"({args.batch * args.gen / dt:.1f} tok/s){where}")
    print("[serve] sample:", out[0, -args.gen:].tolist())


if __name__ == "__main__":
    main()
