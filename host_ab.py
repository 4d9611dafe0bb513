#!/usr/bin/env python3
"""Time the LM's host-paced steps of two checkouts of this repo on one
CUDA card, alternating which runs first:

    python3 host_ab.py OTHER [--runs 4]

A is this checkout, B the one at OTHER (a directory holding
``src/repro_torch``, such as an unpacked ``git archive`` of another
commit). Runs go B A A B (B A A B ... for more), each a process of its
own with its checkout's ``src`` on its path and this file's code, which
does two things:

* Qwen3-8B at full width and depth in bf16 (random weights from seed 0),
  batch 4, a 1152-token prompt: a warm-up prefill and 2 decode steps, then
  one prefill and 15 greedy decode steps (``serve_decode``), each timed
  with CUDA events and the host's clock: the median step, as phase 16 of
  ``chip_smoke.py`` reports it;
* xLSTM-125M at full size in its config's dtypes (bf16, fp32 AdamW),
  batch 4 x 512: one warm-up ``train_step``, then 3 timed as above: the
  median, as phase 17's loop steps.

Both are paced by the host's launches. Prints the card's name and power
limit, one JSON line a run (with the ``repro_torch`` it imported), and
last each checkout's medians over its runs. Needs one card.
"""
import argparse
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
QWEN = ("qwen3_8b", "bfloat16", 4, 1152, 16)     # arch, dtype, B, prompt, gen
XLSTM = ("xlstm_125m", 4, 512, 3)                 # arch, B, seq, timed steps


def _timed(fn):
    """(fn(), CUDA-event ms, host ms)."""
    import torch
    s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    h0 = time.perf_counter()
    s.record()
    r = fn()
    e.record()
    torch.cuda.synchronize()
    return r, s.elapsed_time(e), (time.perf_counter() - h0) * 1e3


def worker() -> dict:
    import dataclasses

    import torch
    import repro_torch
    from repro_torch.configs import get_config
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.models import lm
    from repro_torch.train.steps import (init_train_state, serve_decode,
                                         serve_prefill, train_step)

    dev = torch.device("cuda")
    out = {"repro_torch": os.path.dirname(repro_torch.__file__)}
    arch, dtype, B, S, gen = QWEN
    cfg = dataclasses.replace(get_config(arch), dtype=dtype)
    g = torch.Generator(dev).manual_seed(0)
    params = lm.init_params(cfg, g, dev)
    prompts = torch.randint(0, cfg.vocab, (B, S), generator=g, device=dev)
    s_max = S + gen + 8
    ids, _, cache = serve_prefill(params, {"tokens": prompts}, cfg, s_max)
    for _ in range(2):                                   # warm-up
        ids, _, cache = serve_decode(params, ids, cache, cfg)
    (ids, _, cache), pf_ms, _ = _timed(
        lambda: serve_prefill(params, {"tokens": prompts}, cfg, s_max))
    dev_ms, host_ms = [], []
    for _ in range(gen - 1):
        (ids, _, cache), d, h = _timed(
            lambda: serve_decode(params, ids, cache, cfg))
        dev_ms.append(d)
        host_ms.append(h)
    out["qwen3_8b_bf16"] = {"prefill_ms": pf_ms,
                            "decode_ms": statistics.median(dev_ms),
                            "decode_host_ms": statistics.median(host_ms),
                            "decode_steps_ms": dev_ms}
    del params, cache, ids, prompts
    torch.cuda.empty_cache()

    arch, B, S, n = XLSTM
    cfg = get_config(arch)
    ocfg = AdamWConfig(state_dtype=cfg.opt_state_dtype)
    g = torch.Generator(dev).manual_seed(0)
    state = init_train_state(cfg, g, ocfg, device=dev)
    batch = {k: torch.randint(0, cfg.vocab, (B, S), generator=g, device=dev,
                              dtype=torch.int32) for k in ("tokens", "labels")}
    state, _ = train_step(state, batch, cfg, ocfg)       # warm-up
    torch.cuda.synchronize()
    dev_ms, host_ms = [], []
    for _ in range(n):
        (state, _), d, h = _timed(lambda: train_step(state, batch, cfg, ocfg))
        dev_ms.append(d)
        host_ms.append(h)
    out["xlstm_125m_train"] = {"step_ms": statistics.median(dev_ms),
                               "step_host_ms": statistics.median(host_ms),
                               "steps_ms": dev_ms}
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("other", nargs="?")
    ap.add_argument("--runs", type=int, default=4)
    ap.add_argument("--worker", action="store_true")
    a = ap.parse_args()
    if a.worker:
        print(json.dumps(worker()))
        return 0
    import torch
    if not torch.cuda.is_available() or not a.other:
        print("host_ab: needs a CUDA device and another checkout",
              file=sys.stderr)
        return 2
    trees = {"A": ROOT, "B": os.path.abspath(a.other)}
    for t in trees.values():
        if not os.path.isdir(os.path.join(t, "src", "repro_torch")):
            print(f"host_ab: no src/repro_torch in {t}", file=sys.stderr)
            return 2
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    order = [("B", "A", "A", "B")[i % 4] for i in range(a.runs)]
    runs = {"A": [], "B": []}
    for name in order:
        env = dict(os.environ, PYTHONPATH=os.path.join(trees[name], "src"))
        p = subprocess.run([sys.executable, os.path.abspath(__file__),
                            "--worker"], env=env, capture_output=True,
                           text=True)
        if p.returncode:
            print(p.stderr[-3000:], file=sys.stderr)
            return 1
        r = json.loads(p.stdout.strip().splitlines()[-1])
        runs[name].append(r)
        print(json.dumps(dict(r, run=name)))
    summary = {}
    for name, rs in runs.items():
        summary[name] = {
            "tree": trees[name],
            "qwen3_8b_bf16_decode_ms": [r["qwen3_8b_bf16"]["decode_ms"]
                                        for r in rs],
            "xlstm_125m_train_step_ms": [r["xlstm_125m_train"]["step_ms"]
                                         for r in rs]}
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
