#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. Device: the card's name and power limit, and a build of the CUDA
   kernels from ``src/repro_torch/csrc`` with nvcc (build time printed).
2. Kernel vs plain, with TF32 off: each of conv_pipe, lrn_pwl and
   matmul_pipe is held against its plain PyTorch version on the inputs
   AlexNet's batch-8 forward gives it (seeded weights, random biases; the
   fold over the plain versions), and timed beside the plain version, one
   library call and the card's bound; lrn_pwl must equal its plain
   version bit for bit. Each row of a redesigned kernel (conv_pipe,
   matmul_pipe and lrn_pwl fp32 here; see 2b and 8) also prints its tile
   or split, its TFLOP/s (TOP/s) or TB/s and its share of the bound, as
   timed and in a CUDA graph (``graph_ms``: the host's pace taken out,
   the library call's too; an LRN's graph cycles through at least 64 MiB
   of distinct input/output pairs, so its bytes come from device memory,
   not L2), and the replaced kernel's time for that layer (``OLD_MS``).
3. Full forward: ``compile_cnn(alexnet, batch 8).forward(x)`` at full
   width with the same weights must launch conv_pipe 5x, lrn_pwl 2x
   and matmul_pipe 3x (all fp32), and its logits must match the same
   forward on the CPU (plain versions).
4. Serve: 19 synthetic requests through ``.serve`` launch the same
   kernels per round; each request ends as one ``ok`` completion whose
   prediction matches the forward.
2b. int8 kernels vs plain: ``compile_cnn(alexnet, Precision(quant="int8"))``
   calibrates the same weights on the default batch on the card; the
   int8 modes of conv_pipe and matmul_pipe must equal their plain
   versions (the exact-int oracles) bit for bit on the int8 codes the
   calibrated forward gives each layer, timed beside the plain version,
   one library call where one exists and the card's bound; conv_pipe's
   int8 rows (the int8 tensor cores) and matmul_pipe's (a split-K
   IMMA stream over a cluster) print as the redesigned rows of 2.
   Then each model's sum of each redesigned fp32 and int8 kernel's
   launches beside the library's (cuDNN, cuBLAS, ``torch._int_mm`` +
   epilogue; none for the int8 conv) and the replaced sum.
3b. int8 forward: ``.forward(x)`` must launch the int8 conv mode 5x,
   lrn_pwl 2x and the int8 matmul mode 3x (and no fp32 conv or matmul),
   and its logits must equal bit for bit the fold of 2b over the kernels'
   plain versions (``use_kernels=False`` runs the exact-power LRN, not
   the PWL, so it is printed beside them, as is the top-1 agreement with
   the fp32 forward).
4b. int8 serve: the same 19 requests through the int8 model.
5. Attention kernels vs plain, with TF32 off, at Qwen3-8B's head
   geometry (32 query heads, 8 KV heads, d_head 128), in fp32 and bf16,
   inputs from the seeded generator: ``ops.attention`` (the
   flash_attention kernel) on a 4096-token prefill (``prefill_32k`` cut
   from S 32768 and batch 32), and ``decode_attention`` on caches of
   8 x 32768 slots (``decode_32k`` cut from batch 128) at pos 0, 16383
   and 32767, with the device-side pos. Every output element within
   rtol x (|plain| + the RMS of its row), rtol 1e-4 (fp32) or 2e-2
   (bf16), caches bit-equal to the plain version's after the write; each
   row timed beside the plain version, one library call (SDPA) and the
   card's bound. The prefill in both modes (flash_attention: FFMA in
   fp32, the tensor cores in bf16) prints as a redesigned row: its
   TFLOP/s and share of the bound as timed and in a CUDA graph (SDPA
   too), its worst error against the allowance, and the replaced
   kernel's time. So does every
   decode row (decode_attention split over the slots, both modes), in
   TB/s against the byte bound, beside the slot write + SDPA in a graph.
6. The attention layer at full width, the slice's main path: Qwen3-8B
   (d_model 4096), B 1, S 4096, seeded weights, fp32 and bf16.
   ``models.attention.attn_forward`` (plain, chunked) against the same
   projections -> ``ops.attention`` kernel -> ``wo``, and ``attn_decode``
   at pos 4095 against the projections -> ``decode_attention`` kernel ->
   ``wo``, held as in 5 (the row is a token); each mode must launch
   exactly its two attention kernels once. Then each kernel is held
   against its plain version on the inputs this path gave it and timed
   as in 5 (both prefills and both decodes as redesigned rows). The CNN
   phases above must launch no attention kernel.
7. VGG-16 at full width (batch 8, 224x224x3, seeded weights, random
   biases), fp32 and int8: each fp32 and int8 kernel against its plain
   version on the inputs the forward gives it, timed and printed as in 2
   and 2b, sums included (the 2x2/2 pooled tiles at 224x224x64); the fp32
   forward must launch conv_pipe 13x and matmul_pipe 3x and come within
   1e-3 x max|logit| of the fold over the plain versions; the int8 forward,
   calibrated on the card on the default batch, must launch the int8
   modes 13x and 3x and equal its plain fold bit for bit.
8. bf16 kernels vs plain: ``compile_cnn(..., Precision(dtype="bfloat16"))``
   of the same AlexNet and VGG-16 weights; at every layer of each bf16
   forward, the bf16 modes of conv_pipe, lrn_pwl and matmul_pipe within
   rtol = atol = 2e-2 of their plain versions (fp32 on the widened
   operands, rounded once; the worst error also printed in bf16 ulps),
   timed beside the plain version, one bf16 library call and the bound
   (operations at the bf16 tensor-core rate, bytes at 2 B an element).
   conv_pipe's and matmul_pipe's bf16 modes run on the tensor cores
   (``mma.sync``; matmul_pipe's split over K in a thread-block cluster);
   their rows and sums print as the redesigned rows of 2, as do the LRN
   rows (lrn_pwl's bf16 mode within one bf16 ulp of its plain version).
9. bf16 forwards: AlexNet must launch the bf16 modes 5/2/3x, VGG-16
   13/0/3x, and nothing else; logits within 2e-2 x max|logit| of the
   fold of 8 over the plain versions; the top-1 agreement with the fp32
   forward of the same weights is printed.
10. bf16 serve: the 19 requests through VGG-16 in bf16, each one ``ok``
   completion whose prediction matches the forward.
12. Plans (the DSE, ``kernels/autotune.py``), before the kernels line:
   the shared-memory table equal to what every instantiation requests;
   VGG-16 in fp32, int8 and bf16 and AlexNet in fp32 compiled with the
   default plans (each the tile or split the kernel's rule picks, one a
   conv and fc group), launching as in 3, 3b, 7 and 9 with logits
   ``torch.equal`` to those phases' and to the fold without plans; each
   table saved and reloaded (``compile_cnn(plan_path=)``: no sweep, the
   table byte-identical, the logits equal); a non-default fitting plan
   pinned on every group (printed), each reaching its kernel, int8 logits
   equal to the plain fold, fp32 within 1e-3 and bf16 within 2e-2 x
   max|logit| of it; a plan that does not fit raising in the wrapper and
   in a compile; ``compile_cnn(measure=True)`` for VGG-16 in each mode,
   one row a group with its plan, t_model, t_measured (CUDA events),
   drift (measured / modelled; below 1 is counted: the model is wrong)
   and bound; ``refine_plan`` (top 4 modelled) on conv4_2 bf16, conv5_1
   fp32, conv1_1 int8 and fc6 in each mode, the model's, the rule's and
   the stopwatch's picks; and phase 4's 19 requests served through
   AlexNet fp32 on the modelled clock, ``execute=False`` (nothing runs,
   predictions -1) and True (the forward's predictions), the modelled
   p50 beside phase 4's measured one.
11. One JSON line ``{"kernels": [...]}`` (each kernel and mode; launches
   from phases 3, 3b, 6, 7 and 9; each CNN entry sums the times of one
   AlexNet and one VGG-16 forward's launches in its mode, with each
   model's share under ``models``; the attention entries give phase 6's
   one launch at its shape), then the last line ``{"ok": true, "device":
   {...}}``.

Every phase prints its seconds.

Details go to ``chiprun_out/chip_smoke.json``. Without a CUDA device, or
without the repository around it, it exits non-zero and prints no result.
"""
from __future__ import annotations

import dataclasses
import itertools
import json
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

BATCH = 8
LOGIT_RTOL = 1e-3      # |gpu - cpu| <= LOGIT_RTOL * max|cpu logit|
KERNEL_RTOL = 1e-4     # |kernel - plain| <= KERNEL_RTOL * max(1, max|plain|)
LRN_RTOL = 1e-5        # same op order and rounding as the plain PWL
PWL_BOUND = 5e-3       # the paper's 0.5 % PWL error against the exact LRN
# the launch counters, by kernel and mode (name_s8: the int8 mode,
# name_bf16: the bf16 mode)
COUNTERS = ("conv_pipe", "conv_pipe_s8", "conv_pipe_bf16", "lrn_pwl",
            "lrn_pwl_bf16", "matmul_pipe", "matmul_pipe_s8",
            "matmul_pipe_bf16", "flash_attention", "flash_attention_bf16",
            "decode_attention", "decode_attention_bf16")


def expected(**n):
    """Launches per forward: the counters named, every other one 0 (the
    CNN paths launch no attention kernel and no other mode)."""
    return {c: n.get(c, 0) for c in COUNTERS}


EXPECTED_LAUNCHES = expected(conv_pipe=5, lrn_pwl=2, matmul_pipe=3)
EXPECTED_LAUNCHES_INT8 = expected(conv_pipe_s8=5, lrn_pwl=2, matmul_pipe_s8=3)
EXPECTED_VGG = expected(conv_pipe=13, matmul_pipe=3)
EXPECTED_VGG_INT8 = expected(conv_pipe_s8=13, matmul_pipe_s8=3)
EXPECTED_BF16 = {"alexnet": expected(conv_pipe_bf16=5, lrn_pwl_bf16=2,
                                     matmul_pipe_bf16=3),
                 "vgg16": expected(conv_pipe_bf16=13, matmul_pipe_bf16=3)}
REPLACES = {"conv_pipe": "src/repro/kernels/conv_pipe.py:198",
            "lrn_pwl": "src/repro/kernels/lrn_pwl.py:88",
            "matmul_pipe": "src/repro/kernels/matmul_pipe.py:66",
            "flash_attention": "src/repro/kernels/flash_attention.py:63",
            "decode_attention": "src/repro/kernels/decode_attention.py:83"}
BF16_RTOL = 2e-2               # tests/test_kernels.py:17-19, bf16
BF16_LOGIT_RTOL = 2e-2         # |bf16 - plain| <= this x max|plain logit|
BIAS_STD = 0.1                 # the random biases the CNN phases give
# attention at Qwen3-8B's head geometry (src/repro_torch/configs/qwen3_8b.py)
ATTN_ARCH = "qwen3_8b"
PREFILL_S = 4096               # prefill_32k cut: S 32768 -> 4096, batch 32 -> 1
DECODE_B, DECODE_S = 8, 32768  # decode_32k cut: batch 128 -> 8
DECODE_POS = (0, 16383, 32767)
INT_MM_ROWS = 32               # torch._int_mm needs more than 16 rows
# an LRN row's CUDA graph cycles through distinct input/output pairs of at
# least this many bytes, so its activation cannot stay in the 50 MB L2
ROTATION_BYTES = 64 << 20
# a launch (ms) with the kernel each redesign replaced, at batch 8 on the
# inputs of phases 2, 2b, 7 and 8, by kernel, model and layer, measured by
# this script on the card named (PERF.md section 5): conv_pipe_bf16's FFMA
# kernel (bf16 widened on the CUDA cores), conv_pipe's 64x64
# single-buffered FFMA kernel, matmul_pipe_bf16's FFMA weight stream,
# conv_pipe_s8's __dp4a kernel, matmul_pipe's one-block-a-slab FFMA
# kernel and matmul_pipe_s8's one-block-a-slab __dp4a kernel;
# flash_attention_bf16's FFMA kernel (bf16 widened on the CUDA cores) on
# the prefill of phases 5 and 6; and decode_attention's one block a (batch,
# KV head), both modes, at each decode row of phases 5 and 6 (as timed by
# this script's previous version, before the split, on the card named;
# PERF.md section 6); flash_attention's FFMA kernel of 64-row query tiles
# (4 rows x 4 keys a thread, K and V through registers into one buffer) on
# the fp32 prefill of phases 5 and 6, and lrn_pwl's element-a-thread kernel
# on AlexNet's LRNs in fp32 and bf16 (as timed by the previous version of
# this script on the card named, in one call with this version; PERF.md
# section 6)
OLD_CARD = "NVIDIA H100 80GB HBM3, 700.00 W"
OLD_MS = {
    "conv_pipe_bf16": {
        "alexnet": {"conv(0,)": 0.1373, "conv(3,)": 0.1942,
                    "conv(6,)": 0.1627, "conv(7,)": 0.1206,
                    "conv(8, 9)": 0.1162},
        "vgg16": {"conv(0,)": 0.1386, "conv(1, 2)": 1.3486,
                  "conv(3,)": 0.6829, "conv(4, 5)": 1.3358,
                  "conv(6,)": 0.6804, "conv(7,)": 1.3492,
                  "conv(8, 9)": 1.3504, "conv(10,)": 0.6946,
                  "conv(11,)": 1.3949, "conv(12, 13)": 1.5956,
                  "conv(14,)": 0.5347, "conv(15,)": 0.5346,
                  "conv(16, 17)": 0.5279}},
    "conv_pipe": {
        "alexnet": {"conv(0,)": 0.1237, "conv(3,)": 0.2228,
                    "conv(6,)": 0.3216, "conv(7,)": 0.2415,
                    "conv(8, 9)": 0.2314},
        "vgg16": {"conv(0,)": 0.1223, "conv(1, 2)": 1.3554,
                  "conv(3,)": 0.7038, "conv(4, 5)": 1.3661,
                  "conv(6,)": 0.7183, "conv(7,)": 1.4361,
                  "conv(8, 9)": 1.4035, "conv(10,)": 0.7425,
                  "conv(11,)": 1.4869, "conv(12, 13)": 1.8161,
                  "conv(14,)": 0.7401, "conv(15,)": 0.7466,
                  "conv(16, 17)": 0.7505}},
    "matmul_pipe_bf16": {
        "alexnet": {"fc(10,)": 0.0908, "fc(11,)": 0.0345, "fc(12,)": 0.0381},
        "vgg16": {"fc(18,)": 0.2423, "fc(19,)": 0.0321, "fc(20,)": 0.0378}},
    "conv_pipe_s8": {
        "alexnet": {"conv(0,)": 0.0847, "conv(3,)": 0.0942,
                    "conv(6,)": 0.0788, "conv(7,)": 0.0606,
                    "conv(8, 9)": 0.0571},
        "vgg16": {"conv(0,)": 0.1840, "conv(1, 2)": 0.6191,
                  "conv(3,)": 0.3325, "conv(4, 5)": 0.5940,
                  "conv(6,)": 0.3157, "conv(7,)": 0.6098,
                  "conv(8, 9)": 0.5963, "conv(10,)": 0.3153,
                  "conv(11,)": 0.6214, "conv(12, 13)": 0.6985,
                  "conv(14,)": 0.2433, "conv(15,)": 0.2437,
                  "conv(16, 17)": 0.2372}},
    "matmul_pipe": {
        "alexnet": {"fc(10,)": 0.1231, "fc(11,)": 0.0569, "fc(12,)": 0.0362},
        "vgg16": {"fc(18,)": 0.3298, "fc(19,)": 0.0571, "fc(20,)": 0.0359}},
    "matmul_pipe_s8": {
        "alexnet": {"fc(10,)": 0.0597, "fc(11,)": 0.0322, "fc(12,)": 0.0287},
        "vgg16": {"fc(18,)": 0.1591, "fc(19,)": 0.0218, "fc(20,)": 0.0283}},
    "flash_attention_bf16": {
        ATTN_ARCH: {"prefill bf16": 4.1035, "layer prefill bf16": 4.1035}},
    "flash_attention": {
        ATTN_ARCH: {"prefill fp32": 4.2902, "layer prefill fp32": 4.2911}},
    "lrn_pwl": {"alexnet": {"lrn(1,)": 0.0284, "lrn(4,)": 0.0215}},
    "lrn_pwl_bf16": {"alexnet": {"lrn(1,)": 0.0277, "lrn(4,)": 0.0252}},
    "decode_attention": {
        ATTN_ARCH: {"decode fp32 pos 0": 0.0353,
                    "decode fp32 pos 16383": 1.0345,
                    "decode fp32 pos 32767": 2.0633,
                    "layer decode fp32": 0.2598}},
    "decode_attention_bf16": {
        ATTN_ARCH: {"decode bf16 pos 0": 0.0299,
                    "decode bf16 pos 16383": 1.0008,
                    "decode bf16 pos 32767": 1.9893,
                    "layer decode bf16": 0.2557}}}


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3, runs: int = 3,
            budget_ms: float = 100.0) -> float:
    """Device time of one call: one pair of CUDA events around ``iters``
    back-to-back calls, divided by ``iters`` (so the host's pace drops out
    of launches shorter than their wrapper's host time); the median over
    ``runs`` such runs. A call longer than ``budget_ms / iters`` (timed
    once after the first warm-up call) runs fewer times a pair, at least
    once, so slow plain versions stay within the script's time."""
    import torch
    fn()
    s = torch.cuda.Event(enable_timing=True)
    e = torch.cuda.Event(enable_timing=True)
    s.record()
    fn()
    e.record()
    torch.cuda.synchronize()
    n = max(1, min(iters, int(budget_ms / max(s.elapsed_time(e), 1e-3))))
    for _ in range(warmup - 2 if n == iters else 0):
        fn()
    iters = n
    pairs = []
    for _ in range(runs):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(iters):
            fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) / iters for s, e in pairs)


def graph_ms(fn, iters: int = 20, runs: int = 3) -> float:
    """Device time of one call with the host's pace taken out: ``iters``
    calls captured in one CUDA graph and replayed between a pair of CUDA
    events; the median over ``runs`` replays. A call whose wrapper takes
    longer on the host than its kernel on the card (the small FC layers)
    shows its kernel's time here and the host's in :func:`time_ms`."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()                        # first calls (builds, attributes) first
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    pairs = []
    for _ in range(runs):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        graph.replay()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) / iters for s, e in pairs)


def attn_ratio(got, want, rtol: float) -> float:
    """The worst ratio of |got - want| to its allowance, rtol x (|want| +
    the RMS of want's row), over every element; 1 or less passes. The
    row's RMS is the absolute part, so each output row (a head's query
    row, a token) is held at its own scale, however small its values."""
    g, w = got.float(), want.float()
    rms = w.square().mean(-1, keepdim=True).sqrt()
    return ((g - w).abs() / (rtol * (w.abs() + rms))).max().item()


def bf16_ulps(got, want) -> float:
    """The worst |got - want| in units of the bf16 spacing at
    max(|want|, max|want| / 128): a sum that cancels to near zero is held
    at 1/128 of its tensor's scale, where fp32 sums in another order
    differ by more than the spacing at the value itself."""
    import torch
    w = want.float()
    floor = max(w.abs().max().item() / 128, 2.0 ** -126)
    exp = torch.frexp(w.abs().clamp_min(floor)).exponent
    ulp = torch.ldexp(torch.ones_like(w), exp - 8)
    return ((got.float() - w).abs() / ulp).max().item()


def rotated(fn, x, min_bytes: int = ROTATION_BYTES):
    """``(call, n)``: each call runs ``fn`` on the next of ``n`` copies of
    ``x`` in turn (``n`` the fewest whose inputs and outputs, as large as
    the inputs, fill ``min_bytes``) and keeps its output until that copy's
    turn comes round again, so back-to-back calls in a CUDA graph find
    neither the input nor the output in L2."""
    n = -(-min_bytes // (2 * x.numel() * x.element_size()))
    xs = [x.clone() for _ in range(n)]
    ys = [None] * n
    turn = itertools.count()

    def call():
        i = next(turn) % n
        ys[i] = fn(xs[i])
    return call, n


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


class Phases:
    """Prints each phase's seconds as it ends."""

    def __init__(self):
        self.t = time.perf_counter()
        self.seconds = {}

    def done(self, name: str) -> None:
        now = time.perf_counter()
        self.seconds[name] = now - self.t
        print(f"[phase {name}] {now - self.t:.1f} s")
        self.t = now


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import numpy as np
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.core import roofline
    from repro_torch.kernels import build
    from repro_torch.kernels import ops as kernel_ops
    from repro_torch.kernels.conv_pipe import (conv_pipe, conv_pipe_plain,
                                               conv_tile)
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_attention_plain)
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_plain)
    from repro_torch.kernels.lrn_pwl import lrn_pwl, lrn_pwl_plain
    from repro_torch.kernels.matmul_pipe import (fc_split, matmul_pipe,
                                                 matmul_pipe_plain)
    from repro_torch.kernels.ref import lrn_ref, pool_ref
    from repro_torch.launch.serve_cnn import (default_request_count,
                                              synthetic_requests)
    from repro_torch.models import attention as attn
    from repro_torch.models.cnn import fuse_plan
    from repro_torch.pipeline import (ExecutionSpec, Precision, Serving,
                                      compile_cnn)
    from repro_torch.quant import dequantize, quantize
    from repro_torch.serve import latency_report

    wrappers = {"conv_pipe": conv_pipe, "lrn_pwl": lrn_pwl,
                "matmul_pipe": matmul_pipe,
                "flash_attention": flash_attention,
                "decode_attention": decode_attention}

    def counter(c):
        """(wrapper, attribute) of counter ``c``."""
        base = c.removesuffix("_s8").removesuffix("_bf16")
        return wrappers[base], "launches" + c[len(base):]

    def reset_launches():
        for c in COUNTERS:
            setattr(*counter(c), 0)

    def launch_counts():
        return {c: getattr(*counter(c)) for c in COUNTERS}

    phases = Phases()

    def measure(row, rate):
        """Time the row's kernel, plain version and library call; add the
        card's bound for its operations (at ``rate``) and bytes."""
        row["ms"] = time_ms(row.pop("run"))
        row["plain_ms"] = time_ms(row.pop("plain"))
        lib = row.pop("library")
        row["library_ms"] = time_ms(lib) if lib is not None else None
        t_ops, t_bytes = row["ops"] / rate, row["bytes"] / bw
        row["bound_ms"] = max(t_ops, t_bytes) * 1e3
        row["bound_by"] = "operations" if t_ops >= t_bytes else "bytes"
        lib_ms = ("none" if row["library_ms"] is None
                  else f"{row['library_ms']:.4f} ms")
        # attention rows are held element by element (attn_ratio)
        tol = (f"tol {row['tol']:.1e}" if "tol" in row
               else f"{row['err_ratio']:.3f} of its allowance")
        print(f"[kernel] {row['layer']:>14} {row['kernel']:<14} "
              f"{str(row['shape']):<22} err {row['max_abs_err']:.3e}"
              f" ({tol})  kernel {row['ms']:.4f} ms"
              f"  plain {row['plain_ms']:.4f} ms  library {lib_ms}  "
              f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
        check(row["max_abs_err"] <= row["tol"] if "tol" in row
              else row["err_ratio"] <= 1.0,
              f"{row['layer']} {row['kernel']}: error "
              f"{row['max_abs_err']:.3e} ({tol})")

    # -- 1. device and build ------------------------------------------------
    card = smi("name,power.limit")
    print(card)
    name = torch.cuda.get_device_name(0)
    props = torch.cuda.get_device_properties(0)
    # the card's rates: the port's roofline (src/repro_torch/core/roofline.py)
    prof = roofline.device_profile(0)
    sm_mhz = float(smi("clocks.max.sm").split()[0])
    check(abs(sm_mhz - prof.clock_mhz) < 1, f"the roofline's clock "
          f"{prof.clock_mhz} MHz differs from nvidia-smi's max SM clock "
          f"{sm_mhz} MHz")
    fp32_rate = prof.peak_ops("float32")
    int8_rate = prof.peak_ops("int8")
    bf16_rate = prof.peak_ops("bfloat16")
    bw = prof.hbm_bw
    bw_src = ("published" if any(k in name for k in roofline.MEM_BW)
              else "assumed (H100 SXM)")
    print(f"[device] {name}: {prof.sms} SMs, max SM clock "
          f"{prof.clock_mhz:.0f} MHz (nvidia-smi {sm_mhz:.0f}) -> fp32 FFMA "
          f"{fp32_rate / 1e12:.1f} TFLOP/s, dense int8 tensor cores "
          f"({prof.int8_per_clock_sm:.0f} ops/clock/SM) "
          f"{int8_rate / 1e12:.1f} TOP/s, dense bf16 tensor cores "
          f"({prof.bf16_per_clock_sm:.0f} FLOP/clock/SM) "
          f"{bf16_rate / 1e12:.1f} TFLOP/s; HBM {bw / 1e12:.2f} TB/s "
          f"({bw_src}); shared memory {prof.smem_per_block} B a block; "
          f"backend tag {prof.tag}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}")
    t0 = time.perf_counter()
    built = build.build_all()
    print(f"[build] {len(built)} kernels from src/repro_torch/csrc in "
          f"{time.perf_counter() - t0:.1f} s (nvcc sm_90a, one process per "
          f"source, in parallel; "
          f"{sum(i['cached'] for i in built.values())} already built)")
    for kname, info in built.items():
        for line in info["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {kname}: {line.strip()}")

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    phases.done("1")

    def conv_kw(cfg, group):
        l = cfg.layers[group[0]]
        pool = cfg.layers[group[1]] if len(group) == 2 else None
        return l, pool, dict(stride=l.stride, pad=l.pad, relu=l.relu,
                             pool=pool.pool if pool else None,
                             pool_k=pool.kernel if pool else 2,
                             pool_s=pool.stride if pool else 2,
                             groups=l.groups)

    def conv_ops(h, w, l):
        return 2 * h.shape[0] * w.numel() * (
            (h.shape[1] + 2 * l.pad - l.kernel) // l.stride + 1) * (
            (h.shape[2] + 2 * l.pad - l.kernel) // l.stride + 1)

    def float_rows(cfg, params, x, mode):
        """Each fp32 or bf16 kernel of one forward held against its plain
        version on the inputs the fold over the plain versions gives it,
        and timed (phases 2, 7 and 8). Returns (rows, the fold's logits)."""
        sfx = "" if mode == "fp32" else "_bf16"
        es = x.element_size()
        rows = []
        h = x
        before = None
        with torch.inference_mode():
            for group in fuse_plan(cfg):
                l = cfg.layers[group[0]]
                p = params[group[0]]
                row = None
                if l.kind == "conv":
                    l, pool, kw = conv_kw(cfg, group)
                    w, b = p["w"], p["b"]
                    got = conv_pipe(h, w, b, **kw)
                    want = conv_pipe_plain(h, w, b, **kw)
                    xc = h.permute(0, 3, 1, 2).contiguous()
                    wc = w.permute(3, 2, 0, 1).contiguous()

                    def library(xc=xc, wc=wc, b=b, l=l, pool=pool):
                        y = F.relu(F.conv2d(xc, wc, b, stride=l.stride,
                                            padding=l.pad, groups=l.groups))
                        if pool is None:
                            return y
                        fn = F.max_pool2d if pool.pool == "max" \
                            else F.avg_pool2d
                        return fn(y, pool.kernel, pool.stride)
                    row = dict(kernel="conv_pipe" + sfx, layer=f"conv{group}",
                               shape=list(h.shape),
                               run=lambda h=h, w=w, b=b, kw=kw:
                               conv_pipe(h, w, b, **kw),
                               plain=lambda h=h, w=w, b=b, kw=kw:
                               conv_pipe_plain(h, w, b, **kw),
                               library=library, ops=conv_ops(h, w, l),
                               bytes=es * (h.numel() + w.numel() + b.numel()
                                           + got.numel()))
                elif l.kind == "lrn":
                    got = lrn_pwl(h)
                    want = lrn_pwl_plain(h)
                    exact = lrn_ref(h.float())
                    pwl_err = ((lrn_pwl_plain(h.float()) - exact).abs()
                               / (exact.abs() + 1e-9)).max().item()
                    check(pwl_err < PWL_BOUND,
                          f"PWL error {pwl_err:.3%} vs exact LRN > 0.5%")
                    xc = h.permute(0, 3, 1, 2).contiguous()
                    row = dict(kernel="lrn_pwl" + sfx, layer=f"lrn{group}",
                               shape=list(h.shape), pwl_vs_exact=pwl_err,
                               run=lambda h=h: lrn_pwl(h),
                               plain=lambda h=h: lrn_pwl_plain(h),
                               library=lambda xc=xc: lrn_library(xc),
                               library_input=xc,
                               ops=14 * h.numel(), bytes=2 * es * h.numel())
                elif l.kind == "fc":
                    xf = h.reshape(h.shape[0], -1)
                    w, b = p["w"], p["b"]
                    got = matmul_pipe(xf, w, b, relu=l.relu)
                    want = matmul_pipe_plain(xf, w, b, relu=l.relu)
                    M, K = xf.shape
                    N = w.shape[1]
                    row = dict(kernel="matmul_pipe" + sfx, layer=f"fc{group}",
                               shape=[M, K, N],
                               run=lambda xf=xf, w=w, b=b, r=l.relu:
                               matmul_pipe(xf, w, b, relu=r),
                               plain=lambda xf=xf, w=w, b=b, r=l.relu:
                               matmul_pipe_plain(xf, w, b, relu=r),
                               library=lambda xf=xf, w=w, b=b, r=l.relu:
                               (torch.addmm(b, xf, w).relu_() if r
                                else torch.addmm(b, xf, w)),
                               ops=2 * M * K * N,
                               bytes=es * (M * K + K * N + N + M * N))
                else:
                    want = pool_ref(h, l.pool, l.kernel, l.stride)
                if row is not None:
                    torch.cuda.synchronize()
                    check(got.shape == want.shape and got.dtype == want.dtype,
                          f"{cfg.name} {row['layer']}: {got.dtype} "
                          f"{tuple(got.shape)} vs {want.dtype} "
                          f"{tuple(want.shape)}")
                    diff = (got.float() - want.float()).abs()
                    row["max_abs_err"] = diff.max().item()
                    row["mode"] = mode
                    row["model"] = cfg.name
                    if mode == "fp32":
                        if l.kind == "lrn":
                            check(torch.equal(got, want),
                                  f"{cfg.name} {row['layer']}: lrn_pwl "
                                  f"differs from its plain version "
                                  f"(bit-equal required)")
                        peak = want.abs().max().item()
                        row["tol"] = LRN_RTOL * peak if l.kind == "lrn" \
                            else KERNEL_RTOL * max(1.0, peak)
                    else:
                        row["err_ratio"] = (diff / (BF16_RTOL * (
                            1.0 + want.float().abs()))).max().item()
                        row["ulps"] = bf16_ulps(got, want)
                        row["n_differ"] = int((diff > 0).sum())
                        print(f"[bf16] {cfg.name} {row['layer']}: worst "
                              f"error {row['ulps']:.2f} bf16 ulps (of "
                              f"max(|plain|, max|plain|/128)), "
                              f"{row['n_differ']} of {got.numel()} differ")
                        check(l.kind != "lrn" or row["ulps"] <= 1.0,
                              f"{cfg.name} {row['layer']}: lrn_pwl_bf16 "
                              f"{row['ulps']:.2f} bf16 ulps from its plain "
                              f"version (1 allowed)")
                    fns = row["run"], row["library"]
                    lib_in = row.pop("library_input", None)
                    measure(row, fp32_rate if mode == "fp32" else bf16_rate)
                    if row["kernel"] in OLD_MS:
                        redesign_line(cfg, row, h, l,
                                      kw if l.kind == "conv" else None, *fns,
                                      lib_in, before)
                    rows.append(row)
                    before = fns[0]        # the kernel an LRN follows
                h = want
        return rows, h

    def lrn_library(xc):
        """F.local_response_norm with AlexNet's constants, on NCHW x."""
        return F.local_response_norm(xc, 5, alpha=1e-4, beta=0.75, k=2.0)

    def redesign_line(cfg, row, h, l, kw, run, library, lib_in=None,
                      before=None):
        """Print a redesigned kernel's row: its tile (a conv, ``kw`` its
        keywords) or split (FC), its TFLOP/s (conv) or TB/s (FC weights,
        LRN) and share of the bound, both as timed and in a CUDA graph (the
        host's pace taken out; the library call too), and the replaced
        kernel's time for the layer. An LRN row's graph cycles through
        :func:`rotated` copies of its input (the library's of
        ``lib_in``), so that its bytes come from device memory. Back to
        back, each LRN launch overlaps the one before (a programmatic
        dependent); in the forward it follows ``before``, its conv, which
        releases no dependent early. So the LRN is also timed there, as a
        graph of conv and LRN pairs less one of the conv alone
        (``behind_ms``)."""
        sms = props.multi_processor_count
        if l.kind == "lrn":
            run, n_pairs = rotated(lrn_pwl, h)
            library, _ = rotated(lrn_library, lib_in)
        row["graph_ms"] = graph_ms(run)
        row["library_graph_ms"] = (None if library is None
                                   else graph_ms(library))
        unit = "TOP/s" if row["mode"] == "int8" else "TFLOP/s"
        graph_note = ""
        if l.kind == "lrn":
            what = f"C {h.shape[3]}"
            graph_note = (f" over {n_pairs} distinct input/output pairs "
                          f"({n_pairs * row['bytes'] / 2 ** 20:.0f} MiB)")
            row["rotation_pairs"] = n_pairs
            row["tbps"] = row["bytes"] / row["ms"] / 1e9
            row["behind_ms"] = (graph_ms(lambda: (before(), run()), runs=5)
                                - graph_ms(before, runs=5))
            graph_note = (f"{graph_note}, behind its conv "
                          f"{row['behind_ms']:.4f} ms, "
                          f"{100 * row['bound_ms'] / row['behind_ms']:.1f} "
                          f"%; back to back")

            def rate(ms):
                return f"{row['bytes'] / ms / 1e9:.2f} TB/s"
        elif kw is not None:
            oh = (h.shape[1] + 2 * l.pad - l.kernel) // l.stride + 1
            ow = (h.shape[2] + 2 * l.pad - l.kernel) // l.stride + 1
            row["tile"] = conv_tile(h.dtype, h.shape[0], oh, ow,
                                    l.out_ch // l.groups, l.groups,
                                    kw["pool"], kw["pool_k"], kw["pool_s"],
                                    sms, h.shape[3] // l.groups)
            what = f"tile {row['tile'][0]}x{row['tile'][1]}"
            row["tflops"] = row["ops"] / row["ms"] / 1e9

            def rate(ms):
                return f"{row['ops'] / ms / 1e9:.1f} {unit}"
        else:
            M, K, N = row["shape"]
            row["split"] = fc_split(h.dtype, M, K, N, sms)
            what = (f"split {row['split'][0]} features x {row['split'][1]} "
                    f"ranks")
            row["tbps"] = row["bytes"] / row["ms"] / 1e9

            def rate(ms):
                return f"{row['bytes'] / ms / 1e9:.2f} TB/s"
        row["pct_of_bound"] = 100 * row["bound_ms"] / row["ms"]
        row["old_ms"] = OLD_MS[row["kernel"]][cfg.name][row["layer"]]
        lib = ("none" if row["library_graph_ms"] is None
               else f"{row['library_graph_ms']:.4f} ms")
        print(f"[redesign] {cfg.name} {row['layer']} {row['kernel']}: "
              f"{what}, {row['ms']:.4f} ms, {rate(row['ms'])}, "
              f"{row['pct_of_bound']:.1f} % of the bound; in a CUDA graph"
              f"{graph_note} {row['graph_ms']:.4f} ms, "
              f"{rate(row['graph_ms'])}, "
              f"{100 * row['bound_ms'] / row['graph_ms']:.1f} % (library "
              f"{lib}); replaced kernel "
              f"{row['old_ms']:.4f} ms ({OLD_CARD}), "
              f"{row['old_ms'] / row['ms']:.2f}x")

    def model_sum(cfg, rows, kname, library):
        """Print one model's sum of a redesigned kernel's launches beside
        the library's (``library`` names it, None where there is none) and
        the replaced kernel's, as timed and in CUDA graphs."""
        rs = [r for r in rows if r["kernel"] == kname]
        out = {k: sum(r[k] for r in rs) for k in (
            "ms", "old_ms", "bound_ms", "graph_ms")}
        for k in ("library_ms", "library_graph_ms"):
            out[k] = None if library is None else sum(r[k] for r in rs)
        lib = ("no library call" if library is None else
               f"{library} {out['library_ms']:.4f} ms "
               f"({out['library_ms'] / out['ms']:.2f}x the kernel's time)")
        graph_lib = ("" if library is None else
                     f" against {out['library_graph_ms']:.4f} ms")
        print(f"[redesign] {cfg.name} {kname}: {len(rs)} launches "
              f"{out['ms']:.4f} ms (bound {out['bound_ms']:.4f} ms, "
              f"{100 * out['bound_ms'] / out['ms']:.1f} %); {lib}; in CUDA "
              f"graphs {out['graph_ms']:.4f} ms{graph_lib}; replaced kernel "
              f"{out['old_ms']:.4f} ms ({OLD_CARD}); layers slower than it: "
              f"{[r['layer'] for r in rs if r['ms'] > r['old_ms']]}")
        return out

    def cnn_sums(cfg, rows, qrows):
        """model_sum of each redesigned fp32 and int8 kernel of a model."""
        return {(cfg.name, k): model_sum(cfg, rs, k, lib) for k, rs, lib in (
            ("conv_pipe", rows, "cuDNN fp32 conv+ReLU+pool (TF32 off)"),
            ("matmul_pipe", rows, "cuBLAS fp32 addmm+ReLU (TF32 off)"),
            ("conv_pipe_s8", qrows, None),
            ("matmul_pipe_s8", qrows, "torch._int_mm + epilogue"))}

    def int8_rows(cfg, qp, x):
        """Each int8 kernel of one int8 forward held bit for bit against
        its plain version (the exact-int oracle) on the codes the fold over
        the plain versions gives it, and timed (phases 2b and 7). Returns
        (rows, the fold's logits)."""
        rows = []
        h = quantize(x, qp.in_scale)
        with torch.inference_mode():
            for group in fuse_plan(cfg):
                l = cfg.layers[group[0]]
                ql = qp.layers[group[0]]
                row = None
                if l.kind == "conv":
                    l, _, kw = conv_kw(cfg, group)
                    kw.update(scale=ql.scale, out_scale=ql.y_scale)
                    got = conv_pipe(h, ql.w_q, ql.b, **kw)
                    want = conv_pipe_plain(h, ql.w_q, ql.b, **kw)
                    row = dict(kernel="conv_pipe_s8", layer=f"conv{group}",
                               shape=list(h.shape),
                               run=lambda h=h, ql=ql, kw=kw:
                               conv_pipe(h, ql.w_q, ql.b, **kw),
                               plain=lambda h=h, ql=ql, kw=kw:
                               conv_pipe_plain(h, ql.w_q, ql.b, **kw),
                               library=None, ops=conv_ops(h, ql.w_q, l))
                    nbytes = h.numel() + ql.w_q.numel() + 8 * ql.b.numel()
                elif l.kind == "fc":
                    xf = h.reshape(h.shape[0], -1)
                    kw = dict(relu=l.relu, scale=ql.scale,
                              out_scale=ql.y_scale)
                    got = matmul_pipe(xf, ql.w_q, ql.b, **kw)
                    want = matmul_pipe_plain(xf, ql.w_q, ql.b, **kw)
                    M, K = xf.shape
                    N = ql.w_q.shape[1]
                    xpad = torch.zeros((max(M, INT_MM_ROWS), K),
                                       dtype=torch.int8, device="cuda")
                    xpad[:M] = xf

                    def library(xpad=xpad, M=M, ql=ql, relu=l.relu):
                        y = torch._int_mm(xpad, ql.w_q)[:M].float() * ql.scale
                        y = y + ql.b
                        if relu:
                            y = y.relu_()
                        return y if ql.y_scale is None else quantize(
                            y, ql.y_scale)
                    row = dict(kernel="matmul_pipe_s8", layer=f"fc{group}",
                               shape=[M, K, N],
                               run=lambda xf=xf, ql=ql, kw=kw:
                               matmul_pipe(xf, ql.w_q, ql.b, **kw),
                               plain=lambda xf=xf, ql=ql, kw=kw:
                               matmul_pipe_plain(xf, ql.w_q, ql.b, **kw),
                               library=library, ops=2 * M * K * N)
                    nbytes = xf.numel() + ql.w_q.numel() + 8 * N
                elif l.kind == "lrn":
                    xf = dequantize(h, ql.x_scale)
                    check(torch.equal(lrn_pwl(xf), lrn_pwl_plain(xf)),
                          f"lrn{group}: lrn_pwl differs from its plain "
                          f"version on the int8 path's input")
                    want = quantize(lrn_pwl_plain(xf), ql.y_scale)
                else:
                    want = pool_ref(h, l.pool, l.kernel, l.stride)
                if row is not None:
                    torch.cuda.synchronize()
                    check(got.shape == want.shape and got.dtype == want.dtype,
                          f"{cfg.name} {row['layer']}: {got.dtype} "
                          f"{tuple(got.shape)} vs {want.dtype} "
                          f"{tuple(want.shape)}")
                    diff = (got.float() - want.float()).abs()
                    row["bytes"] = nbytes + got.numel() * got.element_size()
                    row["out"] = str(got.dtype).replace("torch.", "")
                    row["n_differ"] = int((diff > 0).sum())
                    row["max_abs_err"] = diff.max().item()
                    row["tol"] = 0.0
                    row["mode"] = "int8"
                    row["model"] = cfg.name
                    fns = row["run"], row["library"]
                    measure(row, int8_rate)
                    check(torch.equal(got, want),
                          f"{cfg.name} {row['layer']} {row['kernel']}: "
                          f"{row['n_differ']} outputs differ from the plain "
                          f"version")
                    if row["kernel"] in OLD_MS:
                        redesign_line(cfg, row, h, l,
                                      kw if l.kind == "conv" else None, *fns)
                    rows.append(row)
                h = want
        return rows, h

    def with_biases(params, gen):
        """The parameters with random biases in place of the zeros the
        initialiser gives, so every check runs the bias path."""
        return [None if p is None else {
            "w": p["w"], "b": BIAS_STD * torch.randn(
                p["b"].shape, generator=gen, device="cuda")}
            for p in params]

    cfg = get_config("alexnet")
    spec = ExecutionSpec(serving=Serving(batch=BATCH))
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = compile_cnn(cfg, spec, generator=gen, device="cuda").params
    x = torch.randn((BATCH, cfg.input_hw, cfg.input_hw, cfg.input_ch),
                    generator=gen, device="cuda")
    params = with_biases(params, gen)
    compiled = compile_cnn(cfg, spec, params, device="cuda")
    x_alex = x                      # phase 6 reuses the name x

    # -- 2. each kernel vs its plain version at AlexNet's shapes ------------
    rows, a_plain = float_rows(cfg, params, x, "fp32")
    phases.done("2")


    # -- 3. the full forward through the entry point --------------------------
    reset_launches()
    logits = compiled.forward(x)
    torch.cuda.synchronize()
    launches = launch_counts()
    print(f"[forward] launches {launches}")
    check(launches == EXPECTED_LAUNCHES,
          f"forward launches {launches} != {EXPECTED_LAUNCHES}")
    check(tuple(logits.shape) == (BATCH, cfg.n_classes)
          and bool(torch.isfinite(logits).all()), "logits shape/finite")
    cpu = compile_cnn(cfg, spec, [None if p is None else
                                  {k: v.cpu() for k, v in p.items()}
                                  for p in params], device="cpu")
    want = cpu.forward(x.cpu())
    got = logits.cpu()
    err = (got - want).abs().max().item()
    tol = LOGIT_RTOL * want.abs().max().item()
    top1 = (got.argmax(-1) == want.argmax(-1)).float().mean().item()
    print(f"[forward] logits vs CPU plain forward: max abs err {err:.3e} "
          f"(tol {tol:.3e} = {LOGIT_RTOL} x max|logit|), top-1 agreement "
          f"{top1:.0%}")
    check(err <= tol, f"logits differ from the CPU forward: {err} > {tol}")
    fwd_ms = time_ms(lambda: compiled.forward(x))
    print(f"[forward] alexnet batch {BATCH}: {fwd_ms:.3f} ms median, "
          f"{BATCH / fwd_ms * 1e3:.1f} images/s")
    phases.done("3")

    # -- 4. serve ---------------------------------------------------------------
    n_req = default_request_count(BATCH)

    def serve(model, expected, tag):
        """Serve ``n_req`` synthetic requests of the model's input size
        through ``model``: every request one ``ok`` completion with the
        forward's prediction, ``expected`` launches per forward."""
        reqs = synthetic_requests(n_req, model.cfg.input_hw,
                                  model.cfg.input_ch, 200.0)
        imgs = torch.from_numpy(np.stack([r.image for r in reqs])).cuda()
        reset_launches()
        rep = model.serve(reqs)
        torch.cuda.synchronize()
        served = launch_counts()
        n_fwd = rep.rounds + 1          # one forward per round + warm-up
        print(f"[{tag}] launches {served} over {n_fwd} forwards")
        check(served == {n: v * n_fwd for n, v in expected.items()},
              f"{tag} launches {served} != {n_fwd} x {expected}")
        done = sorted(rep.completions, key=lambda c: c.rid)
        check([c.rid for c in done] == list(range(n_req))
              and all(c.status == "ok" for c in done),
              f"{tag}: {len(done)} completions for {n_req} requests")
        preds = torch.cat([model.forward(imgs[i:i + BATCH]).argmax(-1)
                           for i in range(0, n_req, BATCH)]).tolist()
        check([c.pred for c in done] == preds,
              f"{tag} predictions differ from the forward's")
        lat = latency_report(rep.completions)
        print(f"[{tag}] {rep.summary()}")
        print(f"[{tag}] latency_report {json.dumps(lat)}")
        return rep, lat

    rep, lat = serve(compiled, EXPECTED_LAUNCHES, "serve")
    phases.done("4")

    # -- 2b. the int8 kernel modes vs their plain versions --------------------
    qspec = ExecutionSpec(precision=Precision(quant="int8"),
                          serving=Serving(batch=BATCH))
    t0 = time.perf_counter()
    qcompiled = compile_cnn(cfg, qspec, params, device="cuda")
    qp = qcompiled.params
    print(f"[int8] calibrated on the default batch ({qspec.precision.calib} "
          f"images, on the card) in {time.perf_counter() - t0:.2f} s; input "
          f"scale {qp.in_scale:.6g}")
    qrows, plain_qlogits = int8_rows(cfg, qp, x)
    sums = cnn_sums(cfg, rows, qrows)
    phases.done("2b")

    # -- 3b. the int8 forward through the entry point --------------------------
    reset_launches()
    qlogits = qcompiled.forward(x)
    torch.cuda.synchronize()
    qlaunches = launch_counts()
    print(f"[int8 forward] launches {qlaunches}")
    check(qlaunches == EXPECTED_LAUNCHES_INT8,
          f"int8 forward launches {qlaunches} != {EXPECTED_LAUNCHES_INT8}")
    check(qlogits.dtype == torch.float32
          and tuple(qlogits.shape) == (BATCH, cfg.n_classes)
          and bool(torch.isfinite(qlogits).all()), "int8 logits shape/finite")
    q_differ = int((qlogits != plain_qlogits).sum())
    q_top1 = (qlogits.argmax(-1) == logits.argmax(-1)).float().mean().item()
    print(f"[int8 forward] logits vs the fold over the plain versions: "
          f"{q_differ} of {qlogits.numel()} differ (bit-equal required); "
          f"top-1 agreement with the fp32 forward {q_top1:.0%}")
    check(q_differ == 0, "int8 logits differ from the plain versions' fold")
    oracle = compile_cnn(cfg, ExecutionSpec(
        precision=Precision(quant="int8"), serving=Serving(batch=BATCH),
        use_kernels=False), qp, device="cuda").forward(x)
    o_err = (qlogits - oracle).abs().max().item()
    o_top1 = (qlogits.argmax(-1) == oracle.argmax(-1)).float().mean().item()
    print(f"[int8 forward] vs use_kernels=False (exact oracles, exact-power "
          f"LRN, not the PWL): max abs err {o_err:.3e} (max|logit| "
          f"{oracle.abs().max().item():.3e}), top-1 agreement {o_top1:.0%}")
    qfwd_ms = time_ms(lambda: qcompiled.forward(x))
    print(f"[int8 forward] alexnet batch {BATCH}: int8 {qfwd_ms:.3f} ms "
          f"median, {BATCH / qfwd_ms * 1e3:.1f} images/s; fp32 "
          f"{fwd_ms:.3f} ms, {BATCH / fwd_ms * 1e3:.1f} images/s")
    phases.done("3b")

    # -- 4b. int8 serve -------------------------------------------------------------
    qrep, qlat = serve(qcompiled, EXPECTED_LAUNCHES_INT8, "int8 serve")
    phases.done("4b")

    # -- 5. the attention kernels vs their plain versions -------------------
    acfg = get_config(ATTN_ARCH)
    hq, hkv, dh = acfg.n_heads, acfg.n_kv_heads, acfg.d_head
    G = hq // hkv
    arows = []
    dtypes = {"fp32": torch.float32, "bf16": torch.bfloat16}

    def attn_row(row, got, want, mode, rows):
        """Hold ``got`` against the plain ``want``, time the row and add
        it to ``rows``."""
        torch.cuda.synchronize()
        check(got.shape == want.shape and got.dtype == want.dtype,
              f"{row['layer']}: {got.dtype} {tuple(got.shape)} vs "
              f"{want.dtype} {tuple(want.shape)}")
        rtol = KERNEL_RTOL if mode == "fp32" else BF16_RTOL
        row["max_abs_err"] = (got.float() - want.float()).abs().max().item()
        row["err_ratio"] = attn_ratio(got, want, rtol)
        row["mode"] = mode
        fns = row["run"], row["library"]
        measure(row, fp32_rate if mode == "fp32" else bf16_rate)
        old = OLD_MS.get(row["kernel"], {}).get(ATTN_ARCH, {})
        if row["layer"] in old:
            attn_redesign_line(row, old[row["layer"]], *fns)
        rows.append(row)

    def attn_redesign_line(row, old_ms, run, library):
        """Print a redesigned attention kernel's row: TFLOP/s (prefill) or
        TB/s (decode, bound by bytes) and share of the bound as timed and
        in a CUDA graph (the library call too: SDPA, or the slot write +
        SDPA), its worst error against the allowance, and the replaced
        kernel's time."""
        row["graph_ms"] = graph_ms(run)
        row["library_graph_ms"] = graph_ms(library)
        row["old_ms"] = old_ms
        row["pct_of_bound"] = 100 * row["bound_ms"] / row["ms"]
        if row["bound_by"] == "bytes":
            row["tbps"] = row["bytes"] / row["ms"] / 1e9

            def rate(ms):
                return f"{row['bytes'] / ms / 1e9:.2f} TB/s"
            lib = "slot write + SDPA"
        else:
            row["tflops"] = row["ops"] / row["ms"] / 1e9

            def rate(ms):
                return f"{row['ops'] / ms / 1e9:.1f} TFLOP/s"
            lib = "SDPA"
        print(f"[redesign] {ATTN_ARCH} {row['layer']} {row['kernel']}: "
              f"{row['ms']:.4f} ms, {rate(row['ms'])}, "
              f"{row['pct_of_bound']:.1f} % of the bound; in a CUDA graph "
              f"{row['graph_ms']:.4f} ms, {rate(row['graph_ms'])}, "
              f"{100 * row['bound_ms'] / row['graph_ms']:.1f} % ({lib} "
              f"{row['library_graph_ms']:.4f} ms); worst error "
              f"{row['err_ratio']:.3f} of the allowance; replaced kernel "
              f"{old_ms:.4f} ms ({OLD_CARD}), {old_ms / row['ms']:.2f}x")

    with torch.inference_mode():
        for mode, dt in dtypes.items():
            es = torch.finfo(dt).bits // 8
            sfx = "" if mode == "fp32" else "_bf16"
            q = torch.randn((1, hq, PREFILL_S, dh), generator=gen,
                            device="cuda").to(dt)
            k = torch.randn((1, hkv, PREFILL_S, dh), generator=gen,
                            device="cuda").to(dt)
            v = torch.randn((1, hkv, PREFILL_S, dh), generator=gen,
                            device="cuda").to(dt)
            got = kernel_ops.attention(q, k, v)
            want = flash_attention_plain(q, k, v)
            S = PREFILL_S
            attn_row(dict(
                kernel="flash_attention" + sfx, layer=f"prefill {mode}",
                shape=[1, hq, hkv, S, dh],
                cut="prefill_32k cut: S 32768 -> 4096, batch 32 -> 1",
                run=lambda q=q, k=k, v=v: kernel_ops.attention(q, k, v),
                plain=lambda q=q, k=k, v=v: flash_attention_plain(q, k, v),
                library=lambda q=q, k=k, v=v: F.scaled_dot_product_attention(
                    q, k, v, is_causal=True, enable_gqa=True),
                ops=4 * hq * dh * S * (S + 1) // 2,
                bytes=es * (2 * q.numel() + k.numel() + v.numel())),
                got, want, mode, arows)
            print(f"[attention] prefill {mode}: cut from prefill_32k "
                  f"(S 32768 -> {S}, batch 32 -> 1) so the full-matrix "
                  f"plain version fits")
            del q, k, v, got, want

            B = DECODE_B
            kc = torch.randn((B, DECODE_S, hkv, dh), generator=gen,
                             device="cuda").to(dt)
            vc = torch.randn((B, DECODE_S, hkv, dh), generator=gen,
                             device="cuda").to(dt)
            for pos in DECODE_POS:
                q = torch.randn((B, hkv, G, dh), generator=gen,
                                device="cuda").to(dt)
                nk = torch.randn((B, hkv, dh), generator=gen,
                                 device="cuda").to(dt)
                nv = torch.randn((B, hkv, dh), generator=gen,
                                 device="cuda").to(dt)
                pos_dev = torch.tensor(pos, dtype=torch.int32, device="cuda")
                kp, vp = kc.clone(), vc.clone()
                want, kp, vp = decode_attention_plain(q, kp, vp, nk, nv,
                                                      pos_dev)
                got, kc, vc = decode_attention(q, kc, vc, nk, nv, pos_dev)
                torch.cuda.synchronize()
                check(torch.equal(kc, kp) and torch.equal(vc, vp),
                      f"decode {mode} pos {pos}: the caches differ from the "
                      f"plain version's after the write")

                def library(q=q, kp=kp, vp=vp, nk=nk, nv=nv, pos=pos):
                    kp[:, pos] = nk
                    vp[:, pos] = nv
                    return F.scaled_dot_product_attention(
                        q.reshape(B, hkv * G, 1, dh),
                        kp[:, :pos + 1].transpose(1, 2),
                        vp[:, :pos + 1].transpose(1, 2), enable_gqa=True)
                n = pos + 1
                attn_row(dict(
                    kernel="decode_attention" + sfx,
                    layer=f"decode {mode} pos {pos}",
                    shape=[B, DECODE_S, hkv, G, dh],
                    cut="decode_32k cut: batch 128 -> 8",
                    run=lambda q=q, nk=nk, nv=nv, p=pos_dev:
                    decode_attention(q, kc, vc, nk, nv, p),
                    plain=lambda q=q, kp=kp, vp=vp, nk=nk, nv=nv, p=pos_dev:
                    decode_attention_plain(q, kp, vp, nk, nv, p),
                    library=library, ops=4 * B * hkv * G * dh * n,
                    bytes=es * B * hkv * dh * (2 * n + 2 * G + 4)),
                    got, want, mode, arows)
                del kp, vp
            del kc, vc
    print("[attention] every kernel within tolerance of its plain version; "
          "decode caches bit-equal to the plain version's after the write")
    phases.done("5")

    # -- 6. the attention layer at full width: the slice's main path --------
    layer = {}
    mrows = []                      # each kernel at the shape this path gives it
    for mode, dt in dtypes.items():
        lgen = torch.Generator(device="cuda").manual_seed(1)
        p = attn.init_attn_params(acfg, dt, lgen)
        x = torch.randn((1, PREFILL_S, acfg.d_model), generator=lgen,
                        device="cuda").to(dt)
        x_new = torch.randn((1, 1, acfg.d_model), generator=lgen,
                            device="cuda").to(dt)
        pos = PREFILL_S - 1
        rtol = KERNEL_RTOL if mode == "fp32" else BF16_RTOL
        es = torch.finfo(dt).bits // 8
        sfx = "" if mode == "fp32" else "_bf16"
        with torch.inference_mode():
            want = attn.attn_forward(p, x, acfg)       # chunked: S > 1024
            positions = torch.arange(PREFILL_S, device="cuda")[None]
            q, k, v = attn._project_qkv(p, x, acfg, positions)
            cache = attn.KVCache(k.contiguous(), v.contiguous())
            want_dec, want_cache = attn.attn_decode(p, x_new, acfg, cache,
                                                    pos)
            torch.cuda.synchronize()
            reset_launches()
            qh, kh, vh = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            o = kernel_ops.attention(qh, kh, vh)
            got = o.transpose(1, 2).reshape(1, PREFILL_S, hq * dh) @ p["wo"]
            pos_dev = torch.tensor(pos, dtype=torch.int32, device="cuda")
            qn, kn, vn = attn._project_qkv(
                p, x_new, acfg, pos_dev.reshape(1, 1))
            qd = qn.reshape(1, hkv, G, dh)
            nk, nv = kn[:, 0].contiguous(), vn[:, 0].contiguous()
            kc, vc = cache.k.clone(), cache.v.clone()
            od, kc, vc = decode_attention(qd, kc, vc, nk, nv, pos_dev)
            got_dec = od.reshape(1, 1, hq * dh) @ p["wo"]
            torch.cuda.synchronize()
            counts = launch_counts()
        p_err = (got.float() - want.float()).abs().max().item()
        p_ratio = attn_ratio(got, want, rtol)
        d_err = (got_dec.float() - want_dec.float()).abs().max().item()
        d_ratio = attn_ratio(got_dec, want_dec, rtol)
        caches_equal = (torch.equal(kc, want_cache.k)
                        and torch.equal(vc, want_cache.v))
        print(f"[layer] {ATTN_ARCH} {mode} B 1 S {PREFILL_S}: attn_forward "
              f"(plain, chunked) vs projections -> ops.attention kernel -> "
              f"wo: max abs err {p_err:.3e}, {p_ratio:.3f} of the allowance "
              f"{rtol:g} x (|plain| + its token's RMS); attn_decode at pos "
              f"{pos} vs projections -> decode_attention kernel -> wo: "
              f"{d_err:.3e}, {d_ratio:.3f} of it; caches bit-equal "
              f"{caches_equal}; launches flash_attention{sfx} "
              f"{counts['flash_attention' + sfx]}, decode_attention{sfx} "
              f"{counts['decode_attention' + sfx]}")
        check(bool(torch.isfinite(got).all() and torch.isfinite(got_dec).all())
              and got.shape == want.shape and got_dec.shape == want_dec.shape,
              f"layer {mode}: outputs not finite or of the wrong shape")
        check(p_ratio <= 1.0, f"layer {mode} prefill: {p_ratio:.3f} x the "
              f"allowance")
        check(d_ratio <= 1.0, f"layer {mode} decode: {d_ratio:.3f} x the "
              f"allowance")
        check(caches_equal, f"layer {mode}: decode caches differ")
        want_counts = {n: int(n in (f"flash_attention{sfx}",
                                    f"decode_attention{sfx}"))
                       for n in counts}
        check(counts == want_counts,
              f"layer {mode} launches {counts} != {want_counts}")
        layer[mode] = {"prefill_err": p_err, "prefill_ratio": p_ratio,
                       "decode_err": d_err, "decode_ratio": d_ratio,
                       "launches": counts}

        # each kernel vs its plain version on the inputs this path gave it,
        # timed (after the counts were read)
        with torch.inference_mode():
            S = PREFILL_S
            attn_row(dict(
                kernel="flash_attention" + sfx, layer=f"layer prefill {mode}",
                shape=[1, hq, hkv, S, dh],
                run=lambda qh=qh, kh=kh, vh=vh:
                kernel_ops.attention(qh, kh, vh),
                plain=lambda qh=qh, kh=kh, vh=vh:
                flash_attention_plain(qh, kh, vh),
                library=lambda qh=qh, kh=kh, vh=vh:
                F.scaled_dot_product_attention(qh, kh, vh, is_causal=True,
                                               enable_gqa=True),
                ops=4 * hq * dh * S * (S + 1) // 2,
                bytes=es * (2 * qh.numel() + kh.numel() + vh.numel())),
                o, flash_attention_plain(qh, kh, vh), mode, mrows)
            kp, vp = cache.k.clone(), cache.v.clone()
            want_od, kp, vp = decode_attention_plain(qd, kp, vp, nk, nv,
                                                     pos_dev)
            torch.cuda.synchronize()
            check(torch.equal(kc, kp) and torch.equal(vc, vp),
                  f"layer decode {mode}: the caches differ from the plain "
                  f"version's after the write")

            def library(qd=qd, kp=kp, vp=vp, nk=nk, nv=nv, pos=pos):
                kp[:, pos] = nk
                vp[:, pos] = nv
                return F.scaled_dot_product_attention(
                    qd.reshape(1, hq, 1, dh),
                    kp[:, :pos + 1].transpose(1, 2),
                    vp[:, :pos + 1].transpose(1, 2), enable_gqa=True)
            n = pos + 1
            attn_row(dict(
                kernel="decode_attention" + sfx, layer=f"layer decode {mode}",
                shape=[1, PREFILL_S, hkv, G, dh],
                run=lambda qd=qd, kc=kc, vc=vc, nk=nk, nv=nv, p=pos_dev:
                decode_attention(qd, kc, vc, nk, nv, p),
                plain=lambda qd=qd, kp=kp, vp=vp, nk=nk, nv=nv, p=pos_dev:
                decode_attention_plain(qd, kp, vp, nk, nv, p),
                library=library, ops=4 * hkv * G * dh * n,
                bytes=es * hkv * dh * (2 * n + 2 * G + 4)),
                od, want_od, mode, mrows)
        del p, x, q, k, v, qh, kh, vh, o, cache, want, got, want_cache
        del kc, vc, kp, vp
    phases.done("6")

    # -- 7. VGG-16 at full width, fp32 and int8 ------------------------------
    def forward_launches(model, xb, expect, tag):
        """One forward through the entry point with the counts set to 0
        just before it and read just after; they must equal ``expect``."""
        reset_launches()
        out = model.forward(xb)
        torch.cuda.synchronize()
        counts = launch_counts()
        print(f"[{tag}] launches {counts}")
        check(counts == expect, f"{tag} launches {counts} != {expect}")
        check(tuple(out.shape) == (BATCH, model.cfg.n_classes)
              and bool(torch.isfinite(out).all()),
              f"{tag}: logits not finite or of the wrong shape")
        return out, counts

    vcfg = get_config("vgg16")
    vgen = torch.Generator(device="cuda").manual_seed(2)
    vparams = with_biases(compile_cnn(vcfg, spec, generator=vgen,
                                      device="cuda").params, vgen)
    x_vgg = torch.randn((BATCH, vcfg.input_hw, vcfg.input_hw, vcfg.input_ch),
                        generator=vgen, device="cuda")
    vcompiled = compile_cnn(vcfg, spec, vparams, device="cuda")
    vrows, v_plain = float_rows(vcfg, vparams, x_vgg, "fp32")
    vlogits, vlaunches = forward_launches(vcompiled, x_vgg, EXPECTED_VGG,
                                          "vgg16 forward")
    v_err = (vlogits - v_plain).abs().max().item()
    v_tol = LOGIT_RTOL * v_plain.abs().max().item()
    print(f"[vgg16 forward] logits vs the fold over the plain versions (TF32 "
          f"off): max abs err {v_err:.3e} (tol {v_tol:.3e} = {LOGIT_RTOL} x "
          f"max|logit|)")
    check(v_err <= v_tol, f"vgg16 logits differ from the plain fold: "
          f"{v_err} > {v_tol}")
    vfwd_ms = time_ms(lambda: vcompiled.forward(x_vgg))
    t0 = time.perf_counter()
    vqcompiled = compile_cnn(vcfg, qspec, vparams, device="cuda")
    print(f"[vgg16 int8] calibrated on the default batch "
          f"({qspec.precision.calib} images, on the card) in "
          f"{time.perf_counter() - t0:.2f} s")
    vqrows, vq_plain = int8_rows(vcfg, vqcompiled.params, x_vgg)
    sums.update(cnn_sums(vcfg, vrows, vqrows))
    vqlogits, vqlaunches = forward_launches(vqcompiled, x_vgg,
                                            EXPECTED_VGG_INT8,
                                            "vgg16 int8 forward")
    vq_differ = int((vqlogits != vq_plain).sum())
    vq_top1 = (vqlogits.argmax(-1) == vlogits.argmax(-1)).float().mean().item()
    print(f"[vgg16 int8 forward] logits vs the fold over the plain versions: "
          f"{vq_differ} of {vqlogits.numel()} differ (bit-equal required); "
          f"top-1 agreement with the fp32 forward {vq_top1:.0%}")
    check(vq_differ == 0, "vgg16 int8 logits differ from the plain fold")
    vqfwd_ms = time_ms(lambda: vqcompiled.forward(x_vgg))
    print(f"[vgg16 forward] batch {BATCH}: fp32 {vfwd_ms:.3f} ms, int8 "
          f"{vqfwd_ms:.3f} ms median")
    phases.done("7")

    # -- 8. the bf16 kernel modes vs their plain versions ---------------------
    bspec = ExecutionSpec(precision=Precision(dtype="bfloat16"),
                          serving=Serving(batch=BATCH))
    bf16 = {}
    for bcfg, bparams, xb, c32, l32 in (
            (cfg, params, x_alex, compiled, logits),
            (vcfg, vparams, x_vgg, vcompiled, vlogits)):
        bc = compile_cnn(bcfg, bspec, bparams, device="cuda")
        xb16 = xb.to(torch.bfloat16)
        brows, b_plain = float_rows(bcfg, bc.params, xb16, "bf16")
        bf16[bcfg.name] = dict(compiled=bc, x=xb16, rows=brows,
                               plain=b_plain, fp32_logits=l32)
        sums[bcfg.name, "conv_pipe_bf16"] = model_sum(
            bcfg, brows, "conv_pipe_bf16", "cuDNN bf16 conv+ReLU+pool")
        sums[bcfg.name, "matmul_pipe_bf16"] = model_sum(
            bcfg, brows, "matmul_pipe_bf16", "cuBLAS bf16 addmm+ReLU")
    phases.done("8")

    # -- 9. the bf16 forwards through the entry point -----------------------
    for arch, b in bf16.items():
        out, counts = forward_launches(b["compiled"], b["x"],
                                       EXPECTED_BF16[arch],
                                       f"{arch} bf16 forward")
        check(out.dtype == torch.bfloat16, f"{arch} bf16 logits: {out.dtype}")
        b_err = (out.float() - b["plain"].float()).abs().max().item()
        b_tol = BF16_LOGIT_RTOL * b["plain"].float().abs().max().item()
        b_top1 = (out.float().argmax(-1)
                  == b["fp32_logits"].argmax(-1)).float().mean().item()
        b_ms = time_ms(lambda c=b["compiled"], xb=b["x"]: c.forward(xb))
        print(f"[{arch} bf16 forward] logits vs the fold over the plain "
              f"versions: max abs err {b_err:.3e} (tol {b_tol:.3e} = "
              f"{BF16_LOGIT_RTOL} x max|logit|), "
              f"{bf16_ulps(out, b['plain']):.1f} bf16 ulps; top-1 agreement "
              f"with the fp32 forward {b_top1:.0%}; batch {BATCH}: "
              f"{b_ms:.3f} ms median")
        check(b_err <= b_tol, f"{arch} bf16 logits differ from the plain "
              f"fold: {b_err} > {b_tol}")
        b.update(logits=out, launches=counts, logit_err=b_err,
                 logit_tol=b_tol,
                 top1_vs_fp32=b_top1, ms=b_ms)
    phases.done("9")

    # -- 10. bf16 serve -------------------------------------------------------
    brep, blat = serve(bf16["vgg16"]["compiled"], EXPECTED_BF16["vgg16"],
                       "vgg16 bf16 serve")
    phases.done("10")

    # -- 12. plans: the DSE on the card ---------------------------------------
    from repro_torch.kernels import autotune
    from repro_torch.kernels import conv_pipe as cp_mod
    from repro_torch.kernels import matmul_pipe as mp_mod
    from repro_torch.models.cnn import (cnn_forward_stage,
                                        cnn_forward_stage_quant)
    from repro_torch.obs import profiler
    from repro_torch.pipeline import PlanTable
    from repro_torch.serve.stage_planner import group_io_shapes, group_shape

    plans_out = {"smem": {}, "default": {}, "pinned": {}, "measured": {},
                 "refine": [], "modeled_serve": {}}
    n_inst = 0
    for dt in (torch.float32, torch.bfloat16, torch.int8):
        for cg in ((16, 3) if dt == torch.int8 else (16,)):
            for tp, tn in itertools.product(cp_mod.POSITIONS,
                                            cp_mod.CHANNELS):
                want_smem = cp_mod.library_smem(dt, tp, tn, cg)
                check(cp_mod.conv_smem(dt, tp, tn, cg) == want_smem,
                      f"conv {dt} {tp}x{tn} (cg {cg}): the table's "
                      f"{cp_mod.conv_smem(dt, tp, tn, cg)} B != the "
                      f"kernel's {want_smem} B")
                n_inst += 1
        for tnf in mp_mod.FC_FEATURES[dt]:
            check(mp_mod.fc_smem(dt, tnf) == mp_mod.library_smem(dt, tnf),
                  f"matmul {dt} {tnf}: the table's shared memory differs "
                  f"from the kernel's")
            n_inst += 1
    print(f"[plans] the shared-memory table equals what each of the {n_inst} "
          f"instantiations requests (conv_pipe_smem, matmul_pipe_smem)")

    def shapes_of(mcfg, dtype):
        """(group, kind, shape) of every conv and fc group at batch 8."""
        out = []
        for g, i, o in group_io_shapes(mcfg):
            sh = group_shape(mcfg, g, i, o, BATCH, dtype)
            if sh is not None:
                out.append((g, "conv" if isinstance(sh, autotune.ConvShape)
                            else "gemm", sh))
        return out

    def rule_of(kind, sh):
        """The tile or split the wrapper's rule picks on this card."""
        dt = getattr(torch, sh.dtype)
        if kind == "conv":
            return conv_tile(dt, sh.b, sh.oh, sh.ow, sh.m // sh.groups,
                             sh.groups, sh.pool, sh.pool_k, sh.pool_s,
                             prof.sms, sh.c // sh.groups)
        return fc_split(dt, sh.m, sh.k, sh.n, prof.sms)

    def knob(plan):
        return plan.tile if isinstance(plan, autotune.ConvPlan) else plan.split

    def plan_str(plan):
        return ("x".join(map(str, plan.tile[:2])) + f" ({plan.tph}x{plan.tpw})"
                if isinstance(plan, autotune.ConvPlan)
                else f"{plan.tnf}f x {plan.ranks}r")

    def bound_ms(kind, sh):
        t_ops, t_bytes = (autotune.conv_bound(sh, prof) if kind == "conv"
                          else autotune.gemm_bound(sh, prof))
        return max(t_ops, t_bytes) * 1e3

    def plainless_fold(c, xb):
        """The fold with no plan: each wrapper's own rule."""
        with torch.inference_mode():
            if c.quant:
                return cnn_forward_stage_quant(c.params, xb, c.cfg,
                                               c.model.groups)
            return cnn_forward_stage(c.params, xb, c.cfg, c.model.groups)

    def spy_launch(c, xb):
        """One forward with the counts set to 0 just before it, each
        wrapper call's tile or split recorded."""
        seen = []
        real = kernel_ops.conv_pipe, kernel_ops.matmul_pipe

        def conv(*a, tile=None, **kw):
            seen.append(tile)
            return real[0](*a, tile=tile, **kw)

        def fc(*a, split=None, **kw):
            seen.append(split)
            return real[1](*a, split=split, **kw)
        kernel_ops.conv_pipe, kernel_ops.matmul_pipe = conv, fc
        try:
            reset_launches()
            out = c.forward(xb)
            torch.cuda.synchronize()
            counts = launch_counts()
        finally:
            kernel_ops.conv_pipe, kernel_ops.matmul_pipe = real
        return out, counts, seen

    plan_cases = {
        "vgg16 fp32": (vcfg, spec, vparams, x_vgg, vlogits, v_plain,
                       EXPECTED_VGG),
        "vgg16 int8": (vcfg, qspec, vqcompiled.params, x_vgg, vqlogits,
                       vq_plain, EXPECTED_VGG_INT8),
        "vgg16 bf16": (vcfg, bspec, bf16["vgg16"]["compiled"].params,
                       bf16["vgg16"]["x"], bf16["vgg16"]["logits"],
                       bf16["vgg16"]["plain"], EXPECTED_BF16["vgg16"]),
        "alexnet fp32": (cfg, spec, params, x_alex, logits, a_plain,
                         EXPECTED_LAUNCHES)}
    plan_dir = os.path.join(ROOT, "build", "plans")
    os.makedirs(plan_dir, exist_ok=True)
    for tag, (mcfg, mspec, mparams, xb, ref_logits, plain_logits,
              expect) in plan_cases.items():
        # default plans: the rules' tiles, the logits and launches of today
        autotune.reset_sweep_stats()
        c = compile_cnn(mcfg, mspec, mparams, device="cuda")
        shapes = shapes_of(mcfg, mspec.run_dtype)
        check(sorted(c.group_plans) == [g for g, _, _ in shapes],
              f"{tag}: plans for {sorted(c.group_plans)}")
        for g, kind, sh in shapes:
            check(knob(c.group_plans[g]) == rule_of(kind, sh),
                  f"{tag} {g}: plan {knob(c.group_plans[g])} != the rule's "
                  f"{rule_of(kind, sh)}")
        out, counts, seen = spy_launch(c, xb)
        check(counts == expect, f"{tag} default plans: launches {counts}")
        check(seen == [knob(c.group_plans[g]) for g, _, _ in shapes],
              f"{tag}: the kernels were launched with {seen}")
        check(torch.equal(out, ref_logits), f"{tag}: default-plan logits "
              f"differ from the earlier phase's forward")
        check(torch.equal(out, plainless_fold(c, xb)),
              f"{tag}: default-plan logits differ from the fold without "
              f"plans")
        tbl = c.plans()
        n_conv = sum(k == "conv" for _, k, _ in shapes)
        print(f"[plans] {tag}: default plans = the rules' tiles and splits "
              f"on {len(shapes)} groups ({n_conv} conv + "
              f"{len(shapes) - n_conv} fc; {tbl.summary()} distinct rows), "
              f"launches {dict((k, v) for k, v in counts.items() if v)}, "
              f"logits torch.equal to the earlier forward and to the fold "
              f"without plans")
        # a saved table reloads exactly, with no sweep
        path = os.path.join(plan_dir, f"{tag.replace(' ', '_')}.json")
        c.save_plan(path)
        autotune.clear_registry()
        autotune.reset_sweep_stats()
        c2 = compile_cnn(mcfg, mspec, mparams, device="cuda",
                         plan_path=path)
        sweeps = autotune.sweep_stats()
        with open(path) as f:
            same = f.read() == c2.plans().to_json()
        out2 = c2.forward(xb)
        check(sweeps["conv_sweeps"] == 0 and sweeps["gemm_sweeps"] == 0
              and same and torch.equal(out2, out),
              f"{tag}: reloaded table: sweeps {sweeps}, byte-identical "
              f"{same}, logits equal {torch.equal(out2, out)}")
        print(f"[plans] {tag}: save_plan -> compile_cnn(plan_path=) ran "
              f"{sweeps['conv_sweeps']} + {sweeps['gemm_sweeps']} sweeps, "
              f"table byte-identical, logits torch.equal")
        plans_out["default"][tag] = {
            "table": tbl.summary(), "launches": counts,
            "plans": {str(g): c.group_plans[g].to_dict()
                      for g, _, _ in shapes}}

        # pinned: another fitting plan on every group reaches its kernel
        pinned, rows_c, rows_g = {}, [], []
        for g, kind, sh in shapes:
            cands = profiler.shortlist(sh, 99, backend=c.backend)
            pinned[g] = next(p for p in cands
                             if knob(p) != knob(c.group_plans[g]))
            (rows_c if kind == "conv" else rows_g).append(
                {"shape": dataclasses.asdict(sh), "backend": c.backend,
                 "vmem_budget": mspec.tiling.vmem_budget,
                 "plan": pinned[g].to_dict()})
        autotune.clear_registry()
        cp3 = compile_cnn(mcfg, mspec, mparams, device="cuda",
                          plans=PlanTable.from_rows(rows_c, rows_g))
        out3, counts3, seen3 = spy_launch(cp3, xb)
        check(seen3 == [knob(pinned[g]) for g, _, _ in shapes],
              f"{tag}: pinned plans launched as {seen3}")
        check(counts3 == expect, f"{tag} pinned: launches {counts3}")
        if "int8" in tag:
            p_err, p_tol = int((out3 != plain_logits).sum()), 0
            check(p_err == 0, f"{tag} pinned: {p_err} logits differ from "
                  f"the plain fold")
        else:
            p_err = (out3.float() - plain_logits.float()).abs().max().item()
            p_tol = (BF16_LOGIT_RTOL if "bf16" in tag else LOGIT_RTOL) * \
                plain_logits.float().abs().max().item()
            check(p_err <= p_tol, f"{tag} pinned: {p_err} > {p_tol}")
        print(f"[plans] {tag}: pinned {len(pinned)} non-default plans, each "
              f"reaching its kernel, launches as before; vs the plain fold: "
              f"{'differing logits' if 'int8' in tag else 'max abs err'} "
              f"{p_err:.4g} (allowed {p_tol:.4g})")
        print(f"[plans] {tag}: pinned " + ", ".join(
            f"{g}: {plan_str(c.group_plans[g])} -> {plan_str(pinned[g])}"
            for g, _, _ in shapes))
        plans_out["pinned"][tag] = {
            "err": p_err, "tol": p_tol,
            "plans": {str(g): pinned[g].to_dict() for g, _, _ in shapes}}
        autotune.clear_registry()
        del c, c2, cp3, out2, out3

    # a plan that does not fit raises: the wrapper, and a compile
    g12, _, sh12 = shapes_of(vcfg, "float32")[1]        # conv1_2 + pool
    x12 = torch.zeros((BATCH, sh12.h, sh12.w, sh12.c), device="cuda")
    w12 = torch.zeros((3, 3, sh12.c, sh12.m), device="cuda")
    bad = autotune.ConvPlan(64, 64, 8, 8)   # a 16x16 patch over 64 rows
    for what, fn in (
            ("conv_pipe(tile=(64, 64, 8, 8))", lambda: conv_pipe(
                x12, w12, torch.zeros(sh12.m, device="cuda"), pad=1,
                pool="max", tile=bad.tile)),
            ("compile_cnn(plans=) with it", lambda: compile_cnn(
                vcfg, spec, vparams, device="cuda", plans=PlanTable.from_rows(
                    [{"shape": dataclasses.asdict(sh12),
                      "backend": prof.tag,
                      "vmem_budget": spec.tiling.vmem_budget,
                      "plan": bad.to_dict()}], [])))):
        autotune.clear_registry()
        try:
            fn()
        except ValueError as e:
            print(f"[plans] {what} on VGG-16 {g12} raises: {e}")
        else:
            check(False, f"{what} did not raise")
    autotune.clear_registry()

    # measured tables: t_model against the stopwatch, one row a group
    mopts = profiler.MeasureOptions(warmup=2, iters=20, repeats=5, trim=1)
    n_low = 0
    for tag, (mcfg, mspec, mparams) in (
            ("vgg16 fp32", (vcfg, spec, vparams)),
            ("vgg16 int8", (vcfg, qspec, vqcompiled.params)),
            ("vgg16 bf16", (vcfg, bspec, bf16["vgg16"]["compiled"].params))):
        c = compile_cnn(mcfg, mspec, mparams, device="cuda", measure=True,
                        measure_opts=mopts)
        kinds = {g: (k, sh) for g, k, sh in shapes_of(mcfg, mspec.run_dtype)}
        meas_rows = []
        for r in c.roofline_breakdown():
            g = tuple(r["group"])
            kind, sh = kinds[g]
            t_meas = r["t_measured"]
            check(t_meas is not None and 0 < t_meas < 1,
                  f"{tag} {g}: t_measured {t_meas}")
            drift = r["drift"]
            n_low += drift < 1
            meas_rows.append({"group": list(g), "plan": r["plan"],
                          "t_model_ms": r["t_model"] * 1e3,
                          "t_measured_ms": t_meas * 1e3, "drift": drift,
                          "bound_ms": bound_ms(kind, sh)})
            plan = (autotune.ConvPlan(**r["plan"]) if kind == "conv"
                    else autotune.GemmPlan(**r["plan"]))
            print(f"[measured] {tag} {str(g):<9} {plan_str(plan):<16} "
                  f"t_model {r['t_model'] * 1e3:.4f} ms  t_measured "
                  f"{t_meas * 1e3:.4f} ms  drift {drift:.3f}"
                  f"{'  (< 1: the model is wrong)' if drift < 1 else ''}  "
                  f"bound {bound_ms(kind, sh):.4f} ms")
        prov = c.plans().provenance["measurement"]
        plans_out["measured"][tag] = {"rows": meas_rows, "provenance": prov}
        print(f"[measured] {tag}: {c.plans().summary()}, "
              f"{json.dumps(prov['measure_stats'])}, backend "
              f"{json.dumps(prov['backend'])}")
        del c
    print(f"[measured] rows with drift below 1 (the model slower than the "
          f"card): {n_low}")

    # the stopwatch against the rule and the model
    vshapes = {(m, g): (k, sh) for m in ("float32", "int8", "bfloat16")
               for g, k, sh in shapes_of(vcfg, m)}
    for what, mode, g in (("conv4_2", "bfloat16", (11,)),
                          ("conv5_1", "float32", (14,)),
                          ("conv1_1", "int8", (0,)),
                          ("fc6", "float32", (18,)), ("fc6", "int8", (18,)),
                          ("fc6", "bfloat16", (18,))):
        kind, sh = vshapes[mode, g]
        best, recs = profiler.refine_plan(sh, top_k=4, opts=mopts,
                                          backend=prof.tag)
        rule = (autotune.rule_plan(sh, backend=prof.tag) if kind == "conv"
                else autotune.rule_gemm_plan(sh, backend=prof.tag))
        rrec = profiler.measure_record(kind, sh, rule, opts=mopts)
        fastest = min([(r["t_measured"], r["plan"]) for r in recs]
                      + [(rrec["t_measured"], rule.to_dict())],
                      key=lambda t: t[0])
        model = recs[0]
        beats = fastest[0] < rrec["t_measured"]
        plans_out["refine"].append({
            "layer": what, "mode": mode, "group": list(g),
            "candidates": recs, "rule": rule.to_dict(),
            "rule_ms": rrec["t_measured"] * 1e3,
            "stopwatch": fastest[1], "stopwatch_ms": fastest[0] * 1e3,
            "bound_ms": bound_ms(kind, sh), "beats_rule": beats})

        def show(plan_d, t):
            p = (autotune.ConvPlan(**plan_d) if kind == "conv"
                 else autotune.GemmPlan(**plan_d))
            return f"{plan_str(p)} {t * 1e3:.4f} ms"
        print(f"[refine] vgg16 {what} {mode}: model "
              f"{show(model['plan'], model['t_measured'])} (modelled "
              f"{model['t_model_call'] * 1e3:.4f}); rule "
              f"{show(rule.to_dict(), rrec['t_measured'])}; stopwatch "
              f"{show(fastest[1], fastest[0])}"
              f"{' (beats the rule)' if beats else ''}; candidates "
              + ", ".join(show(r["plan"], r["t_measured"]) for r in recs)
              + f"; bound {bound_ms(kind, sh):.4f} ms")

    # the modelled clock: phase 4's requests through AlexNet fp32
    for execute in (False, True):
        mc = compile_cnn(cfg, ExecutionSpec(serving=Serving(
            batch=BATCH, clock="modeled", execute=execute)), params,
            device="cuda")
        reqs = synthetic_requests(n_req, cfg.input_hw, cfg.input_ch, 200.0)
        reset_launches()
        mrep = mc.serve(reqs)
        torch.cuda.synchronize()
        served = launch_counts()
        done = sorted(mrep.completions, key=lambda d: d.rid)
        check([d.rid for d in done] == list(range(n_req))
              and all(d.status == "ok" for d in done),
              f"modelled clock (execute={execute}): {len(done)} "
              f"completions for {n_req} requests")
        if execute:
            imgs = torch.from_numpy(np.stack([r.image for r in reqs])).cuda()
            preds = torch.cat([mc.forward(imgs[i:i + BATCH]).argmax(-1)
                               for i in range(0, n_req, BATCH)]).tolist()
            check([d.pred for d in done] == preds,
                  "modelled clock: predictions differ from the forward's")
        else:
            check(all(d.pred == -1 for d in done)
                  and not any(served.values()),
                  f"execute=False ran something: {served}")
        mlat = latency_report(mrep.completions)
        plans_out["modeled_serve"][str(execute)] = {
            "report": mrep.to_dict(), "latency": mlat,
            "t_round_model": mc.engine.t_round_model}
        print(f"[modeled] execute={execute}: {mrep.summary()}; round "
              f"{mc.engine.t_round_model * 1e3:.4f} ms modelled; p50 "
              f"{mlat['p50_ms']:.4f} ms modelled beside phase 4's measured "
              f"{lat['p50_ms']:.4f} ms")
    phases.done("12")

    # -- 11. the kernels line -------------------------------------------------
    # CNN entries sum one AlexNet and one VGG-16 forward's launches in their
    # mode (fp32 phases 2, 3 and 7; int8 2b, 3b and 7; bf16 8 and 9), with
    # each model's share under "models"; attention entries are the one
    # launch of phase 6's main path, at its shape
    def entry(kname, rs, rate, count):
        rs = [r for r in rs if r["kernel"] == kname]
        t_ops = sum(r["ops"] for r in rs) / rate
        t_bytes = sum(r["bytes"] for r in rs) / bw
        libs = [r["library_ms"] for r in rs]
        return {"launches": count[kname],
                "max_abs_err": max(r["max_abs_err"] for r in rs),
                "ms": sum(r["ms"] for r in rs),
                "plain_ms": sum(r["plain_ms"] for r in rs),
                "bound_ms": sum(r["bound_ms"] for r in rs),
                "bound_by": "operations" if t_ops >= t_bytes else "bytes",
                "library_ms": None if None in libs else sum(libs)}

    cnn = {"fp32": {"alexnet": (rows, launches), "vgg16": (vrows, vlaunches)},
           "int8": {"alexnet": (qrows, qlaunches),
                    "vgg16": (vqrows, vqlaunches)},
           "bf16": {a: (b["rows"], b["launches"]) for a, b in bf16.items()}}
    line = []
    for kname, mode, rate in (
            ("conv_pipe", "fp32", fp32_rate),
            ("conv_pipe_s8", "int8", int8_rate),
            ("conv_pipe_bf16", "bf16", bf16_rate),
            ("matmul_pipe", "fp32", fp32_rate),
            ("matmul_pipe_s8", "int8", int8_rate),
            ("matmul_pipe_bf16", "bf16", bf16_rate),
            ("lrn_pwl", "fp32", fp32_rate),
            ("lrn_pwl_bf16", "bf16", bf16_rate),
            ("flash_attention", "fp32", fp32_rate),
            ("flash_attention_bf16", "bf16", bf16_rate),
            ("decode_attention", "fp32", fp32_rate),
            ("decode_attention_bf16", "bf16", bf16_rate)):
        base = kname.removesuffix("_s8").removesuffix("_bf16")
        e = {"name": kname, "mode": mode, "route": "cuda",
             "source": f"src/repro_torch/csrc/{base}.cu",
             "replaces": REPLACES[base]}
        if base in ("flash_attention", "decode_attention"):
            e.update(entry(kname, mrows, rate, layer[mode]["launches"]))
            e["shape"] = [r for r in mrows if r["kernel"] == kname][0][
                "shape"]
        else:                       # both models' forwards in this mode
            models = {a: entry(kname, rs, rate, count)
                      for a, (rs, count) in cnn[mode].items() if count[kname]}
            e.update(entry(kname, [r for a in models for r in cnn[mode][a][0]],
                           rate, {kname: sum(m["launches"]
                                             for m in models.values())}))
            e["models"] = models
        line.append(e)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "device": name, "fp32_rate": fp32_rate,
                   "int8_rate": int8_rate, "bf16_rate": bf16_rate,
                   "mem_bw": bw, "attention_rows": arows,
                   "attention_layer": layer, "attention_layer_rows": mrows,
                   "mem_bw_source": bw_src, "rows": rows, "int8_rows": qrows,
                   "kernels": line,
                   "forward": {"ms": fwd_ms, "logit_err": err,
                               "logit_tol": tol, "top1": top1,
                               "launches": launches},
                   "serve": {"report": rep.to_dict(), "latency": lat},
                   "int8_forward": {"ms": qfwd_ms, "logits_differ": q_differ,
                                    "top1_vs_fp32": q_top1,
                                    "err_vs_oracles": o_err,
                                    "top1_vs_oracles": o_top1,
                                    "launches": qlaunches,
                                    "in_scale": qp.in_scale},
                   "int8_serve": {"report": qrep.to_dict(),
                                  "latency": qlat},
                   "vgg16": {"rows": vrows, "int8_rows": vqrows,
                             "forward": {"ms": vfwd_ms, "logit_err": v_err,
                                         "logit_tol": v_tol,
                                         "launches": vlaunches},
                             "int8_forward": {"ms": vqfwd_ms,
                                              "logits_differ": vq_differ,
                                              "top1_vs_fp32": vq_top1,
                                              "launches": vqlaunches}},
                   "bf16": {a: {k: v for k, v in b.items()
                                if k not in ("compiled", "x", "plain",
                                             "fp32_logits", "logits")}
                            for a, b in bf16.items()},
                   "bf16_serve": {"report": brep.to_dict(), "latency": blat},
                   "redesign_sums": {f"{a} {k}": v
                                     for (a, k), v in sums.items()},
                   "plans": plans_out,
                   "phase_seconds": phases.seconds},
                  f, indent=1, sort_keys=True)
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
