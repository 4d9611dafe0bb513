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
13. The fleet at full width (``ROADMAP.md`` Queue 1 slice 6): AlexNet,
   batch 8, the weights of phase 3, compiled as dp (2 replicas), pp (2
   stages, 4 microbatches) and hybrid (2 x 2), each replica or stage a
   CUDA stream. Phase 4's 19 requests through each on the measured clock:
   every request one ``ok`` completion with phase 3's forward's
   prediction for its image, and the counters R x (5 conv, 2 lrn, 3
   matmul) a round in dp and the same a microbatch in pp, over the
   rounds and one warm-up round. Each mode's measured round (four full
   rounds of a burst, timed the second time) beside single mode's. The pp
   forward through the stage streams: int8 ``torch.equal`` to phase 3b's
   logits, fp32 within 1e-4 x max|logit| of phase 3's. On dp with
   ``retries=2``: replica 0 failing at 20 ms and recovering at 40 ms
   (plus its modelled restore), then an fp32 -> int8 ``hot_swap`` from
   20 ms, each over the 19 images arriving at 50 a second: no request
   stranded, every ok prediction its version's forward's, the counters
   printed.
14. Artifacts at full width (slice 5): VGG-16 fp32, int8 and bf16 of
   phases 7 and 8, ``save`` -> ``CompiledCNN.load`` on the card (the
   registry cleared first: no sweep) -> ``save`` in a temporary
   directory the phase removes: logits ``torch.equal`` to the compiled
   forward's, ``manifest.json`` and ``plan_table.json`` byte-identical;
   the artifact's bytes, the wall time of the save and of the load, and
   the restore model's time for those bytes (the reference's 2 GB/s + 5
   ms, a model).
15. Slice 7 at full width (``ROADMAP.md`` Queue 1 slice 7): AlexNet,
   batch 8, the weights of phase 3, fp32 and phase 3b's int8, served by
   the continuous scheduler on the modelled clock with the kernels on the
   card (``execute=True``, 2 replicas, ``retries=2``, ``steal_threshold=2``,
   ``AutoscalePolicy(min_replicas=1, max_replicas=4)``): phase 4's 19
   requests with a straggler (cost 4) at every 5th, then a burst of 32 at
   one instant. Every request one completion or one rejection, every ok
   prediction phase 3's (3b's) forward's for its image, and the launch
   counters exactly admission groups x (5 conv, 2 lrn, 3 matmul); steals
   and scale events printed. Both runs traced and metered:
   ``validate_trace``, ``validate_metrics`` and ``reconcile`` find no
   problem, and a repeat of the fp32 run traces the same bytes; phase 4's
   gang serve on the measured clock, traced, reconciles too.
   ``compile_cnn(trace=, measure=True)`` for VGG-16 fp32 records one
   ``sweep`` span and one ``measure`` span a plan; ``drift_report`` of
   phase 12's three measured tables passes ``validate_drift``;
   ``verify(strict=True)`` of phases 7-9's VGG-16 compiles and
   ``verify_artifact`` of phase 14's artifacts find nothing, and a row's
   ``smem_bytes`` past the budget is RPA301 or RPA302. Printed only: the
   host time of one admission group's forward and of the scheduler a
   request, and the modelled p50/p95 of continuous against gang.
16. Slice 8a, the LM serving path (``ROADMAP.md`` Queue 1 slice 8a),
   plain PyTorch on the card as JAX's LM is plain XLA: seeded random
   weights, batch 4, 16 greedy tokens through ``launch.serve.generate``.
   Qwen3-8B at full width and depth (36 layers, d_model 4096, 32/8 heads,
   vocab 151936) in bf16 and in fp32 (TF32 off) on a 1152-token prompt
   (the chunked attention with a ragged last KV chunk); zamba2-1.2b
   (hybrid, 7 shared-attention applications, a remainder SSM chunk) and
   xlstm-125m at full depth in bf16 and fp32 on 200-token prompts;
   dbrx-132b (MoE) at full width cut to 2 of its 40 layers, bf16. Each
   run: the prefill's last logits against ``lm.forward``'s last row and
   one decode step against ``lm.forward`` on the prompt plus that token,
   within 1e-3 x max|logit| in fp32 and 2e-2 in bf16, except where bf16
   rounding alone moves the logits by more than that (Qwen3-8B and
   zamba2, ``LM_RUNS``): there the bf16 decode must be no farther from
   its fp32 twin's forward (the same seed) than its own forward is, plus
   2e-2; dbrx's decode is held to shape and finiteness only, since its
   capacity drops change with the tokens a group;
   every generated id below the vocab, every logit finite. Printed: the
   prefill time, the decode step time (CUDA events, the median of 15)
   and tokens/s beside the weights' byte bound, the peak memory. Then
   Qwen3-8B at full width cut to 2 layers, fp32: the card's forward
   within 1e-3 x max|logit| of the CPU's on the same parameters. No
   kernel launch counter moves across the phase.
17. Slice 8b, the LM training path (``ROADMAP.md`` Queue 1 slice 8b),
   plain PyTorch on the card as JAX's ``train_step`` is plain XLA:
   ``ResilientLoop`` without checkpoints, each config in its own dtype
   (bf16 parameters, fp32 AdamW state) with its remat ("full"), seeded
   random weights, the Markov token stream. Qwen3-8B at full width cut to
   8 of its 36 layers, batch 2 x 4096 tokens (``train_4k`` cut from
   batch 256), 6 steps; zamba2-1.2b (6 steps) and xlstm-125m (4) at full
   width and depth, batch 4 x 512. Gates: no restart; every loss and
   grad norm finite; the first loss within 0.1 of ln V + var / 2 (var the
   variance of the fp32 forward's logits: random logits' expected loss)
   and within 2e-2 relative of the fp32 forward's loss on the same
   weights and batch; every random parameter leaf moved. Printed: the
   step time (CUDA events, the median of the steps between the first and
   the last), tokens/s, the products of step 1 by dtype (counted by a
   dispatch mode) and their bound at the card's peaks, the share of it
   reached, the peak memory, and from a ``torch.profiler`` trace of the
   last step its kernels' time (the card's busy and idle share of the
   untraced step), the GEMMs' and the top three kernels'. Then checkpoint and restore: xlstm-125m at full size,
   8 steps with checkpoints every 4 and a fault at step 6: one restart,
   the re-run steps' losses within 1e-3 of the first run's, the committed
   step-8 checkpoint reloading ``torch.equal``, save and load GB/s. Then
   one fp32 step of xlstm-125m at full width (2 layers, B 2 x S 128) on
   the card against the CPU: loss within 1e-5 relative, each gradient
   leaf within 1e-4 x its max, the update on the same gradients within
   1e-5 x max|p| + 1e-6. No kernel launch counter moves.
18. Slice 7b (``ROADMAP.md`` Queue 1): the lint of the whole port
   (``python -m repro_torch.analysis --lint`` in process, against
   ``src/repro_torch/analysis/baseline.json``) must end with 0 findings
   and 0 baselined. Then the paper's claim on the card: each of VGG-16's
   five conv+pool groups (conv1_2 ... conv5_3 + pool) at batch 8, in fp32,
   bf16 and int8 with the weights of phases 7 and 8, on the input the
   forward gives it, runs fused (one ``conv_pipe`` launch with the pool,
   the compiled plan's tile) and unfused (the same ``conv_pipe`` at the
   same (tp, tn) without the pool, then ``kernels/ref.pool_ref``); the two
   outputs must be ``torch.equal``. Printed: both times, as timed and in a
   CUDA graph, beside ``core/pipeline.bandwidth_model``'s fused and
   unfused bytes for the group at the mode's width and the bytes saved
   over the card's memory rate; and the same conv then the library's
   ``F.max_pool2d`` (timed only, where it takes the mode's type). Then
   the nine examples
   (``repro_torch.examples``), each ``main`` in process on the card, each
   exiting 0 with its seconds printed: ``alexnet_inference --full --batch
   8`` must move the launch counters by conv_pipe 5, lrn_pwl 2 and
   matmul_pipe 3 a forward and nothing else; ``train_resilient
   --compress`` (a fault at step 25, checkpoints every 10) must log the
   re-run steps' losses bit-equal to an uninterrupted compressed run's.
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
# phase 16, the LM serving path (slice 8a): (arch, dtype, prompt length,
# layers kept or None for full depth, what gates the decode step). Batch
# 4 and 16 generated tokens throughout; 1152 > 1024 takes the chunked
# attention with a ragged last KV chunk. The decode gate: "forward", one
# step against the forward on the prompt plus that token within
# LM_RTOL; "fp32 twin", no farther from the fp32 forward of the same
# weights before rounding (the fp32 run of the same arch and seed, which
# follows) than the bf16 forward is, plus 2e-2: bf16 rounding alone moves
# Qwen3-8B's and zamba2's random full-depth logits by 2.2 % and 5.3 % of
# max|logit| (on an H100, 700 W), so their bf16 decode and forward read 2.0 %
# and 2.6 % apart; None for dbrx-132b (2 of its 40 layers, 14.4 GiB in
# bf16), whose decode changes the tokens a group and so the capacity
# drops: shape and finiteness only.
LM_BATCH, LM_GEN = 4, 16
LM_RUNS = (("qwen3_8b", "bfloat16", 1152, None, "fp32 twin"),
           ("qwen3_8b", "float32", 1152, None, "forward"),
           ("zamba2_1p2b", "bfloat16", 200, None, "fp32 twin"),
           ("zamba2_1p2b", "float32", 200, None, "forward"),
           ("xlstm_125m", "bfloat16", 200, None, "forward"),
           ("xlstm_125m", "float32", 200, None, "forward"),
           ("dbrx_132b", "bfloat16", 200, 2, None))
LM_RTOL = {"bfloat16": 2e-2, "float32": 1e-3}   # x max|logit|
LM_CPU_TOKENS = (2, 64)        # the 2-layer card-vs-CPU forward's batch
# phase 17, the LM training path (slice 8b): (arch, layers kept or None for
# full depth, batch, sequence, steps), each in the config's own dtype
# (bf16 parameters, fp32 AdamW state) and remat ("full"), through
# ResilientLoop without checkpoints. Qwen3-8B is cut to 8 of its 36
# layers (2.79 B parameters at 12 bytes each: 33.5 GB; all 36 need 98 GB)
# and train_4k's batch 256 to 2 at 4096 tokens. xlstm-125m takes 4 steps:
# its step is 5-9 s of host launches (the sLSTM's 512 token steps a layer,
# forward, recompute and backward), 15-20 s with the product count
TRAIN_RUNS = (("qwen3_8b", 8, 2, 4096, 6),
              ("zamba2_1p2b", None, 4, 512, 6),
              ("xlstm_125m", None, 4, 512, 4))
TRAIN_OPT = dict(lr=3e-4, warmup_steps=2, total_steps=6)
# |first loss - (ln V + var / 2)|, var the variance of the fp32 forward's
# logits over the real vocab: random logits of variance var give a loss
# of ln V + var / 2 on average (ln V alone is the loss of equal logits)
TRAIN_LN_V = 0.1
TRAIN_FP32_RTOL = 2e-2         # first loss vs the fp32 forward's, relative
# checkpoint and restore: xlstm-125m at full size, batch x sequence,
# total steps, checkpoint period, the step whose start faults
TRAIN_CKPT = ("xlstm_125m", 4, 64, 8, 4, 6)
TRAIN_RERUN_RTOL = 1e-3        # re-run steps vs the uninterrupted losses
# the card against the CPU: xlstm-125m at full width, fp32, TF32 off, cut
# to 2 of its 12 layers (one mLSTM/sLSTM pair). The fp32 products sum in
# another order on the card, and the random model's gradient grows with
# depth (max|d embed| 0.41 at 2 layers, 2.3 at 4, 5.0 at 6 and 29 at 12,
# B 2 x S 128 on the CPU): on an H100 the card's gradients read 4.8e-5 x
# max from the CPU's at 2 layers and 1.3e-4 at 4, against 1e-4 (two
# thread counts on the CPU: at most 2.0e-6 at 4 layers)
TRAIN_CPU = ("xlstm_125m", 2, 2, 128)
TRAIN_CPU_TOL = {"loss": 1e-5, "grad": 1e-4, "param": (1e-5, 1e-6)}
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


def slice7(*, cfg, compiled, qcompiled, vgg, vcfg, vparams, measured,
           art_findings, n_req, card, reset_launches, launch_counts,
           mopts) -> dict:
    """Phase 15, slice 7 at full width: the continuous scheduler with
    steals and autoscaling on AlexNet fp32 and int8 (the kernels on the
    card, the clock modelled), traces and metrics that validate and
    reconcile, the compile trace, drift reports and static verification.
    ``compiled``/``qcompiled`` are phases 3 and 3b's, ``vgg`` phases 7-9's
    VGG-16 compiles by mode, ``measured`` phase 12's measured tables and
    ``art_findings`` what ``verify_artifact`` found in phase 14's
    artifacts. Returns the phase's record."""
    import numpy as np
    import torch
    from repro_torch.analysis import verify_plan_table
    from repro_torch.launch.serve_cnn import synthetic_requests
    from repro_torch.obs import (MetricsRegistry, TraceRecorder,
                                 drift_report, reconcile, validate_drift,
                                 validate_metrics, validate_trace)
    from repro_torch.pipeline import (AutoscalePolicy, ExecutionSpec,
                                      Placement, PlanTable, Serving,
                                      compile_cnn)
    from repro_torch.serve import latency_report

    out = {"card": card}
    # phase 4's 19 requests with a straggler at every 5th (cost 4), then a
    # burst of 32 at one instant, just before the policy's second look
    reqs = synthetic_requests(n_req, cfg.input_hw, cfg.input_ch, 200.0)
    for r in reqs[::5]:
        r.cost = 4.0
    burst = synthetic_requests(32, cfg.input_hw, cfg.input_ch, 1.0, seed=2)
    for i, r in enumerate(burst):
        r.rid, r.t_arrival = n_req + i, 0.0999
    reqs += burst
    n = len(reqs)
    imgs = torch.from_numpy(np.stack([r.image for r in reqs])).cuda()

    def preds_of(c):
        return torch.cat([c.forward(imgs[i:i + BATCH]).float().argmax(-1)
                          for i in range(0, n, BATCH)]).tolist()

    def obs_ok(rep, trace, metrics, tag):
        tdoc = json.loads(trace.to_json())
        mdoc = json.loads(metrics.to_json())
        problems = (validate_trace(tdoc) + validate_metrics(mdoc)
                    + reconcile(rep.to_dict(), trace=tdoc, metrics=mdoc))
        check(not problems, f"{tag}: {problems[:5]}")
        print(f"[slice7] {tag}: trace {len(trace)} events, metrics "
              f"{len(mdoc['counters'])} counters: validate_trace, "
              f"validate_metrics and reconcile found no problem")

    cb_serving = Serving(batch=BATCH, scheduler="continuous",
                         clock="modeled", execute=True, retries=2,
                         steal_threshold=2,
                         autoscale=AutoscalePolicy(min_replicas=1,
                                                   max_replicas=4))
    for tag, base, expect in (("fp32", compiled, EXPECTED_LAUNCHES),
                              ("int8", qcompiled, EXPECTED_LAUNCHES_INT8)):
        c = compile_cnn(cfg, dataclasses.replace(
            base.spec, placement=Placement(replicas=2), serving=cb_serving),
            base.params, device="cuda")
        want = preds_of(base)
        trace, metrics = TraceRecorder(), MetricsRegistry()
        reset_launches()
        # repro: allow[RPA102] the host time of the scheduler, printed
        t0 = time.perf_counter()
        rep = c.serve(reqs, trace=trace, metrics=metrics)
        torch.cuda.synchronize()
        # repro: allow[RPA102] the host time of the scheduler, printed
        t_host = time.perf_counter() - t0
        counts = launch_counts()
        groups = c.engine.admission_groups
        done = rep.completions
        check(sorted([d.rid for d in done]
                     + [r.rid for r in c.engine.router.rejected])
              == list(range(n)),
              f"continuous {tag}: {len(done)} completions and "
              f"{len(c.engine.router.rejected)} rejections for {n}")
        bad = [d.rid for d in done
               if d.status == "ok" and d.pred != want[d.rid]]
        check(not bad, f"continuous {tag}: requests {bad} predicted other "
              f"than phase {'3b' if tag == 'int8' else '3'}'s forward")
        check(counts == {k: v * groups for k, v in expect.items()},
              f"continuous {tag}: launches {counts} != {groups} admission "
              f"groups x {expect}")
        print(f"[slice7] continuous {tag}: {rep.summary()}")
        print(f"[slice7] continuous {tag}: {n} requests, "
              f"{sum(d.status == 'ok' for d in done)} ok with phase "
              f"{'3b' if tag == 'int8' else '3'}'s predictions, "
              f"{groups} admission groups launching "
              f"{dict((k, v) for k, v in counts.items() if v)}; "
              f"{rep.n_steals} steals; scale events "
              f"{json.dumps(rep.scale_events)}; occupancy "
              f"{[round(o, 4) for o in rep.occupancy]}; host time "
              f"{t_host * 1e3:.2f} ms ({t_host / n * 1e3:.4f} ms a request, "
              f"the kernels' forwards included; {card})")
        obs_ok(rep, trace, metrics, f"continuous {tag}")
        out[f"continuous_{tag}"] = {
            "report": rep.to_dict(), "admission_groups": groups,
            "launches": counts, "host_s": t_host,
            "latency": latency_report(done)}
        if tag == "fp32":
            again = TraceRecorder()
            c.serve(reqs, trace=again, metrics=MetricsRegistry())
            check(again.to_json() == trace.to_json(),
                  "a repeat of the continuous fp32 run traced other bytes")
            print("[slice7] continuous fp32 repeated: trace JSON "
                  "byte-identical")
            fp32_rep, cb = rep, c

    # the scheduler alone (nothing runs on the card), and one admission
    # group's forward through the slot path, host clock
    sim = compile_cnn(cfg, dataclasses.replace(
        cb.spec, serving=dataclasses.replace(cb_serving, execute=False)),
        compiled.params, device="cuda")
    # repro: allow[RPA102] the host time of the scheduler, printed
    t0 = time.perf_counter()
    sim_rep = sim.serve(reqs)
    # repro: allow[RPA102] the host time of the scheduler, printed
    t_sched = (time.perf_counter() - t0) / n
    check([(d.rid, d.t_done) for d in sim_rep.completions]
          == [(d.rid, d.t_done) for d in fp32_rep.completions],
          "execute=False scheduled other than execute=True")
    group = np.stack([r.image for r in reqs[:BATCH]])
    slot = cb.engine._slot_fn(0)
    ts = []
    for _ in range(12):
        # repro: allow[RPA102] the host time of one admission group
        t0 = time.perf_counter()
        slot(group)
        # repro: allow[RPA102] the host time of one admission group
        ts.append(time.perf_counter() - t0)
    slot_ms = statistics.median(ts[2:]) * 1e3
    gang = compile_cnn(cfg, ExecutionSpec(
        placement=Placement(replicas=2),
        serving=Serving(batch=BATCH, clock="modeled", execute=False,
                        retries=2)), compiled.params, device="cuda")
    grep = gang.serve(reqs)
    print(f"[slice7] one admission group's forward (copy to the card, "
          f"forward, argmax back): {slot_ms:.4f} ms host wall, median of "
          f"10; the scheduler alone (execute=False): {t_sched * 1e3:.4f} "
          f"ms a request ({card})")
    print(f"[slice7] modelled on the same trace: continuous p50 "
          f"{fp32_rep.p50_ms:.4f} / p95 {fp32_rep.p95_ms:.4f} ms against "
          f"gang's {grep.p50_ms:.4f} / {grep.p95_ms:.4f} ms (2 replicas; "
          f"continuous scaled {fp32_rep.n_scale_up} up, "
          f"{fp32_rep.n_scale_down} down)")
    out.update(slot_ms=slot_ms, scheduler_ms_a_request=t_sched * 1e3,
               gang=grep.to_dict())

    # phase 4's gang serve on the measured clock, traced
    trace, metrics = TraceRecorder(), MetricsRegistry()
    g_reqs = synthetic_requests(n_req, cfg.input_hw, cfg.input_ch, 200.0)
    rep = compiled.serve(g_reqs, trace=trace, metrics=metrics)
    obs_ok(rep, trace, metrics, "gang, measured clock")

    # the compile trace and the drift of phase 12's measured tables
    trace = TraceRecorder()
    c = compile_cnn(vcfg, vgg["fp32"].spec, vparams, device="cuda",
                    measure=True, measure_opts=mopts, trace=trace)
    spans = [e["name"] for e in trace.to_chrome()["traceEvents"]
             if e["ph"] == "X"]
    check(spans == ["sweep"] + ["measure"] * len(c.plans()),
          f"compile trace spans {spans}")
    check(not validate_trace(json.loads(trace.to_json())),
          "the compile trace does not validate")
    print(f"[slice7] compile_cnn(trace=, measure=True) vgg16 fp32: 1 sweep "
          f"span and {len(spans) - 1} measure spans for "
          f"{len(c.plans())} plans")
    out["drift"] = {}
    for tag, table in measured.items():
        rep = drift_report(table)
        problems = validate_drift(rep, table=json.loads(table.to_json()))
        check(not problems, f"drift {tag}: {problems}")
        out["drift"][tag] = rep["ratio"]
        print(f"[slice7] drift {tag}: {rep['n_measured']}/{rep['n_plans']} "
              f"measured, ratio min {rep['ratio']['min']:.3f} median "
              f"{rep['ratio']['median']:.3f} geomean "
              f"{rep['ratio']['geomean']:.3f} max {rep['ratio']['max']:.3f}"
              f"; validate_drift: no problem")

    # static verification
    for tag, vc in vgg.items():
        check(vc.verify(strict=True) == [], f"verify vgg16 {tag}")
    for tag, findings in art_findings.items():
        check(findings == [], f"verify_artifact vgg16 {tag}: "
              f"{[str(f) for f in findings]}")
    doc = json.loads(vgg["fp32"].plans().to_json())
    doc["conv"][0]["plan"]["smem_bytes"] = doc["conv"][0]["vmem_budget"] + 1
    codes = sorted({f.code for f in verify_plan_table(
        PlanTable.from_json(json.dumps(doc)))})
    check(codes in (["RPA301"], ["RPA302"]),
          f"a row's smem_bytes past the budget gave {codes}")
    print(f"[slice7] verify(strict=True) on vgg16 "
          f"{'/'.join(vgg)}: no finding; verify_artifact on phase 14's "
          f"{'/'.join(art_findings)}: no finding; smem_bytes past the "
          f"budget: {codes}")
    return out


def lm_serving(*, card: str, bw: float, launch_counts, seed: int = 0):
    """Phase 16: the LM serving path at full width (``LM_RUNS``), through
    ``launch.serve.generate``, each run gated against ``lm.forward`` on
    the same card; then Qwen3-8B cut to 2 layers in fp32 against the same
    parameters on the CPU. Launches no kernel of the port. Returns the
    rows for ``chiprun_out/chip_smoke.json``."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.launch.serve import generate
    from repro_torch.models import lm
    from repro_torch.train.steps import serve_decode, serve_prefill

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    n0 = launch_counts()
    out = {"runs": []}
    twin = {}              # a bf16 run's decode, waiting for its fp32 twin

    def worst(got, want):
        """max|got - want| / max|want|, both widened to fp32."""
        g, w = got.float(), want.float()
        return ((g - w).abs().max() / w.abs().max()).item()

    def timed(fn):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        r = fn()
        e.record()
        torch.cuda.synchronize()
        return r, s.elapsed_time(e)

    for arch, dtype, S, depth, decode_gate in LM_RUNS:
        cfg = dataclasses.replace(get_config(arch), dtype=dtype)
        if depth is not None:
            cfg = dataclasses.replace(cfg, n_layers=depth)
        rtol = LM_RTOL[dtype]
        g = torch.Generator(dev).manual_seed(seed)
        base = torch.cuda.memory_allocated()     # earlier phases' tensors
        t0 = time.perf_counter()
        params = lm.init_params(cfg, g, dev)
        torch.cuda.synchronize()
        t_init = time.perf_counter() - t0
        n_params = lm.count_params(cfg)
        w_bytes = sum(a.numel() * a.element_size()
                      for _, a in lm.tree_leaves(params))
        prompts = torch.randint(0, cfg.vocab, (LM_BATCH, S), generator=g,
                                device=dev)
        s_max = S + LM_GEN + 8
        generate(params, prompts, cfg, 2, s_max)           # warm-up
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        toks = generate(params, prompts, cfg, LM_GEN, s_max)
        torch.cuda.synchronize()
        t_gen = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated()
        # the pieces, timed with CUDA events: one prefill, then the decode
        # steps of the same greedy run (each waits on the host's launches)
        (ids, lp, cache), prefill_ms = timed(
            lambda: serve_prefill(params, {"tokens": prompts}, cfg, s_max))
        steps_ms, cur = [], ids
        ld0 = None
        for i in range(LM_GEN - 1):
            (cur, ld, nxt_cache), ms = timed(
                lambda: serve_decode(params, cur, cache, cfg))
            if i == 0:
                ld0 = ld
            cache = nxt_cache
            steps_ms.append(ms)
        del cache, nxt_cache
        step_ms = statistics.median(steps_ms)
        check(torch.equal(toks[:, S:S + 1], ids),
              f"{arch} {dtype}: generate's first token is not the prefill's")
        check(bool((toks[:, S:] < cfg.vocab).all()),
              f"{arch} {dtype}: a generated id is in the padded vocab")
        # gates: the prefill's last logits against forward's last row, one
        # decode step against forward on the prompt plus that token
        fwd = lm.forward(params, prompts, cfg)
        err_pf = worst(lp[:, 0], fwd[:, -1])
        finite = bool(torch.isfinite(fwd).all() and torch.isfinite(lp).all()
                      and torch.isfinite(ld0).all())
        del fwd
        fwd2 = lm.forward(params, torch.cat([prompts, ids], 1), cfg)
        err_dec = worst(ld0[:, 0], fwd2[:, -1])
        fwd_last = fwd2[:, -1].float()
        finite = finite and bool(torch.isfinite(fwd2).all())
        del fwd2
        check(finite, f"{arch} {dtype}: a logit is not finite")
        check(err_pf <= rtol, f"{arch} {dtype}: prefill vs forward "
              f"{err_pf:.2e} x max|logit| > {rtol:.0e}")
        check(ld0.shape == (LM_BATCH, 1, lm.vocab_padded(cfg)),
              f"{arch} {dtype}: decode logits {tuple(ld0.shape)}")
        if decode_gate == "forward":
            check(err_dec <= rtol, f"{arch} {dtype}: decode vs forward "
                  f"{err_dec:.2e} x max|logit| > {rtol:.0e}")
        twin_err = None
        if dtype == "bfloat16" and decode_gate:     # printed by its twin
            twin[arch] = (prompts.cpu(), ids, ld0[:, 0].float().cpu(),
                          fwd_last.cpu(), decode_gate == "fp32 twin")
        elif arch in twin:
            t_prompts, t_ids, t_dec, t_fwd, gated = twin.pop(arch)
            check(torch.equal(t_prompts, prompts.cpu()),
                  f"{arch}: the fp32 twin's prompts differ")
            ref = lm.forward(params, torch.cat([prompts, t_ids], 1),
                             cfg)[:, -1].cpu()
            twin_err = (worst(t_fwd, ref), worst(t_dec, ref))
            allow = twin_err[0] + LM_RTOL["bfloat16"]
            print(f"[lm] {arch} bfloat16 against its fp32 twin: the forward "
                  f"{twin_err[0]:.2e}, the decode {twin_err[1]:.2e} x "
                  f"max|logit|" + (f" <= {allow:.2e}" if gated else
                                   " (printed)"))
            check(not gated or twin_err[1] <= allow,
                  f"{arch} bfloat16: decode {twin_err[1]:.2e} from the "
                  f"fp32 forward, past the bf16 forward's "
                  f"{twin_err[0]:.2e} + 2e-2")
        bound_ms = w_bytes / bw * 1e3
        row = {"arch": arch, "dtype": dtype, "n_layers": cfg.n_layers,
               "layers_of": get_config(arch).n_layers, "params": n_params,
               "weight_bytes": w_bytes, "batch": LM_BATCH, "prompt": S,
               "gen": LM_GEN, "init_s": t_init, "generate_s": t_gen,
               "prefill_ms": prefill_ms,
               "prefill_tok_s": LM_BATCH * S / prefill_ms * 1e3,
               "decode_step_ms": step_ms, "decode_steps_ms": steps_ms,
               "decode_tok_s": LM_BATCH / step_ms * 1e3,
               "decode_bound_ms": bound_ms,
               "peak_gib": (peak - base) / 2 ** 30,
               "err_prefill": err_pf, "err_decode": err_dec,
               "decode_gate": decode_gate, "rtol": rtol,
               "bf16_vs_fp32_twin": twin_err}
        out["runs"].append(row)
        gate = ("not gated" if not decode_gate else
                f"<= {rtol:.0e}" if decode_gate == "forward" else
                "held against the fp32 twin below")
        cut = ("" if depth is None else
               f", depth cut to {cfg.n_layers} of {row['layers_of']} layers")
        print(f"[lm] {arch} {dtype}: {n_params / 1e9:.2f} B params "
              f"({w_bytes / 2 ** 30:.1f} GiB{cut}), B {LM_BATCH}, prompt {S}, "
              f"{LM_GEN} tokens: generate {t_gen:.2f} s; prefill "
              f"{prefill_ms:.1f} ms ({row['prefill_tok_s']:.0f} tok/s); "
              f"decode step {step_ms:.2f} ms ({row['decode_tok_s']:.0f} "
              f"tok/s) against the weights' byte bound {bound_ms:.2f} ms; "
              f"peak {row['peak_gib']:.2f} GiB; prefill vs forward "
              f"{err_pf:.1e}, decode vs forward {err_dec:.1e} x max|logit| "
              f"({gate}) ({card})")
        del params, toks, lp, ld0, ids, cur, fwd_last
        torch.cuda.empty_cache()

    # the card against the CPU: Qwen3-8B at full width, 2 layers, fp32
    cfg = dataclasses.replace(get_config("qwen3_8b"), dtype="float32",
                              n_layers=2)
    g = torch.Generator(dev).manual_seed(seed + 1)
    params = lm.init_params(cfg, g, dev)
    toks = torch.randint(0, cfg.vocab, LM_CPU_TOKENS, generator=g,
                         device=dev)
    on_card = lm.forward(params, toks, cfg).cpu()
    params = lm.tree_map(lambda a: a.cpu(), params)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    on_cpu = lm.forward(params, toks.cpu(), cfg)
    t_cpu = time.perf_counter() - t0
    err = worst(on_card, on_cpu)
    print(f"[lm] qwen3_8b fp32, 2 of 36 layers at full width, "
          f"{LM_CPU_TOKENS[0]} x {LM_CPU_TOKENS[1]} tokens: card vs CPU "
          f"{err:.1e} x max|logit| <= {LM_RTOL['float32']:.0e} (the CPU "
          f"forward {t_cpu:.1f} s)")
    check(err <= LM_RTOL["float32"],
          f"qwen3_8b 2 layers: card vs CPU {err:.2e} x max|logit|")
    out["card_vs_cpu"] = {"n_layers": 2, "tokens": list(LM_CPU_TOKENS),
                          "err": err, "cpu_s": t_cpu}
    del params, on_card, on_cpu
    check(not twin, f"bf16 runs without an fp32 twin: {sorted(twin)}")
    n1 = launch_counts()
    check(n1 == n0, f"the LM path launched a kernel: "
          f"{ {k: n1[k] - n0[k] for k in n0 if n1[k] != n0[k]} }")
    print("[lm] no kernel launch counter moved across the LM runs")
    return out


def train_cfg(arch: str, depth=None, dtype=None):
    """The config of a phase-17 run: ``arch`` at full width, ``depth``
    layers (None: all), in ``dtype`` (None: the config's own)."""
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    if depth is not None:
        cfg = dataclasses.replace(cfg, n_layers=depth)
    if dtype is not None:
        cfg = dataclasses.replace(cfg, dtype=dtype)
    return cfg


def product_counter():
    """A dispatch mode (its ``ops``: operations by dtype) counting every
    product the run dispatches (``mm``, ``addmm``, ``bmm``, ``baddbmm``:
    2 x M x K x N, batches too) by its operands' dtype: forward, remat
    recompute and backward alike. What the recompute does not run again
    (the checkpoint stops once the saved tensors are rebuilt) is not
    counted."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class Count(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.ops = {}

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = func.overloadpacket.__name__
            if name in ("mm", "bmm", "addmm", "baddbmm"):
                a = args[1] if name in ("addmm", "baddbmm") else args[0]
                dt = str(a.dtype).removeprefix("torch.")
                self.ops[dt] = self.ops.get(dt, 0) + 2 * a.numel() * \
                    out.shape[-1]
            return out
    return Count()


def lm_training(*, card: str, rates, launch_counts, seed: int = 0) -> dict:
    """Phase 17: the LM training path at full width (``TRAIN_RUNS``)
    through ``ResilientLoop``, each run's first loss held against ln V
    and against an fp32 forward of the same weights and batch; then
    checkpoint and restore under a fault (``TRAIN_CKPT``), and one fp32
    step on the card against the CPU (``TRAIN_CPU``). ``rates`` maps a
    product's dtype to the card's peak operations a second. Launches no
    kernel of the port. Returns the record for ``chip_smoke.json``."""
    import math
    import shutil
    import tempfile

    import torch
    from repro_torch.ckpt.checkpoint import (load_checkpoint,
                                             save_checkpoint, tree_flatten,
                                             tree_unflatten)
    from repro_torch.data.pipeline import DataConfig, token_batches
    from repro_torch.models import lm
    from repro_torch.optim.adamw import AdamWConfig, adamw_update
    from repro_torch.train.loop import LoopConfig, ResilientLoop
    from repro_torch.train.steps import init_train_state, loss_and_grads

    dev = torch.device("cuda")
    n0 = launch_counts()
    out = {"runs": []}

    def batch_on(b, d):
        return {k: torch.from_numpy(v).to(d) for k, v in b.items()}

    def spy(loop, n_steps=None):
        """Wrap the loop's step: CUDA events around each call, its grad
        norm and the state it returns; with ``n_steps``, the products of
        the first call (``product_counter``) and a ``torch.profiler``
        trace of call ``n_steps``."""
        rec = {"events": [], "gnorm": [], "state": None, "prof": None,
               "counter": product_counter() if n_steps else None}
        step = loop._step

        def timed(state, batch):
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            i = len(rec["events"]) + 1
            s.record()
            if n_steps and i == 1:
                with rec["counter"]:
                    r = step(state, batch)
            elif n_steps and i == n_steps:
                # the device's activity only: recording each host op
                # would slow a host-paced step (xLSTM's) threefold
                with torch.profiler.profile(activities=[
                        torch.profiler.ProfilerActivity.CUDA]) as prof:
                    r = step(state, batch)
                    torch.cuda.synchronize()
                rec["prof"] = prof
            else:
                r = step(state, batch)
            e.record()
            rec["events"].append((s, e))
            rec["gnorm"].append(r[1]["grad_norm"])
            rec["state"] = r[0]
            return r
        loop._step = timed
        return rec

    def device_time(prof):
        """(kernel ms, the products' kernels' ms, the top three kernels)
        of a profiled step; None where the profiler saw no kernel."""
        by_name = {}
        for ev in prof.events():
            if ev.device_type == torch.autograd.DeviceType.CUDA:
                by_name[ev.name] = (by_name.get(ev.name, 0.0)
                                    + ev.time_range.elapsed_us() / 1e3)
        if not by_name:
            return None
        gemm = sum(t for n, t in by_name.items() if any(
            k in n.lower() for k in ("gemm", "nvjet", "xmma", "cutlass")))
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:3]
        return sum(by_name.values()), gemm, top

    # -- (a), (b): full width through the loop, no checkpoints --------------
    for arch, depth, B, S, n_steps in TRAIN_RUNS:
        cfg = train_cfg(arch, depth)
        dcfg = DataConfig(vocab=cfg.vocab, seq_len=S, global_batch=B,
                          seed=seed)
        ocfg = AdamWConfig(**TRAIN_OPT, state_dtype=cfg.opt_state_dtype)
        # the loop's initial weights and first batch (the same seed), for
        # the fp32 forward's loss and the check that the parameters moved
        params = lm.init_params(cfg, torch.Generator(dev).manual_seed(seed),
                                dev)
        b0 = batch_on(next(token_batches(dcfg, cfg)), dev)
        before = {p: a.flatten()[:4096].clone()
                  for p, a in lm.tree_leaves(params)}
        n_params = sum(a.numel() for _, a in lm.tree_leaves(params))
        with torch.no_grad():
            p32 = lm.tree_map(lambda a: a.float(), params)
            del params
            cfg32 = train_cfg(arch, depth, "float32")
            logits = lm.forward(p32, b0["tokens"], cfg32)[..., :cfg.vocab]
            var = logits.var(dim=-1).mean().item()
            del logits
            loss32 = lm.loss_fn(p32, b0, cfg32).item()
        del p32
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        loop = ResilientLoop(cfg, LoopConfig(total_steps=n_steps,
                                             ckpt_dir=None, log_every=10 ** 9),
                             dcfg, ocfg, device=dev)
        rec = spy(loop, n_steps)
        t0 = time.perf_counter()
        res = loop.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        peak = (torch.cuda.max_memory_allocated() - base) / 2 ** 30
        ms = [s.elapsed_time(e) for s, e in rec["events"]]
        losses = [m["loss"] for m in res["metrics"]]
        gnorms = [g.item() for g in rec["gnorm"]]
        state = rec["state"]
        # the first 4096 elements of each leaf: how many changed, and the
        # random leaves none of whose sampled elements did (a bf16 gain of
        # 1.0 cannot move: 6 steps of at most lr stay under half its ulp;
        # nor can an embedding row that no token of the batch reads)
        changed = {p: int((a.flatten()[:4096] != before[p]).sum())
                   for p, a in lm.tree_leaves(state.params)}
        moved = sum(changed.values())
        sampled = sum(v.numel() for v in before.values())
        still = [".".join(p) for p, v in before.items()
                 if p != ("embed",) and bool((v != v[0]).any())
                 and not changed[p]]
        ops = dict(sorted(rec["counter"].ops.items()))
        traced = device_time(rec["prof"])
        del loop, rec, state, before
        torch.cuda.empty_cache()
        tag = f"{arch} {cfg.dtype}"
        check(res["restarts"] == 0 and res["final_step"] == n_steps,
              f"{tag}: {res['restarts']} restarts, final step "
              f"{res['final_step']} (no fault was injected)")
        check(all(map(math.isfinite, losses + gnorms)),
              f"{tag}: a loss or grad norm is not finite: {losses} {gnorms}")
        ln_v = math.log(cfg.vocab)
        check(abs(losses[0] - ln_v - var / 2) <= TRAIN_LN_V,
              f"{tag}: first loss {losses[0]:.4f} vs ln V + var / 2 = "
              f"{ln_v:.4f} + {var / 2:.4f}")
        err32 = abs(losses[0] - loss32) / loss32
        check(err32 <= TRAIN_FP32_RTOL, f"{tag}: first loss {losses[0]:.5f} "
              f"vs the fp32 forward's {loss32:.5f} ({err32:.2e})")
        check(not still, f"{tag}: random leaves that did not move: {still}")
        check(set(ops) <= set(rates), f"{tag}: products in {sorted(ops)}")
        # the least time of the step's products: each dtype's operations
        # at the card's peak rate for it, one after the other
        bound_ms = sum(n / rates[dt] for dt, n in ops.items()) * 1e3
        # steps 2 .. n-1: the first counts its products, the last is traced
        step_ms = statistics.median(ms[1:-1])
        if traced is None:
            busy = "device time not measured (the profiler saw no kernel)"
        else:
            share = 100 * traced[0] / step_ms
            busy = (f"traced step {n_steps}: kernels {traced[0]:.1f} ms "
                    f"({share:.1f} % of the untraced step: the card idles "
                    f"{100 - share:.1f} %), GEMM kernels {traced[1]:.1f} "
                    f"ms, the top three " + "; ".join(
                        f"{n[:60]} {t:.1f} ms" for n, t in traced[2]))
        row = {"arch": arch, "dtype": cfg.dtype, "n_layers": cfg.n_layers,
               "layers_of": train_cfg(arch).n_layers, "params": n_params,
               "batch": B, "seq": S, "steps": n_steps, "losses": losses,
               "grad_norms": gnorms, "loss_fp32_forward": loss32,
               "logit_var": var,
               "first_loss_vs_fp32": err32, "steps_ms": ms,
               "step_ms": step_ms, "tok_s": B * S / step_ms * 1e3,
               "moved": moved, "sampled": sampled,
               "product_ops": ops, "bound_ms": bound_ms,
               "bound_share": bound_ms / step_ms, "peak_gib": peak,
               "loop_s": wall, "traced_kernel_ms": traced and traced[0],
               "traced_gemm_ms": traced and traced[1],
               "traced_top": traced and traced[2]}
        out["runs"].append(row)
        cut = ("" if depth is None else
               f", depth cut to {cfg.n_layers} of {row['layers_of']} layers")
        flops = ", ".join(f"{dt} {n / 1e12:.2f} TFLOP" for dt, n in
                          ops.items())
        print(f"[train] {tag}: {n_params / 1e9:.3f} B params{cut}, B {B} x "
              f"S {S}, {n_steps} steps: loss {losses[0]:.4f} -> "
              f"{losses[-1]:.4f} (ln V + var / 2 = {ln_v:.4f} + "
              f"{var / 2:.4f}; the fp32 forward "
              f"{loss32:.4f}, {err32:.1e} apart); {moved} of {sampled} "
              f"sampled parameters moved; step {step_ms:.1f} ms "
              f"(median of steps 2-{n_steps - 1}, CUDA events; step 1 "
              f"{ms[0]:.1f} ms with the product count, step {n_steps} "
              f"{ms[-1]:.1f} ms traced), "
              f"{row['tok_s']:.0f} tok/s; products a step {flops} -> bound "
              f"{bound_ms:.1f} ms at the card's peaks, "
              f"{100 * row['bound_share']:.1f} % of it reached; peak "
              f"{peak:.2f} GiB; {busy} ({card})")

    # -- (c) checkpoint and restore on the card, one fault ------------------
    arch, B, S, n_steps, every, fault_at = TRAIN_CKPT
    cfg = train_cfg(arch)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    try:
        pending = {fault_at}

        def fault(step):
            if step in pending:
                pending.discard(step)
                raise RuntimeError("injected device failure")
        loop = ResilientLoop(
            cfg, LoopConfig(total_steps=n_steps, ckpt_every=every,
                            ckpt_dir=os.path.join(tmp, "run"),
                            log_every=10 ** 9),
            DataConfig(vocab=cfg.vocab, seq_len=S, global_batch=B,
                       seed=seed),
            AdamWConfig(**TRAIN_OPT, state_dtype=cfg.opt_state_dtype),
            fault_hook=fault, device=dev)
        rec = spy(loop)
        res = loop.run()
        log = res["metrics"]
        want_steps = (list(range(1, fault_at + 1))
                      + list(range(fault_at - fault_at % every + 1,
                                   n_steps + 1)))
        check(res["restarts"] == 1 and res["final_step"] == n_steps,
              f"restore: {res['restarts']} restarts (1 fault injected), "
              f"final step {res['final_step']}")
        check([m["step"] for m in log] == want_steps,
              f"restore: steps {[m['step'] for m in log]}")
        first = {m["step"]: m["loss"] for m in log[:fault_at]}
        rerun = log[fault_at:fault_at + fault_at % every]
        rerr = [abs(m["loss"] - first[m["step"]]) / first[m["step"]]
                for m in rerun]
        check(max(rerr) <= TRAIN_RERUN_RTOL,
              f"restore: re-run losses {rerr} apart from the first run's")
        final = rec["state"]
        reloaded, step = load_checkpoint(os.path.join(tmp, "run"), final)
        check(step == n_steps and all(
            torch.equal(a, b) for a, b in zip(tree_flatten(reloaded)[0],
                                              tree_flatten(final)[0])),
            f"restore: the committed step-{step} checkpoint does not "
            f"reload equal")
        del reloaded
        nbytes = sum(a.numel() * a.element_size()
                     for a in tree_flatten(final)[0])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        save_checkpoint(os.path.join(tmp, "timed"), n_steps, final)
        t_save = time.perf_counter() - t0
        t0 = time.perf_counter()
        again, _ = load_checkpoint(os.path.join(tmp, "timed"), final)
        torch.cuda.synchronize()
        t_load = time.perf_counter() - t0
        check(all(torch.equal(a, b) for a, b in zip(
            tree_flatten(again)[0], tree_flatten(final)[0])),
            "restore: the timed checkpoint does not reload equal")
        del again, final, loop, rec
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    out["restore"] = {"arch": arch, "batch": B, "seq": S, "steps": n_steps,
                      "ckpt_every": every, "fault_at": fault_at,
                      "restarts": res["restarts"],
                      "log": log, "rerun_rel_err": rerr,
                      "rerun_bit_equal": max(rerr) == 0.0,
                      "ckpt_bytes": nbytes, "save_s": t_save,
                      "load_s": t_load}
    print(f"[train] restore: {arch} {cfg.dtype}, B {B} x S {S}, "
          f"{n_steps} steps, checkpoints every {every}, a fault at step "
          f"{fault_at}: {res['restarts']} restart, steps "
          f"{[m['step'] for m in log]}; the re-run steps "
          f"{[m['step'] for m in rerun]} {rerr} from the first run's losses "
          f"(<= {TRAIN_RERUN_RTOL:.0e}); step {n_steps} reloads equal; "
          f"a checkpoint of {nbytes / 1e9:.2f} GB saves in {t_save:.2f} s "
          f"({nbytes / 1e9 / t_save:.2f} GB/s) and loads onto the card in "
          f"{t_load:.2f} s ({nbytes / 1e9 / t_load:.2f} GB/s)")

    # -- (d) one fp32 step on the card against the CPU -----------------------
    arch, depth, B, S = TRAIN_CPU
    cfg = train_cfg(arch, depth, "float32")
    ocfg = AdamWConfig(**TRAIN_OPT)
    st = init_train_state(cfg, torch.Generator(dev).manual_seed(seed),
                          ocfg, dev)
    st_cpu = tree_unflatten(st, [a.cpu() for a in tree_flatten(st)[0]])
    b = next(token_batches(DataConfig(vocab=cfg.vocab, seq_len=S,
                                      global_batch=B, seed=seed), cfg))
    loss_g, grads_g = loss_and_grads(st.params, batch_on(b, dev), cfg)
    t0 = time.perf_counter()
    loss_c, grads_c = loss_and_grads(st_cpu.params, batch_on(b, "cpu"), cfg)
    t_cpu = time.perf_counter() - t0
    tol = TRAIN_CPU_TOL
    err_loss = abs(loss_g.item() - loss_c.item()) / abs(loss_c.item())
    err_grad = max(((a.cpu() - c).abs().max() / c.abs().max()).item()
                   for (_, a), (_, c) in zip(lm.tree_leaves(grads_g),
                                             lm.tree_leaves(grads_c)))
    # the update on the same gradients: Adam's first step moves each
    # parameter by about lr x sign(g), so gradients 1e-4 apart flip it
    # where g is near 0 (two CPU runs that differ in their thread count
    # land 1e-4 apart in the parameters); the card updates with the CPU's
    grads_on = lm.tree_map(lambda a: a.to(dev), grads_c)
    p_g, _, _ = adamw_update(grads_on, st.opt, st.params, ocfg)
    p_c, _, _ = adamw_update(grads_c, st_cpu.opt, st_cpu.params, ocfg)
    err_param = max(((a.cpu() - c).abs().max()
                     / (tol["param"][0] * c.abs().max() + tol["param"][1])
                     ).item() for (_, a), (_, c) in zip(lm.tree_leaves(p_g),
                                                         lm.tree_leaves(p_c)))
    print(f"[train] card vs CPU: {arch} fp32, {cfg.n_layers} of "
          f"{train_cfg(arch).n_layers} layers at full width, B {B} x S {S}: "
          f"loss {err_loss:.1e} apart (<= {tol['loss']:.0e}), the worst "
          f"gradient leaf {err_grad:.1e} x its max (<= {tol['grad']:.0e}); "
          f"the update on the CPU's gradients {err_param:.2f} of its "
          f"allowance {tol['param'][0]:.0e} x max|p| + {tol['param'][1]:.0e}"
          f" (the CPU's loss and gradient {t_cpu:.1f} s)")
    check(err_loss <= tol["loss"], f"card vs CPU: loss {err_loss:.2e}")
    check(err_grad <= tol["grad"], f"card vs CPU: gradient {err_grad:.2e}")
    check(err_param <= 1.0, f"card vs CPU: parameters {err_param:.2f} of "
          f"the allowance")
    out["card_vs_cpu"] = {"arch": arch, "n_layers": cfg.n_layers,
                          "batch": B, "seq": S, "loss_rel_err": err_loss,
                          "grad_rel_err": err_grad,
                          "param_err_of_allowance": err_param,
                          "cpu_s": t_cpu}
    del st, st_cpu, grads_g, grads_c, grads_on, p_g, p_c
    torch.cuda.empty_cache()
    n1 = launch_counts()
    check(n1 == n0, f"the training path launched a kernel: "
          f"{ {k: n1[k] - n0[k] for k in n0 if n1[k] != n0[k]} }")
    print("[train] no kernel launch counter moved across the training runs")
    return out


# phase 18, slice 7b: VGG-16's conv+pool groups run fused and unfused
FUSION_GROUPS = ("conv1_2", "conv2_2", "conv3_3", "conv4_3", "conv5_3")
FUSION_MODES = ("fp32", "bf16", "int8")
# the examples on the card: (module, arguments); alexnet_inference's
# launches are counted, train_resilient --compress is held against an
# uninterrupted compressed run of the same steps
EXAMPLES = (("quickstart", []),
            ("alexnet_inference", ["--full", "--batch", "8"]),
            ("serve_batched", []),
            ("serve_batched", ["--arch", "alexnet"]),
            ("serve_fleet", []),
            ("fleet_failover", []),
            ("serve_elastic", []),
            ("observe_fleet", []),
            ("measure_drift", []),
            ("train_resilient", ["--compress"]),
            ("train_resilient", ["--compress", "--fail-at", "-1"]))


def slice7b(*, card: str, bw: float, vcfg, vgg: dict, reset_launches,
            launch_counts) -> dict:
    """Phase 18. ``vgg`` maps each mode to phase 7's or 8's VGG-16
    compile and its batch. Returns the phase's record."""
    import contextlib
    import importlib
    import io
    import shutil
    import tempfile

    import torch
    import torch.nn.functional as F
    from repro_torch.analysis.__main__ import main as analysis_main
    from repro_torch.core.pipeline import bandwidth_model
    from repro_torch.examples.alexnet_inference import TIMED_FORWARDS
    from repro_torch.kernels.conv_pipe import conv_pipe
    from repro_torch.kernels.ref import pool_ref
    from repro_torch.models.cnn import fuse_plan

    out = {"card": card}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_slice7b_")
    try:
        # -- the lint of the whole port, on the card's machine ---------------
        report = os.path.join(tmp, "analysis.json")
        t0 = time.perf_counter()
        rc = analysis_main([
            "--lint", "--root", os.path.join(ROOT, "src", "repro_torch"),
            "--repo-root", ROOT, "--baseline",
            os.path.join(ROOT, "src", "repro_torch", "analysis",
                         "baseline.json"), "--json", report])
        doc = json.load(open(report))
        print(f"[slice7b] lint: exit {rc}, {doc['lint']['files_scanned']} "
              f"files, {doc['n_findings']} findings, {doc['n_baselined']} "
              f"baselined ({time.perf_counter() - t0:.2f} s)")
        check(rc == 0 and doc["n_findings"] == 0 and doc["n_baselined"] == 0,
              f"the lint of the port found {doc['findings']}")
        out["lint"] = {"rc": rc, "files": doc["lint"]["files_scanned"],
                       "findings": doc["n_findings"],
                       "baselined": doc["n_baselined"]}

        # -- the fused cascade against conv, then pool ------------------------
        plan = fuse_plan(vcfg)
        groups = [g for g in plan
                  if vcfg.layers[g[0]].kind == "conv" and len(g) == 2]
        check(len(groups) == len(FUSION_GROUPS),
              f"VGG-16 has {len(groups)} conv+pool groups")
        label = dict(zip(groups, FUSION_GROUPS))
        width = {"fp32": 4, "bf16": 2, "int8": 1}
        fused_st = {m: bandwidth_model(vcfg, BATCH, fused=True,
                                       dtype_bytes=width[m])
                    for m in FUSION_MODES}
        unf_st = {m: bandwidth_model(vcfg, BATCH, fused=False,
                                     dtype_bytes=width[m])
                  for m in FUSION_MODES}
        rows = []
        for mode in FUSION_MODES:
            c, x = vgg[mode]
            model = c.model
            inputs = {}
            h = x
            with torch.inference_mode():
                for g in plan:                  # each group's input
                    if g in label:
                        inputs[g] = h
                    h = model.forward_groups(h, [g])
                for g in groups:
                    l, pool = vcfg.layers[g[0]], vcfg.layers[g[1]]
                    h = inputs[g]
                    if mode == "int8":
                        ql = c.params.layers[g[0]]
                        w, b = ql.w_q, ql.b
                        q = dict(scale=ql.scale, out_scale=ql.y_scale)
                    else:
                        p = c.params[g[0]]
                        w, b, q = p["w"], p["b"], {}
                    tile = c.group_plans[g].tile
                    kw = dict(stride=l.stride, pad=l.pad, relu=l.relu,
                              groups=l.groups, **q)

                    def fused(h=h, w=w, b=b, kw=kw, tile=tile, pool=pool):
                        return conv_pipe(h, w, b, pool=pool.pool,
                                         pool_k=pool.kernel,
                                         pool_s=pool.stride, tile=tile, **kw)

                    def unfused(h=h, w=w, b=b, kw=kw, tile=tile, pool=pool):
                        y = conv_pipe(h, w, b, tile=(tile[0], tile[1], 1, 1),
                                      **kw)
                        return pool_ref(y, pool.pool, pool.kernel,
                                        pool.stride)

                    # the same conv, then the library's pool (timed only;
                    # the port never calls it): NHWC is channels_last NCHW
                    def unfused_lib(h=h, w=w, b=b, kw=kw, tile=tile,
                                    pool=pool):
                        y = conv_pipe(h, w, b, tile=(tile[0], tile[1], 1, 1),
                                      **kw)
                        return F.max_pool2d(y.permute(0, 3, 1, 2),
                                            pool.kernel, pool.stride
                                            ).permute(0, 2, 3, 1)
                    a, u = fused(), unfused()
                    torch.cuda.synchronize()
                    same = torch.equal(a, u)
                    check(pool.pool == "max", f"{label[g]}: {pool.pool} pool")
                    try:
                        lib_same = torch.equal(a, unfused_lib())
                        lib_ms = time_ms(unfused_lib)
                        lib_graph = graph_ms(unfused_lib)
                    except RuntimeError as e:  # no int8 max-pool to call
                        if mode != "int8":
                            raise
                        lib_same = lib_ms = lib_graph = None
                        lib_none = f"{type(e).__name__}: {str(e)[:80]}"
                    i = plan.index(g)
                    fb = fused_st[mode][i].total
                    ub = unf_st[mode][g[0]].total + unf_st[mode][g[1]].total
                    row = {"group": f"{label[g]}+pool", "mode": mode,
                           "tile": list(tile), "shape": list(h.shape),
                           "equal": same, "fused_bytes": fb,
                           "unfused_bytes": ub,
                           "saved_ms": (ub - fb) / bw * 1e3,
                           "fused_ms": time_ms(fused),
                           "unfused_ms": time_ms(unfused),
                           "fused_graph_ms": graph_ms(fused),
                           "unfused_graph_ms": graph_ms(unfused),
                           "unfused_lib_ms": lib_ms,
                           "unfused_lib_graph_ms": lib_graph,
                           "lib_equal": lib_same}
                    rows.append(row)
                    gain = row["unfused_graph_ms"] - row["fused_graph_ms"]
                    print(f"[fusion] vgg16 {row['group']:<13} {mode}: tile "
                          f"{tile[0]}x{tile[1]}, fused {row['fused_ms']:.4f}"
                          f" ms (graph {row['fused_graph_ms']:.4f}), conv "
                          f"then pool_ref {row['unfused_ms']:.4f} ms (graph "
                          f"{row['unfused_graph_ms']:.4f}); the graphs "
                          f"differ by {gain:.4f} ms, "
                          f"{100 * gain / row['unfused_graph_ms']:.1f} % of "
                          f"the unfused; bandwidth_model fused {fb} B, "
                          f"unfused {ub} B, saved {ub - fb} B = "
                          f"{row['saved_ms']:.4f} ms at {bw / 1e12:.2f} TB/s;"
                          f" torch.equal {same} ({card})")
                    if lib_graph is None:
                        print(f"[fusion]   conv then F.max_pool2d: none at "
                              f"{mode} ({lib_none})")
                    else:
                        lgain = lib_graph - row["fused_graph_ms"]
                        print(f"[fusion]   conv then F.max_pool2d "
                              f"{lib_ms:.4f} ms (graph {lib_graph:.4f}); the "
                              f"graphs differ by {lgain:.4f} ms, "
                              f"{100 * lgain / lib_graph:.1f} % of the "
                              f"library-pooled; torch.equal {lib_same}")
                    check(same, f"fusion {row['group']} {mode}: the fused "
                          f"launch differs from conv then pool_ref")
                    del a, u
            del inputs, h
            torch.cuda.empty_cache()
        out["fusion"] = rows
        print("[fusion] dram bytes by counter: not measured (ncu does not "
              "run on the card's machine)")

        # -- the examples on the card ------------------------------------------
        ex = []
        losses = {}
        for i, (name, argv) in enumerate(EXAMPLES):
            mod = importlib.import_module(f"repro_torch.examples.{name}")
            args = list(argv)
            d = os.path.join(tmp, f"ex{i}_{name}")
            if name in ("quickstart", "fleet_failover", "observe_fleet",
                        "measure_drift", "train_resilient"):
                args += ["--out", d]
            buf = io.StringIO()
            reset_launches()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = mod.main(args)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            counts = launch_counts()
            text = buf.getvalue()
            os.makedirs(os.path.join(ROOT, "chiprun_out", "examples"),
                        exist_ok=True)
            with open(os.path.join(ROOT, "chiprun_out", "examples",
                                   f"{i:02d}_{name}.txt"), "w") as f:
                f.write(text)
            print(f"[example] {name} {' '.join(argv)}: exit {rc} in "
                  f"{dt:.1f} s; {text.strip().splitlines()[-1]}")
            check(rc == 0, f"example {name} {argv} exited {rc}")
            rec = {"name": name, "argv": argv, "rc": rc, "s": dt}
            if name == "alexnet_inference":
                n = 1 + TIMED_FORWARDS
                want = {k: 0 for k in counts}
                want.update(conv_pipe=5 * n, lrn_pwl=2 * n,
                            matmul_pipe=3 * n)
                for line in text.splitlines():
                    if "ms/image" in line or "FPGA" in line:
                        print(f"[example]   {line}")
                print(f"[example]   launches over {n} forwards: "
                      f"{ {k: v for k, v in counts.items() if v} }")
                check(counts == want, f"alexnet_inference launched {counts}"
                      f", not 5/2/3 a forward over {n} forwards")
                rec["launches"] = counts
            if name == "train_resilient":
                with open(os.path.join(d, "losses.json")) as f:
                    losses["-1" in argv] = json.load(f)
            ex.append(rec)
        faulted, whole = losses[False], losses[True]
        by_step = {m["step"]: m["loss"] for m in whole}
        steps = [m["step"] for m in faulted]
        rerun = [m for k, m in enumerate(faulted)
                 if m["step"] in steps[:k]]
        differ = [(m["step"], m["loss"], by_step[m["step"]])
                  for m in faulted if m["loss"] != by_step[m["step"]]]
        print(f"[example] train_resilient --compress: {len(faulted)} logged "
              f"steps with {len(rerun)} re-run after the restore; "
              f"{len(differ)} losses differ from the uninterrupted "
              f"compressed run's (bit-equal required): {differ[:4]}")
        check(len(rerun) > 0, "train_resilient re-ran no step")
        check(not differ, "the compressed restart's losses differ from the "
              "uninterrupted run's")
        out["examples"] = ex
        out["restart"] = {"logged": len(faulted), "rerun": len(rerun),
                          "differ": len(differ)}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


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
    measured_tables = {}
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
        measured_tables[tag] = c.plans()         # phase 15's drift
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

    # -- 13. the fleet at full width: AlexNet, batch 8 ------------------------
    from repro_torch.obs import MetricsRegistry
    from repro_torch.pipeline import Placement
    from repro_torch.serve import FaultSchedule

    fleet_out = {"modes": {}, "card": card}
    reqs = synthetic_requests(n_req, cfg.input_hw, cfg.input_ch, 200.0)
    imgs = torch.from_numpy(np.stack([r.image for r in reqs])).cuda()

    def preds_of(c):
        """Each request image's prediction by ``c``'s single forward."""
        return torch.cat([c.forward(imgs[i:i + BATCH]).float().argmax(-1)
                          for i in range(0, n_req, BATCH)]).tolist()

    want = {0: preds_of(compiled)}             # phase 3's fp32 model

    def fleet_spec(R, S, M, **serving):
        return ExecutionSpec(
            placement=Placement(replicas=R, pp_stages=S, microbatches=M),
            serving=Serving(batch=BATCH, **serving))

    def check_done(rep, tag, versions=None):
        """Every request one completion (ok, or failed past its budget),
        each ok prediction its version's forward's."""
        done = sorted(rep.completions, key=lambda d: d.rid)
        check([d.rid for d in done] == list(range(n_req)),
              f"{tag}: {len(done)} completions for {n_req} requests")
        for d in done:
            if d.status == "ok":
                check(d.pred == (versions or want)[d.version][d.rid],
                      f"{tag}: request {d.rid} (version {d.version}) "
                      f"predicted {d.pred}")
        return done

    def round_ms(c):
        """The measured clock's mean round, full rounds: 4 x R x 8
        requests arriving at once, served twice (the second is timed)."""
        R = c.spec.placement.replicas
        burst = synthetic_requests(4 * R * BATCH, cfg.input_hw, cfg.input_ch,
                                   1e12, seed=1)
        c.serve(burst)
        rep = c.serve(burst)
        return rep.makespan_s / rep.rounds * 1e3

    def copy_ms(R):
        """Host clock around the round's one copy of R packed batches to
        the card (pageable memory), synchronised; median of 5."""
        packed = np.stack([r.image for r in reqs[:BATCH]] * R)
        ts = []
        for _ in range(5):
            t0 = time.perf_counter()
            torch.from_numpy(packed).to("cuda")
            torch.cuda.synchronize()
            ts.append((time.perf_counter() - t0) * 1e3)
        return statistics.median(ts)

    single_ms = round_ms(compiled)
    fleet_out["copy_ms"] = {R: copy_ms(R) for R in (1, 2)}
    print(f"[fleet] single: round {single_ms:.4f} ms measured "
          f"({BATCH / single_ms * 1e3:.0f} images/s), of which the copy of "
          f"the batch to the card {fleet_out['copy_ms'][1]:.4f} ms (2 "
          f"batches: {fleet_out['copy_ms'][2]:.4f} ms) and phase 3's "
          f"forward {fwd_ms:.4f} ms as timed; {card}")
    for mode, (R, S, M) in (("dp", (2, 1, 0)), ("pp", (1, 2, 4)),
                            ("hybrid", (2, 2, 2))):
        fc = compile_cnn(cfg, fleet_spec(R, S, M, retries=2), params,
                         device="cuda")
        check(fc.mode == mode, f"{mode}: compiled as {fc.mode}")
        m = fc.engine.n_micro
        reset_launches()
        rep = fc.serve(reqs)
        torch.cuda.synchronize()
        served = launch_counts()
        n_fwd = (rep.rounds + 1) * R * m     # every replica and microbatch
        print(f"[fleet] {mode} (R {R}, S {S}, M {m}): launches {served} over "
              f"{rep.rounds} rounds + 1 warm-up, {R * m} forwards a round")
        check(served == {k: v * n_fwd for k, v in EXPECTED_LAUNCHES.items()},
              f"{mode} launches {served} != {n_fwd} x {EXPECTED_LAUNCHES}")
        done = check_done(rep, mode)
        check(all(d.status == "ok" for d in done), f"{mode}: a failed request")
        ms = round_ms(fc)
        print(f"[fleet] {mode}: {rep.summary()}; round {ms:.4f} ms measured "
              f"against single's {single_ms:.4f} ms ({ms / single_ms:.2f}x; "
              f"{R * BATCH / ms * 1e3:.0f} images/s; modelled "
              f"{fc.engine.t_round_model * 1e3:.4f} ms; {card})")
        fleet_out["modes"][mode] = {"round_ms": ms,
                                    "t_round_model": fc.engine.t_round_model,
                                    "n_micro": m, "launches": served,
                                    "report": rep.to_dict()}
        if S > 1:
            print(f"[fleet] {mode} stages: " + " | ".join(
                f"{list(st.groups)} {st.t_model * 1e3:.4f} ms modelled"
                for st in fc.stage_plan.stages))
    fleet_out["single_round_ms"] = single_ms

    # the stage schedule's logits: int8 bit-equal, fp32 within 1e-4
    for tag, base, ref_logits, expect in (
            ("int8", qcompiled, qlogits, EXPECTED_LAUNCHES_INT8),
            ("fp32", compiled, logits, EXPECTED_LAUNCHES)):
        pc = compile_cnn(cfg, dataclasses.replace(
            base.spec, placement=Placement(pp_stages=2, microbatches=4)),
            base.params, device="cuda")
        reset_launches()
        out = pc.forward(x_alex)
        torch.cuda.synchronize()
        counts = launch_counts()
        check(counts == {k: 4 * v for k, v in expect.items()},
              f"pp {tag} forward launches {counts}")
        err = (out - ref_logits).abs().max().item()
        tol = 0.0 if tag == "int8" else \
            KERNEL_RTOL * ref_logits.abs().max().item()
        print(f"[fleet] pp {tag} forward through the stage streams (4 "
              f"microbatches of 2): max abs err {err:.3e} against phase "
              f"{'3b' if tag == 'int8' else '3'}'s forward (allowed "
              f"{tol:.3e}{', torch.equal' if tag == 'int8' else ''})")
        check(torch.equal(out, ref_logits) if tag == "int8" else err <= tol,
              f"pp {tag} logits differ from the forward: {err}")
        fleet_out[f"pp_{tag}_err"] = err

    # faults: replica 0 fails at 20 ms and recovers at 40 ms (+ the
    # modelled restore, 127 ms for AlexNet fp32), under the same images
    # arriving at 50 a second (over about 380 ms, so it rejoins in time)
    slow = synthetic_requests(n_req, cfg.input_hw, cfg.input_ch, 50.0)
    fc = compile_cnn(cfg, fleet_spec(2, 1, 0, retries=2), params,
                     device="cuda")
    reg = MetricsRegistry()
    rep = fc.serve(slow, faults=FaultSchedule.at(20e-3, 40e-3, replica=0),
                   metrics=reg)
    done = check_done(rep, "dp faults")
    n_ok = sum(d.status == "ok" for d in done)
    print(f"[fleet] dp faults: {rep.summary()}; {n_ok} ok, "
          f"{n_req - n_ok} failed, none stranded; counters "
          f"{json.dumps(reg.snapshot()['counters'])}; TTR "
          f"{[round(t * 1e3, 4) for t in rep.time_to_recover_s]} ms "
          f"(modelled restore {fc.engine.t_restore_model * 1e3:.4f} ms)")
    check(rep.n_failures == 1 and rep.n_recoveries == 1,
          f"dp faults: {rep.n_failures} failures, {rep.n_recoveries} "
          f"recoveries")
    fleet_out["faults"] = {"report": rep.to_dict(),
                           "counters": reg.snapshot()["counters"]}

    # fp32 -> int8 hot_swap under load, from 20 ms (a replica's modelled
    # restore of the int8 artifact: about 36 ms)
    fc = compile_cnn(cfg, fleet_spec(2, 1, 0), params, device="cuda")
    v = fc.engine.hot_swap(qcompiled, at=20e-3)
    want[v] = preds_of(qcompiled)
    reg = MetricsRegistry()
    rep = fc.serve(slow, metrics=reg)
    done = check_done(rep, "hot_swap", want)
    by_v = {u: sum(d.version == u for d in done) for u in (0, v)}
    print(f"[fleet] hot_swap fp32 -> int8: {rep.summary()}; completions by "
          f"version {by_v}, each prediction its version's forward's; "
          f"counters {json.dumps(reg.snapshot()['counters'])}")
    check(all(d.status == "ok" for d in done) and rep.n_swapped == 2
          and fc.engine.dtype == "int8",
          f"hot_swap: {rep.n_swapped} swapped, dtype {fc.engine.dtype}")
    fleet_out["hot_swap"] = {"report": rep.to_dict(), "by_version": by_v}
    phases.done("13")

    # -- 14. artifacts at full width: VGG-16, batch 8 -------------------------
    import shutil
    import tempfile
    from repro_torch.analysis import verify_artifact
    from repro_torch.pipeline import CompiledCNN
    from repro_torch.serve import restore_latency_model

    art_out = {"card": card}
    art_findings = {}                            # phase 15's gate
    art_dir = tempfile.mkdtemp(prefix="chip_smoke_artifacts_")
    try:
        for tag, c, xb, ref_logits in (
                ("fp32", vcompiled, x_vgg, vlogits),
                ("int8", vqcompiled, x_vgg, vqlogits),
                ("bf16", bf16["vgg16"]["compiled"], bf16["vgg16"]["x"],
                 bf16["vgg16"]["logits"])):
            a1 = os.path.join(art_dir, f"{tag}_1")
            a2 = os.path.join(art_dir, f"{tag}_2")
            t0 = time.perf_counter()
            c.save(a1)
            t_save = time.perf_counter() - t0
            art_findings[tag] = verify_artifact(a1)
            nbytes = sum(os.path.getsize(os.path.join(a1, f))
                         for f in os.listdir(a1))
            autotune.clear_registry()
            autotune.reset_sweep_stats()
            t0 = time.perf_counter()
            c2 = CompiledCNN.load(a1)
            torch.cuda.synchronize()
            t_load = time.perf_counter() - t0
            sweeps = autotune.sweep_stats()
            out = c2.forward(xb)
            c2.save(a2)
            same = {f: open(os.path.join(a1, f), "rb").read()
                    == open(os.path.join(a2, f), "rb").read()
                    for f in ("manifest.json", "plan_table.json")}
            t_model = restore_latency_model(nbytes)
            print(f"[artifact] vgg16 {tag}: {nbytes} bytes, save "
                  f"{t_save:.3f} s, load {t_load:.3f} s (wall, host clock; "
                  f"{nbytes / t_load / 1e9:.2f} GB/s) beside the restore "
                  f"model's {t_model:.3f} s; {sweeps['conv_sweeps']} + "
                  f"{sweeps['gemm_sweeps']} sweeps; logits torch.equal "
                  f"{torch.equal(out, ref_logits)}; byte-identical over "
                  f"save -> load -> save {same} ({card})")
            check(torch.equal(out, ref_logits),
                  f"artifact {tag}: reloaded logits differ")
            check(sweeps["conv_sweeps"] == 0 and sweeps["gemm_sweeps"] == 0,
                  f"artifact {tag}: the load swept {sweeps}")
            check(all(same.values()), f"artifact {tag}: {same}")
            art_out[tag] = {"bytes": nbytes, "save_s": t_save,
                            "load_s": t_load, "restore_model_s": t_model}
            shutil.rmtree(a1)
            shutil.rmtree(a2)
            del c2, out
    finally:
        shutil.rmtree(art_dir, ignore_errors=True)
    phases.done("14")

    # -- 15. slice 7 at full width: continuous serving, obs, verify ---------
    s7_out = slice7(cfg=cfg, compiled=compiled, qcompiled=qcompiled,
                    vgg={"fp32": vcompiled, "int8": vqcompiled,
                         "bf16": bf16["vgg16"]["compiled"]},
                    vcfg=vcfg, vparams=vparams, measured=measured_tables,
                    art_findings=art_findings, n_req=n_req, card=card,
                    reset_launches=reset_launches,
                    launch_counts=launch_counts, mopts=mopts)
    phases.done("15")

    # -- 16. slice 8a: the LM serving path at full width ---------------------
    lm_out = lm_serving(card=card, bw=bw, launch_counts=launch_counts)
    phases.done("16")

    # -- 17. slice 8b: the LM training path at full width --------------------
    train_out = lm_training(card=card, launch_counts=launch_counts,
                            rates={"bfloat16": bf16_rate,
                                   "float32": fp32_rate})
    phases.done("17")

    # -- 18. slice 7b: the lint, the fused cascade, the examples -------------
    s7b_out = slice7b(card=card, bw=bw, vcfg=vcfg, vgg={
        "fp32": (vcompiled, x_vgg), "int8": (vqcompiled, x_vgg),
        "bf16": (bf16["vgg16"]["compiled"], bf16["vgg16"]["x"])},
        reset_launches=reset_launches, launch_counts=launch_counts)
    phases.done("18")

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
                   "plans": plans_out, "fleet": fleet_out,
                   "artifacts": art_out, "slice7": s7_out, "lm": lm_out,
                   "train": train_out, "slice7b": s7b_out,
                   "phase_seconds": phases.seconds},
                  f, indent=1, sort_keys=True)
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
