#!/usr/bin/env python3
"""Time every tile of the fp32 and int8 conv kernels and every split of
the fp32, bf16 and int8 FC kernels at AlexNet's and VGG-16's batch-8
layers, on one CUDA card.

    python3 tile_sweep.py [--host]

For each conv of the fp32 forwards (seeded weights; each layer's input
the kernel fold's output of the layer before) it times conv_pipe at each
of the four tiles, and prints the tile ``conv_tile`` picks, the fastest,
and each tile's time for one round of blocks an SM relative to the
128x128 tile's on the same layer: the medians over the layers are what
``kernels/conv_pipe.py:FP32_BLOCK_COST`` holds. It times the int8 mode
at each tile on random int8 codes of the same shapes (int8 out) and
prints the int8 pick and the fastest. For each FC layer it times
matmul_pipe's fp32 mode (128, 64 and 32 features), bf16 mode (64 and 32)
and int8 mode (128, 64 and 32; random codes, int8 out at fc6 and fc7,
fp32 at fc8) at 1 to 8 ranks a cluster beside cuBLAS (``torch._int_mm``
+ epilogue for int8), and prints ``fc_split``'s pick. For
decode_attention, fp32 and bf16, at the decode shapes of
``chip_smoke.py`` (phase 5: caches 8 x 32768 slots; phase 6: 1 x 4096;
Qwen3-8B's 8 KV heads, G 4, d_head 128; full and half caches) it times
every split P beside the slot write + SDPA and prints ``decode_split``'s
pick against the fastest. Then the host time of one wrapper call
(enqueue only): matmul_pipe bf16 beside torch.addmm, conv_pipe fp32,
lrn_pwl fp32 and bf16 at AlexNet's lrn2, flash_attention fp32, and
where the wrappers take a pinned plan conv_pipe and matmul_pipe with
one; then the AlexNet batch-8 forwards in fp32, int8 and bf16, which
their launches' host time paces (``chip_smoke.time_ms``, median of 5);
with ``--host`` only these lines. Kernel times are CUDA-graph replays
(``chip_smoke.graph_ms``), so the host's pace is out of them.
Needs the repository around it; exits non-zero without a CUDA device.
"""
from __future__ import annotations

import inspect
import os
import statistics
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

TILES = ((128, 128), (128, 64), (64, 128), (64, 64))
# the splits timed at each decode shape: (B, S) -> P
DECODE_SPLITS = {(8, 32768): (1, 2, 3, 4, 5, 6, 7, 8, 10, 12, 16, 24, 32),
                 (1, 4096): (1, 2, 4, 8, 12, 16, 17, 24, 32, 33, 40, 48, 64)}


def sweep_decode(sms: int) -> None:
    """Time decode_attention at every split of :data:`DECODE_SPLITS`, fp32
    and bf16, at pos S - 1 and S / 2 - 1, beside the slot write + SDPA
    (CUDA graphs); print ``decode_split``'s pick and the fastest."""
    import torch
    import torch.nn.functional as F
    from chip_smoke import ATTN_ARCH, graph_ms
    from repro_torch.configs import get_config
    from repro_torch.kernels import decode_attention as dam
    from repro_torch.kernels.decode_attention import (decode_attention,
                                                      decode_split)
    acfg = get_config(ATTN_ARCH)
    hkv, dh = acfg.n_kv_heads, acfg.d_head
    G = acfg.n_heads // hkv
    gen = torch.Generator(device="cuda").manual_seed(3)
    for dtype in (torch.float32, torch.bfloat16):
        for (B, S), splits in DECODE_SPLITS.items():
            kc, vc = (torch.randn((B, S, hkv, dh), generator=gen,
                                  device="cuda").to(dtype) for _ in range(2))
            q = torch.randn((B, hkv, G, dh), generator=gen,
                            device="cuda").to(dtype)
            nk, nv = (torch.randn((B, hkv, dh), generator=gen,
                                  device="cuda").to(dtype) for _ in range(2))
            pick = decode_split(dtype, B, hkv, S, sms)
            for pos in (S - 1, S // 2 - 1):
                p = torch.tensor(pos, dtype=torch.int32, device="cuda")
                ms = {}
                for P in sorted(set(splits) | {pick}):
                    dam.decode_split = lambda *a, P=P: P
                    try:
                        ms[P] = graph_ms(lambda: decode_attention(
                            q, kc, vc, nk, nv, p))
                    finally:
                        dam.decode_split = decode_split

                def library(pos=pos):
                    kc[:, pos] = nk
                    vc[:, pos] = nv
                    return F.scaled_dot_product_attention(
                        q.reshape(B, hkv * G, 1, dh),
                        kc[:, :pos + 1].transpose(1, 2),
                        vc[:, :pos + 1].transpose(1, 2), enable_gqa=True)
                lib = graph_ms(library)
                fast = min(ms, key=ms.get)
                es = torch.finfo(dtype).bits // 8
                gb = es * B * hkv * dh * 2 * (pos + 1) / 1e9
                print(f"[decode {str(dtype)[6:]}] B {B} S {S} pos {pos} "
                      f"({gb:.3f} GB of K and V): " + "  ".join(
                          f"P{P} {t:.4f}" for P, t in ms.items())
                      + f" ms; slot write + SDPA {lib:.4f} ms; decode_split "
                        f"P{pick} {ms[pick]:.4f} ms "
                        f"({gb / ms[pick]:.2f} TB/s), fastest P{fast} "
                        f"{ms[fast]:.4f} ms", flush=True)
            del kc, vc


def host_lines() -> None:
    """Print the host time of one wrapper call (enqueue only; median of 3
    runs of 200 calls) for a few launches that their host time paces."""
    import torch
    from repro_torch.kernels.conv_pipe import conv_pipe
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.lrn_pwl import lrn_pwl
    from repro_torch.kernels.matmul_pipe import matmul_pipe

    def host_us(fn, n=200):
        for _ in range(10):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        return (t1 - t0) / n * 1e6

    x8 = torch.randn((8, 4096), device="cuda").bfloat16()
    w8 = torch.randn((4096, 1000), device="cuda").bfloat16()
    b8 = torch.randn((1000,), device="cuda").bfloat16()
    xc = torch.randn((8, 13, 13, 384), device="cuda")
    wc = torch.randn((3, 3, 384, 256), device="cuda")
    bc = torch.randn((256,), device="cuda")
    xl = torch.randn((8, 27, 27, 256), device="cuda")      # AlexNet lrn2
    xl16 = xl.bfloat16()
    # Qwen3-8B's heads at a short prefill, so the card keeps up with 200
    # enqueued calls
    qa = torch.randn((1, 32, 128, 128), device="cuda")
    ka = torch.randn((1, 8, 128, 128), device="cuda")
    for name, fn in (
            ("matmul_pipe bf16 8x4096x1000",
             lambda: matmul_pipe(x8, w8, b8, relu=True)),
            ("torch.addmm+relu_ bf16 8x4096x1000",
             lambda: torch.addmm(b8, x8, w8).relu_()),
            ("conv_pipe fp32 8x13x13x384 3x3x384x256",
             lambda: conv_pipe(xc, wc, bc, pad=1)),
            ("lrn_pwl fp32 8x27x27x256", lambda: lrn_pwl(xl)),
            ("lrn_pwl bf16 8x27x27x256", lambda: lrn_pwl(xl16)),
            ("flash_attention fp32 1x32x128x128 (8 KV heads)",
             lambda: flash_attention(qa, ka, ka))):
        runs = [host_us(fn) for _ in range(3)]
        print(f"[host] {name}: {statistics.median(runs):.1f} us a call on "
              f"the host (enqueue; median of 3 runs of 200)")
    if "tile" in inspect.signature(conv_pipe).parameters:
        # a compiled forward pins each launch's plan
        for name, fn in (
                ("conv_pipe fp32 8x13x13x384 3x3x384x256, tile pinned",
                 lambda: conv_pipe(xc, wc, bc, pad=1, tile=(64, 64, 1, 1))),
                ("matmul_pipe bf16 8x4096x1000, split pinned",
                 lambda: matmul_pipe(x8, w8, b8, relu=True, split=(64, 5)))):
            runs = [host_us(fn) for _ in range(3)]
            print(f"[host] {name}: {statistics.median(runs):.1f} us a call "
                  f"on the host (enqueue; median of 3 runs of 200)")
    # the AlexNet forwards whose launches the host paces
    from chip_smoke import time_ms
    from repro_torch.configs import get_config
    from repro_torch.pipeline import ExecutionSpec, Precision, compile_cnn
    cfg = get_config("alexnet")
    gen = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((8, cfg.input_hw, cfg.input_hw, cfg.input_ch),
                    generator=gen, device="cuda")
    params = compile_cnn(cfg, generator=gen, device="cuda").params
    for mode, prec in (("fp32", Precision()), ("int8", Precision(
            quant="int8")), ("bf16", Precision(dtype="bfloat16"))):
        c = compile_cnn(cfg, ExecutionSpec(precision=prec), params,
                        device="cuda")
        runs = [time_ms(lambda c=c: c.forward(x)) for _ in range(5)]
        print(f"[host] forward alexnet {mode} batch 8: "
              f"{statistics.median(runs):.4f} ms (median of 5 chip_smoke "
              f"time_ms runs: {', '.join(f'{r:.4f}' for r in runs)})")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("tile_sweep: no CUDA device", file=sys.stderr)
        return 2
    from chip_smoke import graph_ms, smi
    from repro_torch.configs import get_config
    from repro_torch.kernels import conv_pipe as cpm
    from repro_torch.kernels import matmul_pipe as mpm
    from repro_torch.kernels.build import sm_count
    from repro_torch.kernels.conv_pipe import conv_pipe, conv_tile, pool_tile
    from repro_torch.kernels.lrn_pwl import lrn_pwl
    from repro_torch.kernels.matmul_pipe import fc_split, matmul_pipe
    from repro_torch.kernels.ref import pool_ref
    from repro_torch.models.cnn import fuse_plan
    from repro_torch.pipeline import ExecutionSpec, compile_cnn

    print(smi("name,power.limit"))
    if sys.argv[1:] == ["--host"]:
        host_lines()
        return 0
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    sms = sm_count(torch.device("cuda", 0))

    def forced(tile):
        def pick(dtype, B, OH, OW, mg, groups, pool, pool_k, pool_s, n, cg):
            if pool is None:
                return (*tile, 1, 1)
            return (*tile, *pool_tile((OH - pool_k) // pool_s + 1,
                                      (OW - pool_k) // pool_s + 1, pool_k,
                                      pool_s, tile[0]))
        return pick

    def blocks(tile, tph, tpw, B, OH, OW, mg, groups, pool, pool_k, pool_s):
        tp, tn = tile
        if pool is None:
            n = -(-B * OH * OW // tp)
        else:
            ph, pw = (OH - pool_k) // pool_s + 1, (OW - pool_k) // pool_s + 1
            n = B * -(-ph // tph) * -(-pw // tpw)
        return n * groups * -(-mg // tn)

    rel = {t: [] for t in TILES}
    picked = best = picked8 = best8 = 0.0
    fcs = []
    gen = torch.Generator(device="cuda").manual_seed(0)
    with torch.inference_mode():
        for arch in ("alexnet", "vgg16"):
            cfg = get_config(arch)
            params = compile_cnn(cfg, ExecutionSpec(), generator=gen,
                                 device="cuda").params
            h = torch.randn((8, cfg.input_hw, cfg.input_hw, cfg.input_ch),
                            generator=gen, device="cuda")
            for group in fuse_plan(cfg):
                l = cfg.layers[group[0]]
                if l.kind == "fc":
                    fcs.append((arch, group, h.shape[0],
                                *params[group[0]]["w"].shape))
                    continue
                if l.kind == "lrn":
                    h = lrn_pwl(h)
                    continue
                if l.kind == "pool":
                    h = pool_ref(h, l.pool, l.kernel, l.stride)
                    continue
                pool = cfg.layers[group[1]] if len(group) == 2 else None
                kw = dict(stride=l.stride, pad=l.pad, relu=l.relu,
                          pool=pool.pool if pool else None,
                          pool_k=pool.kernel if pool else 2,
                          pool_s=pool.stride if pool else 2, groups=l.groups)
                w, b = params[group[0]]["w"], params[group[0]]["b"]
                oh = (h.shape[1] + 2 * l.pad - l.kernel) // l.stride + 1
                ow = (h.shape[2] + 2 * l.pad - l.kernel) // l.stride + 1
                geo = (h.shape[0], oh, ow, l.out_ch // l.groups, l.groups,
                       kw["pool"], kw["pool_k"], kw["pool_s"])
                cg = h.shape[3] // l.groups
                pick = conv_tile(torch.float32, *geo, sms, cg)
                ms, rounds = {}, {}
                for tile in TILES:
                    if pool is not None and pool.kernel ** 2 > tile[0]:
                        continue
                    t = forced(tile)(torch.float32, *geo, sms, cg)
                    rounds[tile] = -(-blocks(tile, *t[2:], *geo) // sms)
                    cpm.conv_tile = forced(tile)
                    try:
                        ms[tile] = graph_ms(lambda: conv_pipe(h, w, b, **kw))
                    finally:
                        cpm.conv_tile = conv_tile
                fast = min(ms, key=ms.get)
                base = ms[128, 128] / rounds[128, 128] if (128, 128) in ms \
                    else None
                for tile in ms:
                    if base is not None:
                        rel[tile].append(ms[tile] / rounds[tile] / base)
                picked += ms[pick[:2]]
                best += ms[fast]
                print(f"[conv] {arch} {group}: " + "  ".join(
                    f"{a}x{b} {t:.4f} ms ({rounds[a, b]} rounds)"
                    for (a, b), t in ms.items())
                    + f"; conv_tile {pick[0]}x{pick[1]}, fastest "
                      f"{fast[0]}x{fast[1]}", flush=True)
                # the int8 mode on codes of the same shapes
                h8 = torch.randint(-127, 128, h.shape, generator=gen,
                                   device="cuda", dtype=torch.int8)
                w8 = torch.randint(-127, 128, w.shape, generator=gen,
                                   device="cuda", dtype=torch.int8)
                kw8 = dict(kw, scale=torch.full((w.shape[3],), 1e-4,
                                                device="cuda"),
                           out_scale=3.0 / 127)
                pick8 = conv_tile(torch.int8, *geo, sms, cg)
                ms8 = {}
                for tile in TILES:
                    if pool is not None and pool.kernel ** 2 > tile[0]:
                        continue
                    cpm.conv_tile = forced(tile)
                    try:
                        ms8[tile] = graph_ms(
                            lambda: conv_pipe(h8, w8, b, **kw8))
                    finally:
                        cpm.conv_tile = conv_tile
                fast8 = min(ms8, key=ms8.get)
                picked8 += ms8[pick8[:2]]
                best8 += ms8[fast8]
                print(f"[conv int8] {arch} {group}: " + "  ".join(
                    f"{a}x{b} {t:.4f} ms" for (a, b), t in ms8.items())
                    + f"; conv_tile {pick8[0]}x{pick8[1]}, fastest "
                      f"{fast8[0]}x{fast8[1]}", flush=True)
                h = conv_pipe(h, w, b, **kw)
    print(f"[conv] sum of conv_tile's tiles {picked:.4f} ms, of the fastest "
          f"{best:.4f} ms")
    print(f"[conv int8] sum of conv_tile's tiles {picked8:.4f} ms, of the "
          f"fastest {best8:.4f} ms")
    for tile, r in rel.items():
        print(f"[conv] {tile[0]}x{tile[1]}: a round of blocks costs "
              f"{statistics.median(r):.3f} of a 128x128 round (median of "
              f"{len(r)} layers; {min(r):.3f}-{max(r):.3f}); FP32_BLOCK_COST "
              f"{cpm.FP32_BLOCK_COST[tile]}")

    seen = set()
    for dtype, tag in ((torch.float32, "fc fp32"), (torch.bfloat16, "fc"),
                       (torch.int8, "fc int8")):
        for arch, group, M, K, N in fcs:
            if (dtype, M, K, N) in seen:
                continue
            seen.add((dtype, M, K, N))
            if dtype == torch.int8:
                # random codes; int8 out (fc6, fc7) or fp32 out (fc8)
                x, w = (torch.randint(-127, 128, shape, generator=gen,
                                      device="cuda", dtype=torch.int8)
                        for shape in ((M, K), (K, N)))
                b = torch.randn((N,), generator=gen, device="cuda")
                kw = dict(relu=True, scale=torch.full(
                    (N,), 1e-4, device="cuda"),
                    out_scale=3.0 / 127 if N >= 4096 else None)
                xpad = torch.zeros((32, K), dtype=torch.int8, device="cuda")
                xpad[:M] = x

                def library():
                    y = (torch._int_mm(xpad, w)[:M].float() * kw["scale"]
                         + b).relu_()
                    return y if kw["out_scale"] is None else torch.clamp(
                        torch.round(y / kw["out_scale"]), -127, 127).to(
                        torch.int8)
                libname = "torch._int_mm + epilogue"
            else:
                x = torch.randn((M, K), generator=gen,
                                device="cuda").to(dtype)
                w = (torch.randn((K, N), generator=gen, device="cuda")
                     * 0.02).to(dtype)
                b = torch.randn((N,), generator=gen, device="cuda").to(dtype)
                kw = dict(relu=True)

                def library():
                    return torch.addmm(b, x, w).relu_()
                libname = "cuBLAS"
            ms = {}
            for tnf in mpm.FC_FEATURES[dtype]:
                for r in range(1, mpm.FC_RANKS + 1):
                    if r > -(-K // mpm.fc_chunk(dtype, tnf)):
                        continue
                    mpm.fc_split = lambda *a, s=(tnf, r): s
                    try:
                        ms[tnf, r] = graph_ms(
                            lambda: matmul_pipe(x, w, b, **kw))
                    finally:
                        mpm.fc_split = fc_split
            lib = graph_ms(library)
            pick = fc_split(dtype, M, K, N, sms)
            fast = min(ms, key=ms.get)
            print(f"[{tag}] {arch} {group} {M}x{K}x{N}: " + "  ".join(
                f"{a}x{r} {t:.4f}" for (a, r), t in ms.items())
                + f" ms; {libname} {lib:.4f} ms; fc_split {pick[0]}x"
                  f"{pick[1]} {ms[pick]:.4f} ms, fastest {fast[0]}x{fast[1]} "
                  f"{ms[fast]:.4f} ms", flush=True)

    sweep_decode(sms)

    host_lines()
    return 0


if __name__ == "__main__":
    sys.exit(main())
