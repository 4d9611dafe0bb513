#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases (any failure exits non-zero):

1. Device: the card's name and power limit, and a build of the CUDA
   kernels from ``src/repro_torch/csrc`` with nvcc (build time printed).
2. Kernel vs plain, with TF32 off: each of conv_pipe, lrn_pwl and
   matmul_pipe is held against its plain PyTorch version on the inputs
   AlexNet's batch-8 forward gives it, and timed beside the plain version,
   one library call and the card's bound.
3. Full forward: ``compile_cnn(alexnet, batch 8).forward(x)`` at full
   width with seeded random weights must launch conv_pipe 5x, lrn_pwl 2x
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
   one library call where one exists and the card's bound.
3b. int8 forward: ``.forward(x)`` must launch the int8 conv mode 5x,
   lrn_pwl 2x and the int8 matmul mode 3x (and no fp32 conv or matmul),
   and its logits must equal bit for bit the fold of 2b over the kernels'
   plain versions (``use_kernels=False`` runs the exact-power LRN, not
   the PWL, so it is printed beside them, as is the top-1 agreement with
   the fp32 forward).
4b. int8 serve: the same 19 requests through the int8 model.
5. One JSON line ``{"kernels": [...]}`` (each kernel and mode), then the
   last line ``{"ok": true, "device": {...}}``.

Details go to ``chiprun_out/chip_smoke.json``. Without a CUDA device, or
without the repository around it, it exits non-zero and prints no result.
"""
from __future__ import annotations

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
# launches per forward, by kernel and mode (name_s8: the int8 mode)
EXPECTED_LAUNCHES = {"conv_pipe": 5, "conv_pipe_s8": 0, "lrn_pwl": 2,
                     "matmul_pipe": 3, "matmul_pipe_s8": 0}
EXPECTED_LAUNCHES_INT8 = {"conv_pipe": 0, "conv_pipe_s8": 5, "lrn_pwl": 2,
                          "matmul_pipe": 0, "matmul_pipe_s8": 3}
REPLACES = {"conv_pipe": "src/repro/kernels/conv_pipe.py:198",
            "lrn_pwl": "src/repro/kernels/lrn_pwl.py:88",
            "matmul_pipe": "src/repro/kernels/matmul_pipe.py:66"}
INT8_OPS_PER_CLOCK_SM = 8192   # dense int8 tensor-core ops / clock / SM
INT_MM_ROWS = 32               # torch._int_mm needs more than 16 rows
# published HBM rates (NVIDIA data sheets), by the name nvidia-smi reports
MEM_BW = {"H100 80GB HBM3": 3.35e12, "H100 PCIe": 2.0e12,
          "H100 NVL": 3.9e12, "H200": 4.8e12}


def smi(query: str) -> str:
    return subprocess.run(
        ["nvidia-smi", f"--query-gpu={query}", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.splitlines()[0]


def time_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Median device time of one call, CUDA events around each call."""
    import torch
    for _ in range(warmup):
        fn()
    pairs = []
    for _ in range(iters):
        s = torch.cuda.Event(enable_timing=True)
        e = torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise SystemExit(f"chip_smoke: FAILED: {what}")


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    import numpy as np
    import torch.nn.functional as F
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.kernels.conv_pipe import conv_pipe, conv_pipe_plain
    from repro_torch.kernels.lrn_pwl import lrn_pwl, lrn_pwl_plain
    from repro_torch.kernels.matmul_pipe import matmul_pipe, matmul_pipe_plain
    from repro_torch.kernels.ref import lrn_ref, pool_ref
    from repro_torch.launch.serve_cnn import (default_request_count,
                                              synthetic_requests)
    from repro_torch.models.cnn import fuse_plan, run_group
    from repro_torch.pipeline import (ExecutionSpec, Precision, Serving,
                                      compile_cnn)
    from repro_torch.quant import dequantize, quantize
    from repro_torch.serve import latency_report

    def reset_launches():
        conv_pipe.launches = conv_pipe.launches_s8 = 0
        matmul_pipe.launches = matmul_pipe.launches_s8 = 0
        lrn_pwl.launches = 0

    def launch_counts():
        return {"conv_pipe": conv_pipe.launches,
                "conv_pipe_s8": conv_pipe.launches_s8,
                "lrn_pwl": lrn_pwl.launches,
                "matmul_pipe": matmul_pipe.launches,
                "matmul_pipe_s8": matmul_pipe.launches_s8}

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
        print(f"[kernel] {row['layer']:>14} {row['kernel']:<14} "
              f"{str(row['shape']):<22} err {row['max_abs_err']:.3e}"
              f" (tol {row['tol']:.1e})  kernel {row['ms']:.4f} ms"
              f"  plain {row['plain_ms']:.4f} ms  library {lib_ms}  "
              f"bound {row['bound_ms']:.4f} ms ({row['bound_by']})")
        check(row["max_abs_err"] <= row["tol"],
              f"{row['layer']} {row['kernel']}: error "
              f"{row['max_abs_err']:.3e} > tol {row['tol']:.1e}")

    # -- 1. device and build ------------------------------------------------
    card = smi("name,power.limit")
    print(card)
    name = torch.cuda.get_device_name(0)
    props = torch.cuda.get_device_properties(0)
    sm_mhz = float(smi("clocks.max.sm").split()[0])
    fp32_rate = props.multi_processor_count * 128 * 2 * sm_mhz * 1e6
    int8_rate = (props.multi_processor_count * INT8_OPS_PER_CLOCK_SM
                 * sm_mhz * 1e6)
    bw = next((v for k, v in MEM_BW.items() if k in name), None)
    bw_src = "published" if bw else "assumed (H100 SXM)"
    bw = bw or MEM_BW["H100 80GB HBM3"]
    print(f"[device] {name}: {props.multi_processor_count} SMs, max SM "
          f"clock {sm_mhz:.0f} MHz -> fp32 FFMA {fp32_rate / 1e12:.1f} "
          f"TFLOP/s, dense int8 tensor cores ({INT8_OPS_PER_CLOCK_SM} "
          f"ops/clock/SM) {int8_rate / 1e12:.1f} TOP/s; HBM "
          f"{bw / 1e12:.2f} TB/s ({bw_src}); torch "
          f"{torch.__version__}, CUDA {torch.version.cuda}")
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

    cfg = get_config("alexnet")
    spec = ExecutionSpec(serving=Serving(batch=BATCH))
    gen = torch.Generator(device="cuda").manual_seed(0)
    compiled = compile_cnn(cfg, spec, generator=gen, device="cuda")
    params = compiled.params
    x = torch.randn((BATCH, cfg.input_hw, cfg.input_hw, cfg.input_ch),
                    generator=gen, device="cuda")

    # -- 2. each kernel vs its plain version at AlexNet's shapes ------------
    rows = []
    h = x
    with torch.inference_mode():
        for group in fuse_plan(cfg):
            l = cfg.layers[group[0]]
            p = params[group[0]]
            row = None
            if l.kind == "conv":
                pool = cfg.layers[group[1]] if len(group) == 2 else None
                kw = dict(stride=l.stride, pad=l.pad, relu=l.relu,
                          pool=pool.pool if pool else None,
                          pool_k=pool.kernel if pool else 2,
                          pool_s=pool.stride if pool else 2, groups=l.groups)
                b = 0.1 * torch.randn(l.out_ch, generator=gen, device="cuda")
                got = conv_pipe(h, p["w"], b, **kw)
                want = conv_pipe_plain(h, p["w"], b, **kw)
                xc = h.permute(0, 3, 1, 2).contiguous()
                wc = p["w"].permute(3, 2, 0, 1).contiguous()

                def library(xc=xc, wc=wc, b=b, l=l, pool=pool):
                    y = F.relu(F.conv2d(xc, wc, b, stride=l.stride,
                                        padding=l.pad, groups=l.groups))
                    return F.max_pool2d(y, pool.kernel, pool.stride) \
                        if pool else y
                ops = 2 * got.shape[0] * p["w"].numel() * (
                    (h.shape[1] + 2 * l.pad - l.kernel) // l.stride + 1) * (
                    (h.shape[2] + 2 * l.pad - l.kernel) // l.stride + 1)
                nbytes = 4 * (h.numel() + p["w"].numel() + b.numel()
                              + got.numel())
                row = dict(kernel="conv_pipe", layer=f"conv{group}",
                           shape=list(h.shape), tol=KERNEL_RTOL * max(
                               1.0, want.abs().max().item()),
                           run=lambda h=h, w=p["w"], b=b, kw=kw:
                           conv_pipe(h, w, b, **kw),
                           plain=lambda h=h, w=p["w"], b=b, kw=kw:
                           conv_pipe_plain(h, w, b, **kw),
                           library=library, ops=ops, bytes=nbytes)
            elif l.kind == "lrn":
                got = lrn_pwl(h)
                want = lrn_pwl_plain(h)
                exact = lrn_ref(h)
                pwl_err = ((want - exact).abs()
                           / (exact.abs() + 1e-9)).max().item()
                check(pwl_err < PWL_BOUND,
                      f"PWL error {pwl_err:.3%} vs exact LRN > 0.5%")
                xc = h.permute(0, 3, 1, 2).contiguous()
                row = dict(kernel="lrn_pwl", layer=f"lrn{group}",
                           shape=list(h.shape),
                           tol=LRN_RTOL * want.abs().max().item(),
                           pwl_vs_exact=pwl_err,
                           run=lambda h=h: lrn_pwl(h),
                           plain=lambda h=h: lrn_pwl_plain(h),
                           library=lambda xc=xc: F.local_response_norm(
                               xc, 5, alpha=1e-4, beta=0.75, k=2.0),
                           ops=14 * h.numel(), bytes=8 * h.numel())
            elif l.kind == "fc":
                xf = h.reshape(h.shape[0], -1)
                b = 0.1 * torch.randn(l.out_ch, generator=gen, device="cuda")
                got = matmul_pipe(xf, p["w"], b, relu=l.relu)
                want = matmul_pipe_plain(xf, p["w"], b, relu=l.relu)
                M, K = xf.shape
                N = p["w"].shape[1]
                row = dict(kernel="matmul_pipe", layer=f"fc{group}",
                           shape=[M, K, N], tol=KERNEL_RTOL * max(
                               1.0, want.abs().max().item()),
                           run=lambda xf=xf, w=p["w"], b=b, r=l.relu:
                           matmul_pipe(xf, w, b, relu=r),
                           plain=lambda xf=xf, w=p["w"], b=b, r=l.relu:
                           matmul_pipe_plain(xf, w, b, relu=r),
                           library=lambda xf=xf, w=p["w"], b=b, r=l.relu:
                           (torch.addmm(b, xf, w).relu_() if r
                            else torch.addmm(b, xf, w)),
                           ops=2 * M * K * N,
                           bytes=4 * (M * K + K * N + N + M * N))
            if row is not None:
                torch.cuda.synchronize()
                check(got.shape == want.shape,
                      f"{row['layer']}: shape {tuple(got.shape)} vs "
                      f"{tuple(want.shape)}")
                row["max_abs_err"] = (got - want).abs().max().item()
                measure(row, fp32_rate)
                rows.append(row)
            h = run_group(params, h, cfg, group, use_kernels=False)

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

    # -- 4. serve ---------------------------------------------------------------
    n_req = default_request_count(BATCH)
    reqs = synthetic_requests(n_req, cfg.input_hw, cfg.input_ch, 200.0)
    imgs = torch.from_numpy(np.stack([r.image for r in reqs])).cuda()

    def serve(model, expected, tag):
        """Serve ``reqs`` through ``model``: every request one ``ok``
        completion with the forward's prediction, ``expected`` launches
        per forward."""
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

    # -- 2b. the int8 kernel modes vs their plain versions --------------------
    qspec = ExecutionSpec(precision=Precision(quant="int8"),
                          serving=Serving(batch=BATCH))
    t0 = time.perf_counter()
    qcompiled = compile_cnn(cfg, qspec, params, device="cuda")
    qp = qcompiled.params
    print(f"[int8] calibrated on the default batch ({qspec.precision.calib} "
          f"images, on the card) in {time.perf_counter() - t0:.2f} s; input "
          f"scale {qp.in_scale:.6g}")
    qrows = []
    h = quantize(x, qp.in_scale)
    with torch.inference_mode():
        for group in fuse_plan(cfg):
            l = cfg.layers[group[0]]
            ql = qp.layers[group[0]]
            row = None
            if l.kind == "conv":
                pool = cfg.layers[group[1]] if len(group) == 2 else None
                kw = dict(stride=l.stride, pad=l.pad, relu=l.relu,
                          pool=pool.pool if pool else None,
                          pool_k=pool.kernel if pool else 2,
                          pool_s=pool.stride if pool else 2, groups=l.groups,
                          scale=ql.scale, out_scale=ql.y_scale)
                got = conv_pipe(h, ql.w_q, ql.b, **kw)
                want = conv_pipe_plain(h, ql.w_q, ql.b, **kw)
                ops = 2 * h.shape[0] * ql.w_q.numel() * (
                    (h.shape[1] + 2 * l.pad - l.kernel) // l.stride + 1) * (
                    (h.shape[2] + 2 * l.pad - l.kernel) // l.stride + 1)
                row = dict(kernel="conv_pipe_s8", layer=f"conv{group}",
                           shape=list(h.shape),
                           run=lambda h=h, ql=ql, kw=kw:
                           conv_pipe(h, ql.w_q, ql.b, **kw),
                           plain=lambda h=h, ql=ql, kw=kw:
                           conv_pipe_plain(h, ql.w_q, ql.b, **kw),
                           library=None, ops=ops)
                nbytes = h.numel() + ql.w_q.numel() + 8 * ql.b.numel()
            elif l.kind == "fc":
                xf = h.reshape(h.shape[0], -1)
                kw = dict(relu=l.relu, scale=ql.scale, out_scale=ql.y_scale)
                got = matmul_pipe(xf, ql.w_q, ql.b, **kw)
                want = matmul_pipe_plain(xf, ql.w_q, ql.b, **kw)
                M, K = xf.shape
                N = ql.w_q.shape[1]
                xpad = torch.zeros((max(M, INT_MM_ROWS), K), dtype=torch.int8,
                                   device="cuda")
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
                      f"lrn{group}: lrn_pwl differs from its plain version "
                      f"on the int8 path's input")
                want = quantize(lrn_pwl_plain(xf), ql.y_scale)
            else:
                want = pool_ref(h, l.pool, l.kernel, l.stride)
            if row is not None:
                torch.cuda.synchronize()
                check(got.shape == want.shape and got.dtype == want.dtype,
                      f"{row['layer']}: {got.dtype} {tuple(got.shape)} vs "
                      f"{want.dtype} {tuple(want.shape)}")
                diff = (got.float() - want.float()).abs()
                row["bytes"] = nbytes + got.numel() * got.element_size()
                row["out"] = str(got.dtype).replace("torch.", "")
                row["n_differ"] = int((diff > 0).sum())
                row["max_abs_err"] = diff.max().item()
                row["tol"] = 0.0
                measure(row, int8_rate)
                check(torch.equal(got, want),
                      f"{row['layer']} {row['kernel']}: {row['n_differ']} "
                      f"outputs differ from the plain version")
                qrows.append(row)
            h = want
    plain_qlogits = h

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

    # -- 4b. int8 serve -------------------------------------------------------------
    qrep, qlat = serve(qcompiled, EXPECTED_LAUNCHES_INT8, "int8 serve")

    # -- 5. the kernels line ----------------------------------------------------
    line = []
    for kname, mode, rs, rate, count in (
            ("conv_pipe", "fp32", rows, fp32_rate, launches),
            ("conv_pipe_s8", "int8", qrows, int8_rate, qlaunches),
            ("matmul_pipe", "fp32", rows, fp32_rate, launches),
            ("matmul_pipe_s8", "int8", qrows, int8_rate, qlaunches),
            ("lrn_pwl", "fp32", rows, fp32_rate, launches)):
        rs = [r for r in rs if r["kernel"] == kname]
        base = kname.removesuffix("_s8")
        t_ops = sum(r["ops"] for r in rs) / rate
        t_bytes = sum(r["bytes"] for r in rs) / bw
        libs = [r["library_ms"] for r in rs]
        line.append({
            "name": kname, "mode": mode, "route": "cuda",
            "source": f"src/repro_torch/csrc/{base}.cu",
            "replaces": REPLACES[base], "launches": count[kname],
            "max_abs_err": max(r["max_abs_err"] for r in rs),
            "ms": sum(r["ms"] for r in rs),
            "plain_ms": sum(r["plain_ms"] for r in rs),
            "bound_ms": sum(r["bound_ms"] for r in rs),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None if None in libs else sum(libs)})
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "device": name, "fp32_rate": fp32_rate,
                   "int8_rate": int8_rate, "mem_bw": bw,
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
                                  "latency": qlat}},
                  f, indent=1, sort_keys=True)
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
