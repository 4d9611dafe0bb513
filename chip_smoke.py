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
   and matmul_pipe 3x, and its logits must match the same forward on the
   CPU (plain versions).
4. Serve: 19 synthetic requests through ``.serve`` launch the same
   kernels per round; each request ends as one ``ok`` completion whose
   prediction matches the forward.
5. One JSON line ``{"kernels": [...]}``, then the last line
   ``{"ok": true, "device": {...}}``.

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
EXPECTED_LAUNCHES = {"conv_pipe": 5, "lrn_pwl": 2, "matmul_pipe": 3}
REPLACES = {"conv_pipe": "src/repro/kernels/conv_pipe.py:198",
            "lrn_pwl": "src/repro/kernels/lrn_pwl.py:88",
            "matmul_pipe": "src/repro/kernels/matmul_pipe.py:66"}
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
    from repro_torch.kernels.ref import lrn_ref
    from repro_torch.launch.serve_cnn import (default_request_count,
                                              synthetic_requests)
    from repro_torch.models.cnn import fuse_plan, run_group
    from repro_torch.pipeline import ExecutionSpec, Serving, compile_cnn
    from repro_torch.serve import latency_report
    kernels = {"conv_pipe": conv_pipe, "lrn_pwl": lrn_pwl,
               "matmul_pipe": matmul_pipe}

    # -- 1. device and build ------------------------------------------------
    card = smi("name,power.limit")
    print(card)
    name = torch.cuda.get_device_name(0)
    props = torch.cuda.get_device_properties(0)
    sm_mhz = float(smi("clocks.max.sm").split()[0])
    fp32_rate = props.multi_processor_count * 128 * 2 * sm_mhz * 1e6
    bw = next((v for k, v in MEM_BW.items() if k in name), None)
    bw_src = "published" if bw else "assumed (H100 SXM)"
    bw = bw or MEM_BW["H100 80GB HBM3"]
    print(f"[device] {name}: {props.multi_processor_count} SMs, max SM "
          f"clock {sm_mhz:.0f} MHz -> fp32 FFMA {fp32_rate / 1e12:.1f} "
          f"TFLOP/s; HBM {bw / 1e12:.2f} TB/s ({bw_src}); torch "
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
                row["ms"] = time_ms(row.pop("run"))
                row["plain_ms"] = time_ms(row.pop("plain"))
                row["library_ms"] = time_ms(row.pop("library"))
                t_ops, t_bytes = row["ops"] / fp32_rate, row["bytes"] / bw
                row["bound_ms"] = max(t_ops, t_bytes) * 1e3
                row["bound_by"] = "operations" if t_ops >= t_bytes \
                    else "bytes"
                print(f"[kernel] {row['layer']:>14} {row['kernel']:<11} "
                      f"{str(row['shape']):<22} err {row['max_abs_err']:.3e}"
                      f" (tol {row['tol']:.1e})  kernel {row['ms']:.4f} ms"
                      f"  plain {row['plain_ms']:.4f} ms  library "
                      f"{row['library_ms']:.4f} ms  bound "
                      f"{row['bound_ms']:.4f} ms ({row['bound_by']})")
                check(row["max_abs_err"] <= row["tol"],
                      f"{row['layer']} {row['kernel']}: error "
                      f"{row['max_abs_err']:.3e} > tol {row['tol']:.1e}")
                rows.append(row)
            h = run_group(params, h, cfg, group, use_kernels=False)

    # -- 3. the full forward through the entry point --------------------------
    for k in kernels.values():
        k.launches = 0
    logits = compiled.forward(x)
    torch.cuda.synchronize()
    launches = {n: k.launches for n, k in kernels.items()}
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
    for k in kernels.values():
        k.launches = 0
    rep = compiled.serve(reqs)
    torch.cuda.synchronize()
    served = {n: k.launches for n, k in kernels.items()}
    n_fwd = rep.rounds + 1              # one forward per round + warm-up
    print(f"[serve] launches {served} over {n_fwd} forwards")
    check(served == {n: v * n_fwd for n, v in EXPECTED_LAUNCHES.items()},
          f"serve launches {served} != {n_fwd} x {EXPECTED_LAUNCHES}")
    done = sorted(rep.completions, key=lambda c: c.rid)
    check([c.rid for c in done] == list(range(n_req))
          and all(c.status == "ok" for c in done),
          f"serve: {len(done)} completions for {n_req} requests")
    imgs = torch.from_numpy(np.stack([r.image for r in reqs])).cuda()
    preds = torch.cat([compiled.forward(imgs[i:i + BATCH]).argmax(-1)
                       for i in range(0, n_req, BATCH)]).tolist()
    check([c.pred for c in done] == preds,
          "serve predictions differ from the forward's")
    lat = latency_report(rep.completions)
    print(f"[serve] {rep.summary()}")
    print(f"[serve] latency_report {json.dumps(lat)}")

    # -- 5. the kernels line ----------------------------------------------------
    line = []
    for kname in kernels:
        rs = [r for r in rows if r["kernel"] == kname]
        t_ops = sum(r["ops"] for r in rs) / fp32_rate
        t_bytes = sum(r["bytes"] for r in rs) / bw
        line.append({
            "name": kname, "route": "cuda",
            "source": f"src/repro_torch/csrc/{kname}.cu",
            "replaces": REPLACES[kname], "launches": launches[kname],
            "max_abs_err": max(r["max_abs_err"] for r in rs),
            "ms": sum(r["ms"] for r in rs),
            "plain_ms": sum(r["plain_ms"] for r in rs),
            "bound_ms": sum(r["bound_ms"] for r in rs),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": sum(r["library_ms"] for r in rs)})
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    with open(os.path.join(ROOT, "chiprun_out", "chip_smoke.json"), "w") as f:
        json.dump({"card": card, "device": name, "fp32_rate": fp32_rate,
                   "mem_bw": bw, "mem_bw_source": bw_src,
                   "rows": rows, "kernels": line,
                   "forward": {"ms": fwd_ms, "logit_err": err,
                               "logit_tol": tol, "top1": top1,
                               "launches": launches},
                   "serve": {"report": rep.to_dict(), "latency": lat}},
                  f, indent=1, sort_keys=True)
    print(json.dumps({"kernels": line}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
