"""The plain reference of the benchmark's CNNs, in PyTorch alone.

It imports nothing of the program, nor JAX: it reads the configuration's
layers (:mod:`cnnbench.config`) and takes the same weights and images the
benchmark hands the program, and it works out everything the program
derives from them (the int8 scales and codes, the LRN's table) again.

Layouts are the program's inputs': NHWC images, HWIO conv weights and
(K, N) FC weights whose K runs over an NHWC flatten.

Precisions (``forward(..., precision)``):

* ``"float32"``: fp32 throughout, TF32 off;
* ``"bfloat16"``: what ``Precision(dtype="bfloat16")`` states: bf16
  weights, images and activations, every layer computed in fp32 on the
  widened operands and rounded once to bf16 at its output;
* ``"int8"`` / ``"int4"``: symmetric fixed point as PipeCNN deploys it,
  with ``qmax`` 127 or 7: per-output-channel weight codes, per-tensor
  activation steps calibrated by abs-max on a calibration batch (an fp32
  forward with the exact LRN), exact integer sums, and an fp32 epilogue
  (times the step product, plus the bias, ReLU, pool, requantize, each
  rounded in turn); the LRN runs on the dequantized codes and is
  requantized; a standalone max pool takes the codes.

Every precision computes the LRN by PipeCNN's piecewise-linear z^-beta
(:func:`lrn_pwl`), the configuration's LRN, except the calibration
forward, which observes the exact one.

The layers are a graph (:mod:`cnnbench.config`): each function runs the
fusion groups in order and keeps a group's output while a later group
reads it. A conv with a ``residual`` adds its source's output, in this
order, each operation rounded to fp32:

* ``"float32"`` / ``"bfloat16"``: ``y = conv + b``, then ``y = y +
  src.float()``, then the ReLU and the group's pool; the result is rounded
  once to the run dtype;
* ``"int8"`` / ``"int4"``: ``y = acc.float() * mult + b``, then ``y = y +
  src_codes.float() * src_step``, then the ReLU, the pool and the
  requantize to the group's output step.

A max pool pads with minus infinity (with the least code on codes); an
avg pool sums its window in fp32 in row-major order and divides by the
window's size, and takes no codes.
"""
from __future__ import annotations

import math
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from cnnbench.config import group_sources, layers

QMAX = {"int8": 127, "int4": 7}
EPS = 1e-12


def _tf32_off():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def conv(x, w, b, l, pool_layer=None, res=None):
    """fp32 conv + bias (+ the residual ``res``) (+ ReLU) (+ the group's
    pool), NHWC in and out, contiguous."""
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                 stride=l["stride"], padding=l["pad"], groups=l["groups"])
    y = y.permute(0, 2, 3, 1) + b
    if res is not None:
        y = y + res.float()
    if l["relu"]:
        y = torch.clamp_min(y, 0.0)
    if pool_layer is not None:
        y = pool(y, pool_layer)
    return y.contiguous()


def pool(x, l):
    """``l``'s pool of NHWC ``x``: a max pool over the window padded with
    ``l["pad"]`` of the least value (minus infinity; the least code on
    codes), an avg pool as the fp32 row-major sum of the window over its
    size, in ``x``'s dtype."""
    k, s, p = l["kernel"], l["stride"], l["pad"]
    if l["pool"] == "max":
        if p:
            low = -math.inf if x.is_floating_point() \
                else torch.iinfo(x.dtype).min
            x = F.pad(x, (0, 0, p, p, p, p), value=low)
        win = x.unfold(1, k, s).unfold(2, k, s)
        return win.amax(dim=(-2, -1)).contiguous()
    if not x.is_floating_point():
        raise ValueError("cnnbench: an avg pool takes no codes: fuse it "
                         "with the conv before it")
    oh = (x.shape[1] - k) // s + 1
    ow = (x.shape[2] - k) // s + 1
    acc = None
    for i in range(k):
        for j in range(k):
            sl = x[:, i:i + (oh - 1) * s + 1:s, j:j + (ow - 1) * s + 1:s]
            acc = sl.float() if acc is None else acc + sl.float()
    return (acc / float(k * k)).to(x.dtype).contiguous()


def run_groups(cfg: dict, x, step):
    """``step(group, h, res)`` over the fusion groups in order, ``h`` the
    output the group reads (``x`` for the image) and ``res`` its
    residual's source (None without one); each output is kept while a
    later group reads it. Returns the last group's output."""
    plan = group_sources(cfg)
    last = {}
    for gi, (_, src, res) in enumerate(plan):
        last[src] = gi
        if res is not None:
            last[res] = gi
    outs = {-1: x}
    for gi, (group, src, res) in enumerate(plan):
        y = step(group, outs[src], None if res is None else outs[res])
        for j in [j for j, g in last.items() if g == gi]:
            del outs[j]
        outs[group[-1]] = y
    return y


def fc(x, w, b, l):
    y = x.reshape(x.shape[0], -1).float() @ w.float() + b.float()
    return torch.clamp_min(y, 0.0) if l["relu"] else y


def _window_sum(sq: torch.Tensor, n: int) -> torch.Tensor:
    acc = sq
    for d in range(1, n // 2 + 1):
        acc = acc + F.pad(sq[..., d:], (0, d))
        acc = acc + F.pad(sq[..., :-d], (d, 0))
    return acc


def lrn_exact(x: torch.Tensor, p: dict) -> torch.Tensor:
    z = p["k"] + (p["alpha"] / p["n"]) * _window_sum(x * x, p["n"])
    return x * z ** (-p["beta"])


def pwl_table(p: dict):
    """PipeCNN's table for z^-beta: each octave of z in [2^min, 2^max) cut
    into 2^sub_bits linear pieces, addressed by the float's exponent and
    top mantissa bits; each chord lowered by half its largest deviation."""
    sub = 1 << p["pwl_sub_bits"]
    lo, hi, beta = p["pwl_min_exp"], p["pwl_max_exp"], p["beta"]
    edges = np.concatenate([2.0 ** e * (1.0 + np.arange(sub) / sub)
                            for e in range(lo, hi)] + [[2.0 ** hi]])
    f = edges ** (-beta)
    slope = (f[1:] - f[:-1]) / (edges[1:] - edges[:-1])
    icpt = f[:-1] - slope * edges[:-1]
    for i in range(len(slope)):
        zs = np.linspace(edges[i], edges[i + 1], 65)
        icpt[i] -= ((slope[i] * zs + icpt[i]) - zs ** (-beta)).max() / 2.0
    return (slope.astype(np.float32), icpt.astype(np.float32),
            23 - p["pwl_sub_bits"], (127 + lo) << p["pwl_sub_bits"])


def lrn_pwl(x: torch.Tensor, p: dict) -> torch.Tensor:
    """The piecewise-linear LRN on fp32 ``x``."""
    slope, icpt, shift, base = pwl_table(p)
    slope = torch.from_numpy(slope).to(x.device)
    icpt = torch.from_numpy(icpt).to(x.device)
    z = p["k"] + (p["alpha"] / p["n"]) * _window_sum(x * x, p["n"])
    addr = ((z.view(torch.int32) >> shift) - base).clamp(0, len(slope) - 1)
    return x * (slope[addr] * z + icpt[addr])


# ---------------------------------------------------------------------------
# float precisions
# ---------------------------------------------------------------------------

def forward(cfg: dict, params: List[Optional[Dict[str, torch.Tensor]]],
            x: torch.Tensor, precision: str) -> torch.Tensor:
    """Logits (B, classes) in fp32 of images ``x`` (B, H, W, C) in a float
    precision, ``"float32"`` or ``"bfloat16"``."""
    _tf32_off()
    dt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[precision]
    ls = layers(cfg)

    def step(group, h, res):
        l, p = ls[group[0]], params[group[0]]
        if l["kind"] == "conv":
            y = conv(h.float(), p["w"].float(), p["b"].float(), l,
                     ls[group[1]] if len(group) == 2 else None, res)
        elif l["kind"] == "pool":
            y = pool(h.float(), l)
        elif l["kind"] == "lrn":
            y = lrn_pwl(h.float(), cfg["lrn"])
        else:
            y = fc(h, p["w"], p["b"], l)
        return y.to(dt)
    with torch.inference_mode():
        return run_groups(cfg, x.to(dt), step).float()


# ---------------------------------------------------------------------------
# fixed point
# ---------------------------------------------------------------------------

def _f32(v: float, like: torch.Tensor) -> torch.Tensor:
    return torch.full((), v, dtype=torch.float32, device=like.device)


def quant(x: torch.Tensor, step, qmax: int) -> torch.Tensor:
    """Codes clip(round_half_even(x / step), -qmax, qmax), as int8 values;
    ``step`` a float (rounded to fp32) or an fp32 tensor."""
    s = _f32(step, x) if isinstance(step, float) else step
    return torch.clamp(torch.round(x.float() / s), -qmax, qmax).to(torch.int8)


def calibrate(cfg: dict, params, calib: torch.Tensor, qmax: int) -> dict:
    """Steps and codes of the fixed-point model: the abs-max of the fp32
    forward (exact LRN) on ``calib`` at the input and at every group
    output whose step is used (not after a standalone pool, which passes
    its input's step on, nor after the last group, whose logits stay
    fp32); weights per output channel. A group reads its input's codes at
    ``in_step`` and its residual's at ``res_step``."""
    _tf32_off()
    ls = layers(cfg)
    amax = {}

    def step(group, h, res):
        l, p = ls[group[0]], params[group[0]]
        if l["kind"] == "conv":
            y = conv(h, p["w"].float(), p["b"].float(), l,
                     ls[group[1]] if len(group) == 2 else None, res)
        elif l["kind"] == "pool":
            y = pool(h, l)
        elif l["kind"] == "lrn":
            y = lrn_exact(h, cfg["lrn"])
        else:
            y = fc(h, p["w"], p["b"], l)
        amax[group] = float(y.abs().max())
        return y
    with torch.inference_mode():
        h = calib.float()
        in_amax = float(h.abs().max())
        run_groups(cfg, h, step)
    q = {"in_step": max(in_amax, EPS) / qmax, "groups": {}}
    steps = {-1: q["in_step"]}
    plan = group_sources(cfg)
    for gi, (group, src, res) in enumerate(plan):
        l = ls[group[0]]
        in_step = steps[src]
        out_step = None if gi == len(plan) - 1 \
            else max(amax[group], EPS) / qmax
        g = {"in_step": in_step, "out_step": out_step}
        if l["kind"] in ("conv", "fc"):
            w = params[group[0]]["w"].float()
            red = tuple(range(w.dim() - 1))
            ws = torch.clamp_min(w.abs().amax(dim=red, keepdim=True), EPS) \
                / _f32(float(qmax), w)
            g["w_q"] = quant(w, ws, qmax)
            g["mult"] = ws.reshape(-1) * _f32(in_step, w)
            g["b"] = params[group[0]]["b"].float()
            if res is not None:
                g["res_step"] = steps[res]
        elif l["kind"] == "pool":
            g["out_step"] = in_step
        q["groups"][group] = g
        steps[group[-1]] = g["out_step"] if g["out_step"] is not None \
            else in_step
    return q


def _conv_int(q: torch.Tensor, w_q: torch.Tensor, l: dict) -> torch.Tensor:
    """The exact integer sums of a grouped conv on codes, in float64 (every
    partial sum is an integer far below 2^53)."""
    x = q.permute(0, 3, 1, 2).double()
    kh, kw, cg, m = w_q.shape
    g, s, pad = l["groups"], l["stride"], l["pad"]
    b, _, h, wd = x.shape
    oh = (h + 2 * pad - kh) // s + 1
    ow = (wd + 2 * pad - kw) // s + 1
    cols = F.unfold(x, (kh, kw), padding=pad, stride=s)
    wm = w_q.permute(3, 2, 0, 1).double().reshape(g, m // g, cg * kh * kw)
    acc = wm @ cols.reshape(b, g, cg * kh * kw, oh * ow)
    return acc.reshape(b, m, oh, ow).permute(0, 2, 3, 1)


def forward_fixed(cfg: dict, qm: dict, x: torch.Tensor, qmax: int
                  ) -> torch.Tensor:
    """fp32 logits of the fixed-point model ``qm`` (:func:`calibrate`) on
    fp32 images ``x``."""
    ls = layers(cfg)

    def step(group, h, res):
        l, g = ls[group[0]], qm["groups"][group]
        if l["kind"] in ("conv", "fc"):
            if l["kind"] == "conv":
                acc = _conv_int(h, g["w_q"], l)
            else:
                acc = h.reshape(h.shape[0], -1).double() @ g["w_q"].double()
            y = acc.float() * g["mult"] + g["b"]
            if res is not None:
                y = y + res.float() * _f32(g["res_step"], y)
            if l["relu"]:
                y = torch.clamp_min(y, 0.0)
            if len(group) == 2:
                y = pool(y, ls[group[1]])
            return y if g["out_step"] is None else \
                quant(y, g["out_step"], qmax)
        if l["kind"] == "pool":
            return pool(h, l)
        y = lrn_pwl(h.float() * _f32(g["in_step"], h), cfg["lrn"])
        return quant(y, g["out_step"], qmax)
    with torch.inference_mode():
        return run_groups(cfg, quant(x, qm["in_step"], qmax), step).float()


def logits(cfg: dict, params, x: torch.Tensor, precision: str, *,
           calib: Optional[torch.Tensor] = None, block: int = 64
           ) -> torch.Tensor:
    """The reference's fp32 logits of ``x`` in ``precision``, in blocks of
    ``block`` images (a fixed-point precision calibrates on ``calib``
    first)."""
    if precision in QMAX:
        qmax = QMAX[precision]
        qm = calibrate(cfg, params, calib, qmax)
        run = lambda xb: forward_fixed(cfg, qm, xb, qmax)
    else:
        run = lambda xb: forward(cfg, params, xb, precision)
    return torch.cat([run(x[i:i + block]) for i in range(0, len(x), block)])


def top1_gap(ref: torch.Tensor, picks: torch.Tensor) -> torch.Tensor:
    """How far below the reference's best logit each picked class's logit
    lies, in units of the row's standard deviation (inf for a pick that is
    no class)."""
    ref = ref.float()
    n = ref.shape[1]
    ok = (picks >= 0) & (picks < n)
    got = ref.gather(1, picks.clamp(0, n - 1).long()[:, None])[:, 0]
    gap = (ref.max(dim=1).values - got) / ref.std(dim=1)
    return torch.where(ok, gap, torch.full_like(gap, math.inf))
