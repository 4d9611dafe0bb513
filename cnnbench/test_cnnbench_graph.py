"""Configurations as graphs: ``input``, ``residual``, padded pools and
depthwise convs (``cnnbench/config.py``'s docstring), on the CPU.

* The chain configurations read exactly what they read before the graph
  keys came: digests of their groups, counts, shrunk configuration,
  weights and shrunk reference logits, pinned.
* ResNet-50 v1.5 (He et al., CVPR 2016, Table 1, the 50-layer column,
  with the stride of each downsampling bottleneck on its 3x3 conv, as
  MLPerf's reference and torchvision have it), written out here: its
  shapes, multiply-accumulates and parameters.
* A small two-bottleneck residual network against an independent
  ``torch.nn`` build, its int8 residual epilogue against a hand
  computation, and its int4 control.
* A depthwise chain (MobileNet-v1's) shrinks to valid groups.
"""
import dataclasses
import hashlib
import json
from functools import lru_cache

import pytest
import torch
import torch.nn.functional as F

from cnnbench import config, counts, program, reference, traffic

BENCH = config.load_benchmark()
CPU = torch.device("cpu")
SEED = 2 ** 31 + 35

# chain_digests() of the chain configurations, taken on the commit before
# the graph keys came
CHAIN_DIGESTS = {
    "vgg16_bf16": {
        "groups": "62c61e3846b72936", "counts": "e105ade43dd9cc96",
        "shrink": "2b633f7d626eb4f0", "weights": "23ebcace3b688c97",
        "logits_float32": "004cf21609873f14",
        "logits_bfloat16": "35c3e19854d61f48",
        "logits_int8": "d5b39d4913d4fc45",
        "logits_int4": "e7000983875714be"},
    "alexnet_int8": {
        "groups": "9344f9da13e15222", "counts": "578b1274a8faa3bd",
        "shrink": "d9d876ac7795925a", "weights": "0ebd27f64c9911e9",
        "logits_float32": "33286a51b5f08c2a",
        "logits_bfloat16": "5c641dc64a4eb7ea",
        "logits_int8": "b6d762c9757e55e5",
        "logits_int4": "5ba83a7a99cd3fd1"},
}
MODES = ("float32", "bfloat16", "int8", "int4")


def digest(obj) -> str:
    """sha256 (16 hex digits) of a tensor's bytes, of a list of tensors'
    digests, or of a JSON value."""
    h = hashlib.sha256()
    if isinstance(obj, torch.Tensor):
        t = obj.detach().contiguous()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        h.update(t.numpy().tobytes())
    elif isinstance(obj, list) and obj and isinstance(obj[0], torch.Tensor):
        for t in obj:
            h.update(digest(t).encode())
    else:
        h.update(json.dumps(obj, sort_keys=True).encode())
    return h.hexdigest()[:16]


def published(name):
    return config.read_json(config.config_file(BENCH, name))


def in_mode(cfg, mode):
    """``cfg`` at a reference precision, calibrated on 8 images."""
    fixed = mode in reference.QMAX
    return {**cfg, "precision": {"dtype": "float32" if fixed else mode,
                                 "quant": "int8" if fixed else "none",
                                 "calib_images": 8}}


@lru_cache(maxsize=None)
def chain_digests(name):
    cfg = published(name)
    out = {"groups": digest([list(g) for g in config.fusion_groups(cfg)]),
           "counts": digest([{**r, "group": list(r["group"])}
                             for r in counts.group_counts(cfg, 128)]),
           "shrink": digest(config.shrink(cfg))}
    dt = torch.bfloat16 if cfg["precision"]["dtype"] == "bfloat16" \
        else torch.float32
    ws = traffic.weights(cfg, SEED, CPU, dt)
    out["weights"] = digest([t for p in ws if p for t in (p["w"], p["b"])])
    del ws
    for mode in MODES:
        c = in_mode(config.shrink(cfg), mode)
        p = traffic.weights(c, SEED, CPU, torch.bfloat16
                            if mode == "bfloat16" else torch.float32)
        x = traffic.images(c, 4, SEED, traffic.IMAGES, CPU)
        calib = traffic.calib(c, SEED, CPU) if mode in reference.QMAX \
            else None
        out[f"logits_{mode}"] = digest(reference.logits(c, p, x, mode,
                                                        calib=calib, block=4))
    return out


@pytest.mark.parametrize("part", list(CHAIN_DIGESTS["vgg16_bf16"]))
@pytest.mark.parametrize("name", list(CHAIN_DIGESTS))
def test_chain_configurations_read_as_before(name, part):
    assert chain_digests(name)[part] == CHAIN_DIGESTS[name][part]


# ---------------------------------------------------------------------------
# ResNet-50 v1.5
# ---------------------------------------------------------------------------

def conv(out_ch, k, stride=1, pad=0, **keys):
    return {"kind": "conv", "out_ch": out_ch, "kernel": k, "stride": stride,
            "pad": pad, **keys}


def bottlenecks(ls, x, stages):
    """Append ResNet v1.5 bottlenecks reading layer ``x``: per stage
    ``(width, blocks, stride)``; the first block of a stage has a
    projection shortcut (1x1, the stage's stride, no ReLU), the stride
    sits on the 3x3."""
    for width, blocks, stride in stages:
        for b in range(blocks):
            s = stride if b == 0 else 1
            ls += [conv(width, 1, input=x), conv(width, 3, s, 1)]
            mid, short = len(ls) - 1, x
            if b == 0:
                ls.append(conv(4 * width, 1, s, input=x, relu=False))
                short = len(ls) - 1
            ls.append(conv(4 * width, 1, input=mid, residual=short))
            x = len(ls) - 1


def model(name, hw, ls):
    return {"name": name, "input_hw": hw, "input_ch": 3,
            "n_classes": ls[-1]["out_ch"], "layers": ls,
            "precision": {"dtype": "float32", "quant": "int8",
                          "calib_images": 8},
            "weights": {"conv": "he_normal",
                        "fc": "normal_1_over_sqrt_fan_in", "bias_std": 0.1}}


def resnet50():
    ls = [conv(64, 7, 2, 3),
          {"kind": "pool", "pool": "max", "kernel": 3, "stride": 2,
           "pad": 1}]
    bottlenecks(ls, 1, ((64, 3, 1), (128, 4, 2), (256, 6, 2), (512, 3, 2)))
    ls += [{"kind": "pool", "pool": "avg", "kernel": 7, "stride": 1},
           {"kind": "fc", "out_ch": 1000, "relu": False}]
    return model("resnet50_v15", 224, ls)


def test_resnet50_has_the_published_layers_and_shapes():
    cfg = resnet50()
    ls = cfg["layers"]
    assert sum(l["kind"] == "conv" for l in ls) == 53
    assert sum("residual" in l for l in ls) == 16
    assert sum(l.get("relu") is False for l in ls if l["kind"] == "conv") \
        == 4
    shapes = config.layer_shapes(cfg)
    assert shapes[1] == (56, 56, 64)
    assert shapes[-3:] == [(7, 7, 2048), (1, 1, 2048), (1000,)]
    *_, (g, ins, outs, res) = config.group_shapes(cfg)
    assert (g, ins, outs, res) == ((len(ls) - 1,), (1, 1, 2048), (1000,),
                                   None)


def test_resnet50_multiply_accumulates_an_image():
    assert counts.forward_ops(resnet50(), 1) == 2 * 4_089_184_256


def test_resnet50_weights_draw_its_parameters():
    """torchvision's 25,557,032 less the 26,560 batch-norm scales, which
    fold into the conv weights; the shifts become the conv biases."""
    ws = traffic.weights(resnet50(), 1, CPU, torch.bfloat16)
    assert sum(p["w"].numel() + p["b"].numel() for p in ws if p) \
        == 25_530_472
    assert ws[2]["w"].shape == (1, 1, 64, 64)       # reads the stem pool
    assert ws[4]["w"].shape == (1, 1, 64, 256)      # the projection


def test_resnet50_fuses_the_stem_pool_and_the_global_pool():
    cfg = resnet50()
    groups = config.fusion_groups(cfg)
    n = len(cfg["layers"])
    assert groups[0] == (0, 1)
    assert groups[-2:] == [(n - 3, n - 2), (n - 1,)]
    assert sum(len(g) == 2 for g in groups) == 2


def test_a_residual_conv_reads_its_source_once():
    """The first bottleneck's last conv, int8 at batch 4: 56 x 56 x 64
    codes in, 64 x 256 weight codes, fp32 bias and step products, the
    projection's 56 x 56 x 256 codes read, 56 x 56 x 256 codes out; the
    add's operations are not counted."""
    cfg = resnet50()
    row = [r for r in counts.group_counts(cfg, 4) if r["group"] == (5,)][0]
    assert row["ops"] == 2 * 4 * 56 * 56 * 256 * 64
    assert row["bytes"] == (4 * 56 * 56 * 64 + 64 * 256 + 256 * 8
                            + 4 * 56 * 56 * 256 + 4 * 56 * 56 * 256)


def test_resnet50_shrinks_to_the_least_input_its_global_pool_takes():
    small = config.shrink(resnet50())
    assert small["input_hw"] == 193
    assert config.layer_shapes(small)[-3:] == [(7, 7, 128), (1, 1, 128),
                                                (16,)]
    assert config.fusion_groups(small) == config.fusion_groups(resnet50())


# ---------------------------------------------------------------------------
# a small two-bottleneck residual network
# ---------------------------------------------------------------------------

def two_bottlenecks():
    """A 7x7/2 stem, a 3x3/2 max pool padded by 1, a bottleneck with a
    projection (stride 2) and one with the identity, a global avg pool
    fused with the last conv, an FC: 35 x 35 x 3 in, 10 classes."""
    ls = [conv(8, 7, 2, 3),
          {"kind": "pool", "pool": "max", "kernel": 3, "stride": 2,
           "pad": 1}]
    bottlenecks(ls, 1, ((8, 2, 2),))
    ls += [{"kind": "pool", "pool": "avg", "kernel": 5, "stride": 1},
           {"kind": "fc", "out_ch": 10, "relu": False}]
    return model("two_bottlenecks", 35, ls)


def nn_forward(params, x):
    """The same network in ``torch.nn`` modules, NCHW, on the same
    weights (HWIO -> OIHW)."""
    def conv2d(i, stride=1, pad=0):
        w = params[i]["w"]
        m = torch.nn.Conv2d(w.shape[2], w.shape[3], w.shape[0], stride,
                            pad)
        m.weight.data = w.permute(3, 2, 0, 1).contiguous()
        m.bias.data = params[i]["b"].clone()
        return m
    relu = torch.relu
    h = relu(conv2d(0, 2, 3)(x))
    h = torch.nn.MaxPool2d(3, 2, 1)(h)
    a = relu(conv2d(3, 2, 1)(relu(conv2d(2)(h))))
    h = relu(conv2d(5)(a) + conv2d(4, 2)(h))
    a = relu(conv2d(7, 1, 1)(relu(conv2d(6)(h))))
    h = relu(conv2d(8)(a) + h)
    h = torch.nn.AdaptiveAvgPool2d(1)(h).flatten(1)
    return h @ params[10]["w"] + params[10]["b"]


def test_two_bottlenecks_groups():
    cfg = two_bottlenecks()
    assert config.fusion_groups(cfg) == [(0, 1), (2,), (3,), (4,), (5,),
                                         (6,), (7,), (8, 9), (10,)]
    assert [l.get("residual") for l in cfg["layers"]][5:9] == [4, None,
                                                               None, 5]


def test_the_fp32_reference_equals_a_torch_nn_build():
    cfg = two_bottlenecks()
    params = traffic.weights(cfg, SEED, CPU, torch.float32)
    x = traffic.images(cfg, 3, SEED, traffic.IMAGES, CPU)
    got = reference.forward(cfg, params, x, "float32")
    with torch.no_grad():
        want = nn_forward(params, x.permute(0, 3, 1, 2))
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def prefix(cfg, n):
    """The configuration's first ``n`` layers: their last group's output
    comes out of ``forward_fixed`` before its requantize."""
    return {**cfg, "layers": cfg["layers"][:n]}


def test_the_int8_residual_epilogue_equals_a_hand_computation():
    """The first bottleneck's last conv (layer 5, its residual the
    projection, layer 4): ``acc * mult + b``, plus the projection's codes
    times their step, each operation rounded to fp32, then the ReLU."""
    cfg = two_bottlenecks()
    params = traffic.weights(cfg, SEED, CPU, torch.float32)
    calib = traffic.calib(cfg, SEED, CPU)
    x = traffic.images(cfg, 3, SEED, traffic.IMAGES, CPU)
    qm = reference.calibrate(cfg, params, calib, 127)
    g = qm["groups"][(5,)]
    assert g["in_step"] == qm["groups"][(3,)]["out_step"]
    assert g["res_step"] == qm["groups"][(4,)]["out_step"]

    def codes_of(n, group):
        c = prefix(cfg, n)
        y = reference.forward_fixed(
            c, reference.calibrate(c, params, calib, 127), x, 127)
        return reference.quant(y, qm["groups"][group]["out_step"], 127)
    mid, proj = codes_of(4, (3,)), codes_of(5, (4,))
    acc = F.conv2d(mid.permute(0, 3, 1, 2).double(),
                   g["w_q"].permute(3, 2, 0, 1).double())
    y = acc.permute(0, 2, 3, 1).float() * g["mult"]
    y = y + g["b"]
    y = y + proj.float() * torch.tensor(g["res_step"], dtype=torch.float32)
    want = torch.clamp_min(y, 0.0)
    c6 = prefix(cfg, 6)
    got = reference.forward_fixed(
        c6, reference.calibrate(c6, params, calib, 127), x, 127)
    assert float(want.abs().max()) > 0 and torch.equal(got, want)


def test_the_residual_networks_int4_control_departs_from_int8():
    cfg = two_bottlenecks()
    params = traffic.weights(cfg, 7, CPU, torch.float32)
    calib = traffic.calib(cfg, 7, CPU)
    x = traffic.images(cfg, 4, 7, traffic.IMAGES, CPU)
    r8 = reference.logits(cfg, params, x, "int8", calib=calib)
    r4 = reference.logits(cfg, params, x, "int4", calib=calib)
    assert float((r4 - r8).abs().max() / r8.abs().max()) > 0.05


@pytest.mark.parametrize("mode", ["bfloat16", "int8"])
def test_the_residual_networks_precisions_stay_near_fp32(mode):
    cfg = two_bottlenecks()
    params = traffic.weights(cfg, 9, CPU, torch.float32)
    calib = traffic.calib(cfg, 9, CPU)
    x = traffic.images(cfg, 4, 9, traffic.IMAGES, CPU)
    r32 = reference.logits(cfg, params, x, "float32")
    p = params if mode == "int8" else \
        [q and {k: v.bfloat16() for k, v in q.items()} for q in params]
    r = reference.logits(cfg, p, x, mode, calib=calib)
    assert float((r - r32).abs().max() / r32.abs().max()) < 0.05


def test_a_padded_max_pool_equals_torchs():
    l = {"kind": "pool", "pool": "max", "kernel": 3, "stride": 2, "pad": 1}
    x = torch.randn(2, 9, 9, 4, generator=torch.Generator().manual_seed(3))
    want = F.max_pool2d(x.permute(0, 3, 1, 2), 3, 2, 1).permute(0, 2, 3, 1)
    assert torch.equal(reference.pool(x, l), want)
    codes = torch.clamp(torch.round(x * 40), -127, 127).to(torch.int8)
    assert torch.equal(reference.pool(codes, l),
                       reference.pool(codes.float(), l).to(torch.int8))


def test_an_avg_pool_sums_its_window_in_row_major_order():
    l = {"kind": "pool", "pool": "avg", "kernel": 3, "stride": 2, "pad": 0}
    x = torch.randn(2, 7, 7, 4, generator=torch.Generator().manual_seed(4))
    got = reference.pool(x, l)
    acc = x[:, 0:5:2, 0:5:2]
    for i in range(3):
        for j in range(3):
            if i or j:
                acc = acc + x[:, i:i + 5:2, j:j + 5:2]
    assert torch.equal(got, acc / 9.0)
    with pytest.raises(ValueError, match="avg pool takes no codes"):
        reference.pool(x.to(torch.int8), l)


# ---------------------------------------------------------------------------
# a depthwise chain, and the rules
# ---------------------------------------------------------------------------

def mobilenet_v1():
    """MobileNet-v1 (Howard et al., 2017, Table 1): a 3x3/2 conv, 13
    depthwise 3x3 convs each followed by a pointwise 1x1, a 7x7 avg pool
    and an FC."""
    ls, ch = [conv(32, 3, 2, 1)], 32
    for stride, out in ((1, 64), (2, 128), (1, 128), (2, 256), (1, 256),
                        (2, 512)) + ((1, 512),) * 5 + ((2, 1024),
                                                       (1, 1024)):
        ls += [conv(ch, 3, stride, 1, groups=ch), conv(out, 1)]
        ch = out
    ls += [{"kind": "pool", "pool": "avg", "kernel": 7, "stride": 1},
           {"kind": "fc", "out_ch": 1000, "relu": False}]
    return model("mobilenet_v1", 224, ls)


def test_a_depthwise_chain_shrinks_to_valid_groups():
    full, small = mobilenet_v1(), config.shrink(mobilenet_v1())
    assert config.layer_shapes(full)[-3] == (7, 7, 1024)
    shapes = config.layer_shapes(small)
    assert small["input_hw"] == 193 and shapes[-3] == (7, 7, 64)
    ls = small["layers"]
    dws = [i for i, l in enumerate(ls) if l.get("groups", 1) > 1]
    assert len(dws) == 13
    for i in dws:
        assert ls[i]["groups"] == shapes[i - 1][2] == ls[i]["out_ch"]
    params = traffic.weights(small, 3, CPU, torch.float32)
    assert all(params[i]["w"].shape[2] == 1 for i in dws)
    x = traffic.images(small, 2, 3, traffic.IMAGES, CPU)
    assert torch.isfinite(reference.forward(small, params, x,
                                            "float32")).all()


BROKEN = {
    "input names a later layer": (1, {"input": 2}, "layer 1 .*input 2"),
    "residual on a pool": (1, {"residual": 0}, "layer 1 .*only a conv"),
    "padded avg pool": (1, {"pool": "avg", "pad": 1}, "layer 1 .*no pad"),
    "residual of another shape": (2, {"residual": 0},
                                  "layer 2 .*residual 0's shape"),
    "conv reads an FC": (4, {"input": 3}, "layer 4 .*flat output"),
    "groups that divide no channels": (2, {"groups": 3},
                                       "layer 2 .*groups 3"),
}


@pytest.mark.parametrize("case", list(BROKEN))
def test_a_broken_rule_raises_naming_the_layer(case):
    i, keys, msg = BROKEN[case]
    ls = [conv(8, 3, 1, 1), {"kind": "pool", "kernel": 2, "stride": 2},
          conv(16, 3, 1, 1), {"kind": "fc", "out_ch": 10},
          conv(8, 1, input=2), {"kind": "fc", "out_ch": 10, "relu": False}]
    ls[i] = {**ls[i], **keys}
    with pytest.raises(ValueError, match=msg):
        config.layer_shapes(model("broken", 16, ls))


def test_port_config_names_a_field_the_programs_conv_layer_lacks():
    from repro_torch.core.config import ConvLayer
    cfg = two_bottlenecks()
    fields = {f.name for f in dataclasses.fields(ConvLayer)}
    if {"input", "residual"} <= fields:
        port = program.port_config(cfg)
        assert port.layers[5].residual == 4 and port.layers[4].input == 1
    else:
        with pytest.raises(TypeError, match="cnnbench: the program's "
                           "ConvLayer has no field '(input|residual)'"):
            program.port_config(cfg)
    cfg["layers"][0] = {**cfg["layers"][0], "dilation": 2}
    with pytest.raises(TypeError, match="no field 'dilation'"):
        program.port_config(cfg)
