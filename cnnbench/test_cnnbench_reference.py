"""The reference against the port's plain CPU path, and the generator.

On CPU tensors the port's kernels run their plain versions, so the
reference must agree with ``compile_cnn(...).forward`` bit for bit in
every mode at the small size: the same weights, images and calibration
batch on both sides, the reference working the int8 steps and codes out
again."""
import numpy as np
import pytest
import torch

from cnnbench import config, program, reference, traffic

BENCH = config.load_benchmark()
CPU = torch.device("cpu")


def small(name):
    return config.shrink(config.read_json(config.config_file(BENCH, name)))


@pytest.mark.parametrize("mode", ["float32", "bfloat16", "int8"])
@pytest.mark.parametrize("name", ["vgg16_bf16", "alexnet_int8"])
def test_reference_equals_the_ports_plain_path(name, mode):
    cfg = small(name)
    quant = mode == "int8"
    cfg = {**cfg, "precision": {"dtype": "float32" if quant else mode,
                                "quant": "int8" if quant else "none",
                                "calib_images": 8}}
    dt = torch.bfloat16 if mode == "bfloat16" else torch.float32
    params = traffic.weights(cfg, 12345, CPU, dt)
    assert all(float(p["b"].abs().max()) > 0 for p in params if p)
    calib = traffic.calib(cfg, 12345, CPU) if quant else None
    x = traffic.images(cfg, 6, 12345, traffic.IMAGES, CPU)
    compiled, _ = program.compile_model(cfg, params, 6, CPU, calib=calib)
    got = compiled.forward(x).float()
    want = reference.logits(cfg, params, x, mode, calib=calib, block=4)
    assert torch.equal(got, want)


def test_fixed_point_control_departs_from_int8():
    cfg = small("alexnet_int8")
    params = traffic.weights(cfg, 7, CPU, torch.float32)
    calib = traffic.calib(cfg, 7, CPU)
    x = traffic.images(cfg, 4, 7, traffic.IMAGES, CPU)
    r8 = reference.logits(cfg, params, x, "int8", calib=calib)
    r4 = reference.logits(cfg, params, x, "int4", calib=calib)
    assert float((r4 - r8).abs().max() / r8.abs().max()) > 0.05


def test_pwl_lrn_is_within_half_a_percent_of_the_exact_one():
    p = config.read_json(config.config_file(BENCH, "alexnet_int8"))["lrn"]
    x = torch.randn(2, 5, 5, 96, generator=torch.Generator().manual_seed(0)) \
        * 30
    ex, pw = reference.lrn_exact(x, p), reference.lrn_pwl(x, p)
    assert float(((pw - ex).abs() / ex.abs().clamp_min(1e-6)).max()) < 5e-3


def test_top1_gap_reads_zero_for_the_best_and_inf_for_no_answer():
    ref = torch.tensor([[0.0, 2.0, 1.0], [3.0, 0.0, 0.0]])
    gap = reference.top1_gap(ref, torch.tensor([1, -1]))
    assert float(gap[0]) == 0.0 and gap[1].item() == float("inf")
    assert float(reference.top1_gap(ref, torch.tensor([2, 0]))[0]) == \
        pytest.approx(1.0 / float(ref[0].std()))


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 5, 2 ** 40 + 3])
def test_every_seed_offers_the_same_gaps_in_another_order(seed):
    mix = {"rate_per_s": 500.0, "pool": 256}
    a = traffic.arrivals(mix, seed, 4.0)
    b = traffic.arrivals(mix, seed + 1, 4.0)
    assert np.array_equal(a, traffic.arrivals(mix, seed, 4.0))
    ga, gb = np.sort(np.diff(a, prepend=0.0)), np.sort(np.diff(b, prepend=0))
    n = min(len(ga), len(gb))
    assert abs(len(a) - len(b)) <= 2 and len(a) > 1900
    assert np.allclose(ga[:n - 3], gb[:n - 3], rtol=1e-9, atol=1e-12)
    assert not np.array_equal(a, b)
    assert np.all(np.diff(a) >= 0) and a[-1] < 4.0


def test_weights_and_images_repeat_for_a_seed():
    cfg = small("vgg16_bf16")
    a = traffic.weights(cfg, 99, CPU, torch.bfloat16)
    b = traffic.weights(cfg, 99, CPU, torch.bfloat16)
    c = traffic.weights(cfg, 100, CPU, torch.bfloat16)
    assert all(torch.equal(p["w"], q["w"]) and torch.equal(p["b"], q["b"])
               for p, q in zip(a, b) if p)
    assert not torch.equal(a[0]["w"], c[0]["w"])
    assert a[0]["w"].dtype == torch.bfloat16
