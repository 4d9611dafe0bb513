"""The port's traffic model of the fused cascade (``core/pipeline.py``)
and ``classification_flops`` against the JAX package's, on AlexNet and
VGG-16 at full size and ``smoke()``: every integer equal (no tolerance)."""
import pytest

from repro.configs import get_config as jax_get_config
from repro.core import pipeline as jpipe
from repro.models import cnn as jcnn
from repro_torch.configs import get_config
from repro_torch.core import pipeline
from repro_torch.models import cnn

CFGS = [(arch, smoke) for arch in ("alexnet", "vgg16")
        for smoke in (False, True)]
IDS = [f"{a}{'-smoke' if s else ''}" for a, s in CFGS]


def _cfgs(arch, smoke):
    c, j = get_config(arch), jax_get_config(arch)
    return (c.smoke(), j.smoke()) if smoke else (c, j)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("dtype_bytes", [1, 2, 4])
@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("arch,smoke", CFGS, ids=IDS)
def test_bandwidth_model_equals_jax(arch, smoke, batch, dtype_bytes, fused):
    c, j = _cfgs(arch, smoke)
    got = pipeline.bandwidth_model(c, batch, fused=fused,
                                   dtype_bytes=dtype_bytes)
    want = jpipe.bandwidth_model(j, batch, fused=fused,
                                 dtype_bytes=dtype_bytes)
    assert [(s.name, s.read_bytes, s.write_bytes, s.total) for s in got] \
        == [(s.name, s.read_bytes, s.write_bytes, s.total) for s in want]
    assert all(isinstance(s.read_bytes, int) for s in got)


@pytest.mark.parametrize("dtype_bytes", [1, 2, 4])
@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("arch,smoke", CFGS, ids=IDS)
def test_im2col_traffic_equals_jax(arch, smoke, batch, dtype_bytes):
    c, j = _cfgs(arch, smoke)
    assert pipeline.im2col_gemm_traffic(c, batch, dtype_bytes) == \
        jpipe.im2col_gemm_traffic(j, batch, dtype_bytes)


@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("arch,smoke", CFGS, ids=IDS)
def test_fusion_savings_and_flops_equal_jax(arch, smoke, batch):
    c, j = _cfgs(arch, smoke)
    unf, fus, red = pipeline.fusion_savings(c, batch)
    assert (unf, fus, red) == jpipe.fusion_savings(j, batch)
    assert fus < unf and 0 < red < 1
    assert cnn.classification_flops(c) == jcnn.classification_flops(j)


def test_the_fused_cascade_saves_the_unpooled_round_trip():
    """On VGG-16 a conv+pool group saves the unpooled map written and read
    again, less nothing else: conv1_2+pool at batch 8 in fp32 saves
    2 x 224 x 224 x 64 x 4 x 8 bytes (the pool's read and the conv's
    write), the pooled map being written either way."""
    c = get_config("vgg16")
    fused = pipeline.bandwidth_model(c, 8, fused=True)
    unfused = pipeline.bandwidth_model(c, 8, fused=False)
    assert fused[1].name == "conv+pool"
    conv, pool = unfused[1], unfused[2]
    assert (conv.name, pool.name) == ("conv", "pool")
    assert conv.total + pool.total - fused[1].total == \
        2 * 224 * 224 * 64 * 4 * 8
