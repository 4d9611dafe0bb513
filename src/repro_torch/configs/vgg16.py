"""VGG-16 — the paper's second evaluation model [arXiv:1409.1556].

224x224 input, 13 conv + 3 FC layers; every 2x2/2 max pool fuses into
the conv before it.
"""
from repro_torch.core.config import CNNConfig, ConvLayer


def _block(n, ch):
    return tuple(ConvLayer("conv", out_ch=ch, kernel=3, stride=1, pad=1)
                 for _ in range(n)) + (ConvLayer("pool", kernel=2, stride=2),)


CONFIG = CNNConfig(
    name="vgg16",
    input_hw=224,
    input_ch=3,
    n_classes=1000,
    use_lrn=False,
    layers=(
        *_block(2, 64),
        *_block(2, 128),
        *_block(3, 256),
        *_block(3, 512),
        *_block(3, 512),
        ConvLayer("fc", out_ch=4096),
        ConvLayer("fc", out_ch=4096),
        ConvLayer("fc", out_ch=1000, relu=False),
    ),
)
