"""AlexNet (8 layers) — the paper's primary evaluation model [NIPS'12].

Original two-tower topology (groups=2 on conv2/4/5), 227x227 input, LRN
after conv1 and conv2. conv5 and its 3x3/2 max pool run as one fused
conv_pipe launch.
"""
from repro_torch.core.config import CNNConfig, ConvLayer

CONFIG = CNNConfig(
    name="alexnet",
    input_hw=227,
    input_ch=3,
    n_classes=1000,
    use_lrn=True,
    layers=(
        ConvLayer("conv", out_ch=96, kernel=11, stride=4, pad=0),
        ConvLayer("lrn"),
        ConvLayer("pool", kernel=3, stride=2, pool="max"),
        ConvLayer("conv", out_ch=256, kernel=5, stride=1, pad=2, groups=2),
        ConvLayer("lrn"),
        ConvLayer("pool", kernel=3, stride=2, pool="max"),
        ConvLayer("conv", out_ch=384, kernel=3, stride=1, pad=1),
        ConvLayer("conv", out_ch=384, kernel=3, stride=1, pad=1, groups=2),
        ConvLayer("conv", out_ch=256, kernel=3, stride=1, pad=1, groups=2),
        ConvLayer("pool", kernel=3, stride=2, pool="max"),
        ConvLayer("fc", out_ch=4096),
        ConvLayer("fc", out_ch=4096),
        ConvLayer("fc", out_ch=1000, relu=False),
    ),
)
