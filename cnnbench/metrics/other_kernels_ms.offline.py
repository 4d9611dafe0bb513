"""other_kernels_ms.offline: device time a forward outside the port's three
kernels (conv_pipe, matmul_pipe, lrn_pwl): the int8 glue (the input's
quantize, the LRN's dequantize and requantize) and the standalone pools,
in ms, from the trace."""


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or not ctx.get("forwards"):
        return None
    t = tr.by_class().get("other", 0.0)
    return t / ctx["forwards"] * 1e3 if t > 0 else None
