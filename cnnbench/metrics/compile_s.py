"""compile_s: host seconds of compile_cnn, calibration included."""


def read(ctx):
    return ctx.get("compile_s")
