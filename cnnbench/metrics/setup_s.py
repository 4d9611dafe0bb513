"""setup_s: seconds from the process's start to the window's (host clock):
the kernels' build or load, the weights, compile_cnn with its calibration,
the inputs, and one pass over each shape the window uses."""


def read(ctx):
    return ctx["setup_s"]
