"""conv_pipe_roofline: the conv_pipe kernels' share of their roofline over the
traced window, in %: for each conv group the larger of its operations over
the run precision's peak and its bytes (each input read once, each output
written once) over 3.35 TB/s, times the window's forwards, over the conv_pipe
kernels' device time in the trace."""
from cnnbench.devtrace import roofline


def read(ctx):
    return roofline(ctx, "conv_pipe", "conv")
