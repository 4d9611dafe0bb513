"""matmul_pipe_roofline: the matmul_pipe kernels' share of their roofline over the
traced window, in %: for each fc group the larger of its operations over
the run precision's peak and its bytes (each input read once, each output
written once) over 3.35 TB/s, times the window's forwards, over the matmul_pipe
kernels' device time in the trace."""
from cnnbench.devtrace import roofline


def read(ctx):
    return roofline(ctx, "matmul_pipe", "fc")
