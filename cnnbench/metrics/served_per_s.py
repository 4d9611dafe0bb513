"""served_per_s: requests answered in the window over the window's wall
time, which ends when every request due within it has come back (host
clock). Below the program's capacity it is the offered rate; a program
that falls behind lengthens the window and lowers it, and a request that
never comes back is not counted."""
import numpy as np


def read(ctx):
    if "latencies_s" not in ctx or ctx["window_s"] <= 0:
        return None
    return float(np.isfinite(ctx["latencies_s"]).sum()) / ctx["window_s"]
