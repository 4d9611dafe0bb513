"""idle_in_serve.serve: the share of the traced window, in %, in which the
host is inside a serve call (the program's ``serve`` spans) and no
operation runs on the device (the device trace): the part of
idle_share.serve that is the program's own host work, not waiting for
arrivals."""
from cnnbench.spans import idle_inside, serve_intervals, window


def read(ctx):
    spans = window(ctx)
    tr = ctx.get("trace")
    if not spans or tr.t1 <= tr.t0:
        return None
    busy = tr.busy()
    if not busy:
        return None
    return 100.0 * idle_inside(serve_intervals(spans), busy) \
        / (tr.t1 - tr.t0)
