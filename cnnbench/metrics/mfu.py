"""mfu: the operations of the window's forwards (the benchmark's own count,
counts.forward_ops) over the window's wall time, as a share of the card's
published dense peak in the run precision, in %."""


def read(ctx):
    if "forwards" not in ctx or ctx["window_s"] <= 0:
        return None
    return 100.0 * ctx["forward_ops"] * ctx["forwards"] / ctx["window_s"] \
        / ctx["peak_ops"]
