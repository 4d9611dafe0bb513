"""fill.serve: requests served over rounds times the batch, in %: how full
the gang rounds of the window ran (the engine's report counters)."""


def read(ctx):
    if not ctx.get("rounds"):
        return None
    return 100.0 * ctx["served"] / (ctx["rounds"] * ctx["batch"])
