"""round_ms.serve: the serving engine's measured round time (its clock: the
copy of a round's batch to the card, the forward, the copy of the classes
back), summed over the window's serve calls, over their rounds, in ms."""


def read(ctx):
    if not ctx.get("rounds"):
        return None
    return ctx["round_s"] / ctx["rounds"] * 1e3
