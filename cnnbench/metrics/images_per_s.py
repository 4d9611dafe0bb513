"""images_per_s: images classified in the window over the window's wall
time, which ends in a synchronize (host clock)."""


def read(ctx):
    if "images" not in ctx or ctx["window_s"] <= 0:
        return None
    return ctx["images"] / ctx["window_s"]
