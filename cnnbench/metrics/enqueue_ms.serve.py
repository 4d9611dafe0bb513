"""enqueue_ms.serve: host ms a round to launch the fold and the argmax, up
to the copy back (``enqueue``): the host's time to put a forward on the
card, over the traced window: the program's host spans."""
from cnnbench.spans import per_round_ms


def read(ctx):
    return per_round_ms(ctx, ("enqueue",))
