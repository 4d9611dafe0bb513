"""pack_ms.serve: host ms a round that the serving engine spends taking the
round's requests from the router (``drain``: the micro-batch's np.zeros,
np.concatenate and np.stack) and packing the round's super-batch (``pack``:
another np.stack), over the traced window: the program's host spans."""
from cnnbench.spans import per_round_ms


def read(ctx):
    return per_round_ms(ctx, ("drain", "pack"))
