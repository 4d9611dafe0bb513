"""h2d_ms.serve: host ms a round of the super-batch's copy to the card
(``h2d``: torch.from_numpy(packed).to(device), a pageable copy), over the
traced window: the program's host spans."""
from cnnbench.spans import per_round_ms


def read(ctx):
    return per_round_ms(ctx, ("h2d",))
