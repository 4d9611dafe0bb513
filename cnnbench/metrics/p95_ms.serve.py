"""p95_ms.serve: the nearest-rank 95th percentile, in ms, of every request
of the window, each timed on the host clock from its due time to the
return of the serve call that answered it; a request that never came back
counts as missing the percentile (infinite). Per-layer: the serving loop's
tail follows the speed of the card's shared host, and its runs spread by
up to 20 % on some machines, more than an end-to-end bound may allow
(PERF.md section 2)."""
from cnnbench.latency import quantile_ms


def read(ctx):
    return quantile_ms(ctx, 0.95)
