"""p50_ms.serve: the nearest-rank median, in ms, of every request of the
window, each timed on the host clock from its due time to the return of
the serve call that answered it; a request that never came back counts as
missing the median (infinite). Like ``p95_ms.serve`` it follows the speed
of the host, which moves from run to run (PERF.md section 2)."""
from cnnbench.latency import quantile_ms


def read(ctx):
    return quantile_ms(ctx, 0.50)
