"""p95_ms: the nearest-rank 95th percentile, in ms, of every request of the
window, each timed on the host clock from its due time to the return of
the serve call that answered it; a request that never came back counts as
missing the percentile (infinite)."""
import math


def nearest_rank(sorted_values, q):
    n = len(sorted_values)
    if n == 0:
        return None
    return float(sorted_values[min(n - 1, max(0, math.ceil(q * n) - 1))])


def read(ctx):
    if "latencies_s" not in ctx:
        return None
    v = nearest_rank(ctx["latencies_s"], 0.95)
    return None if v is None or math.isinf(v) else v * 1e3
