"""Latency quantiles of an open mix's window, read by the latency metrics
(``metrics/p50_ms.serve.py``, ``metrics/p95_ms.serve.py``)."""
import math


def nearest_rank(sorted_values, q):
    n = len(sorted_values)
    if n == 0:
        return None
    return float(sorted_values[min(n - 1, max(0, math.ceil(q * n) - 1))])


def quantile_ms(ctx, q):
    """The nearest-rank ``q`` quantile, in ms, of every request of the
    window (``ctx["latencies_s"]``, sorted); None where there is none, or
    where a request that never came back reaches the quantile."""
    if "latencies_s" not in ctx:
        return None
    v = nearest_rank(ctx["latencies_s"], q)
    return None if v is None or math.isinf(v) else v * 1e3
