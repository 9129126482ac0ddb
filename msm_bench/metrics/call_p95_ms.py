"""The 95th percentile of the traced window's call latencies (host clock,
from the call to its results in hand), ms."""

import statistics


def read(r):
    if len(r.call_ms) < 2:
        return None
    return statistics.quantiles(r.call_ms, n=20, method="inclusive")[18]
