"""The window's arithmetic: a rate over all the work and all the time of the
window, and percentiles over every query in it."""
from __future__ import annotations

import math


def percentile(values, q: float) -> float:
    """The ``q``-th percentile (0-100) by linear interpolation between the
    closest ranks (numpy's default).  An infinite value (a query that
    failed) sorts last, so it shows in the tail."""
    xs = sorted(values)
    if not xs:
        raise ValueError("percentile of no values")
    pos = (len(xs) - 1) * q / 100.0
    lo = math.floor(pos)
    hi = min(lo + 1, len(xs) - 1)
    if xs[hi] == math.inf:
        return math.inf if pos > lo or xs[lo] == math.inf else xs[lo]
    return xs[lo] + (xs[hi] - xs[lo]) * (pos - lo)


def window_metrics(latencies_s, rows: int, window_s: float) -> dict:
    """``latencies_s``: each query's seconds (inf for one that failed);
    ``rows``: the fact rows of all the queries answered correctly;
    ``window_s``: from the first query's start to the last one's end."""
    if window_s <= 0:
        raise ValueError("empty window")
    return {
        "rows_per_s": rows / window_s,
        "query_ms_p50": percentile(latencies_s, 50) * 1e3,
        "query_ms_p95": percentile(latencies_s, 95) * 1e3,
    }
