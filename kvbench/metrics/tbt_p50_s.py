"""Median of every gap between consecutive tokens of a request that ends
inside the window, across all requests, the first gap included."""
from kvbench.records import percentile


def read(run):
    gaps = [b - a for r in run.requests for a, b in zip(r.times, r.times[1:])
            if run.in_window(b)]
    return percentile(gaps, 50) if gaps else None
