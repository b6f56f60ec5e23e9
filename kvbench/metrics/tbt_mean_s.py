"""Mean of every gap between consecutive tokens of a request that ends
inside the window, across all requests, the first gap (the KV handoff)
included: a stall after the first token counts in full, where a median
of the gaps does not see it."""


def read(run):
    gaps = [b - a for r in run.requests for a, b in zip(r.times, r.times[1:])
            if run.in_window(b)]
    return sum(gaps) / len(gaps) if gaps else None
