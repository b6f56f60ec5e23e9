"""Tokens that reached their handles inside the window (first tokens
included), over the window's length."""


def read(run):
    n = sum(1 for r in run.requests for t in r.times if run.in_window(t))
    return n / run.window_s if n else None
