"""The prefill's block digests (``prefill.digest``: every parked block copied
to the host and hashed) of the requests due inside the window, summed, per
thousand of their prompt tokens."""
from kvbench.spans import request_spans


def read(run):
    digests = request_spans(run, "prefill.digest")
    secs = toks = 0
    for r in run.due_in_window():
        if r.rid in digests:
            secs += sum(s.t1 - s.t0 for s in digests[r.rid])
            toks += r.prompt_len
    return 1e3 * secs / (toks / 1e3) if toks else None
