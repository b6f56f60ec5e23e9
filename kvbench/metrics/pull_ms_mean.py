"""Mean, over the requests due inside the window, of their KV pulls
(``pull`` spans: from the first submit to the last transaction landed)."""
from kvbench.spans import request_spans


def read(run):
    pulls = request_spans(run, "pull")
    out = [sum(s.t1 - s.t0 for s in pulls[r.rid]) for r in run.due_in_window()
           if r.rid in pulls]
    return 1e3 * sum(out) / len(out) if out else None
