"""Mean, over the requests due inside the window, of the wait from the due
time to the start of the request's ``prefill`` lifecycle phase (the
generator's lateness and the dispatch queue together)."""


def read(run):
    lc = run.lifecycle()
    waits = [lc[r.rid]["prefill"][0].t0 - r.due for r in run.due_in_window()
             if "prefill" in lc.get(r.rid, {})]
    return 1e3 * sum(waits) / len(waits) if waits else None
