"""Mean, over the requests due inside the window, of the ``queue.kv`` and
``transfer`` lifecycle phases: from the end of prefill until the request
joins the decode batch (KV pull planned, landed and promoted)."""


def read(run):
    lc = run.lifecycle()
    out = []
    for r in run.due_in_window():
        ph = lc.get(r.rid, {})
        if "transfer" in ph:
            out.append(sum(s.t1 - s.t0 for k in ("queue.kv", "transfer") for s in ph.get(k, ())))
    return 1e3 * sum(out) / len(out) if out else None
