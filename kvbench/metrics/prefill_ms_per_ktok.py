"""The ``prefill`` lifecycle phases of the requests due inside the window
(model prefill, the KV landed in the slab, its digests), summed, per
thousand prompt tokens."""


def read(run):
    lc = run.lifecycle()
    secs = toks = 0
    for r in run.due_in_window():
        spans = lc.get(r.rid, {}).get("prefill")
        if spans:
            secs += sum(s.t1 - s.t0 for s in spans)
            toks += r.prompt_len
    return 1e3 * secs / (toks / 1e3) if toks else None
