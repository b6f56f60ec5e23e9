"""Mean length of the decode steps (``tick.step`` spans) that ended inside
the window."""


def read(run):
    steps = [s.t1 - s.t0 for s in run.loop_spans("tick.step") if run.in_window(s.t1)]
    return 1e3 * sum(steps) / len(steps) if steps else None
