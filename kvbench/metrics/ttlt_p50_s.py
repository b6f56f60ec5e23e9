"""Median, over every request due inside the window, of its last token's
arrival minus its due time; a request not done at the end of the drain is
charged the drain's end."""
from kvbench.records import percentile


def read(run):
    reqs = run.due_in_window()
    if not reqs:
        return None
    return percentile([(r.times[-1] if r.done else run.deadline) - r.due for r in reqs], 50)
