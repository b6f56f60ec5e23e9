"""Median, over every request due inside the window, of its first token's
arrival minus its due time; a request refused, failed or without a first
token at the end of the drain is charged the drain's end."""
from kvbench.records import percentile


def read(run):
    reqs = run.due_in_window()
    if not reqs:
        return None
    return percentile([(run.deadline if r.failed or not r.times else r.times[0]) - r.due
                       for r in reqs], 50)
