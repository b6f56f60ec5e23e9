"""CPU tests of ``step_graph_pct``, the share of the window's decode steps
whose forward replayed captured CUDA graphs, on runs built here: every
step replayed, some, none, and a program whose ``step.launch`` carries no
``graph`` attribute (the parent's)."""
from __future__ import annotations

import pytest

from kvbench.bench import metric_reader
from kvbench.test_kvbench_tracing import W, request, run_of, span, step


def graph_steps(*modes, after="replay"):
    """One step a second from 11 s, its ``step.launch`` marked with each of
    ``modes`` in turn (None: no ``graph`` attribute), and a step after the
    close marked ``after``."""
    spans = []
    for i, mode in enumerate((*modes, after)):
        st = step(11.0 + i if i < len(modes) else 19.95, 0.05, 0.002)
        if mode is not None:
            st[1].attrs["graph"] = mode
        spans += st
    return run_of(spans)


@pytest.mark.parametrize("modes,want", [
    (("replay", "replay", "replay"), 100.0),
    (("capture", "replay", "eager", "replay"), 50.0),
    (("eager", "eager"), 0.0),
    (("capture", None), 0.0),
])
def test_step_graph_pct_counts_the_replayed_steps_in_the_window(modes, want):
    assert metric_reader("step_graph_pct").read(graph_steps(*modes)) == pytest.approx(want)


def test_step_graph_pct_reads_nothing_without_the_attribute():
    assert metric_reader("step_graph_pct").read(graph_steps(None, None, after=None)) is None
    parent = [span("tick.step", W, 11.0, 11.1, batch=1, tokens=1),
              span("step.launch", W, 11.0, 11.05, batch=1)]
    assert metric_reader("step_graph_pct").read(run_of(parent, [request("r1", 12.0, 70)])) \
        is None
    assert metric_reader("step_graph_pct").read(run_of([])) is None
