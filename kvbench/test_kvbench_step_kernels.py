"""``step_kernels``: the device kernels a decode step launches, read from a
traced run's device events and the program's step spans, against counts
made by hand on runs built here; silent where there is no device trace or
no step to read."""
from __future__ import annotations

from types import SimpleNamespace

import pytest

from kvbench.bench import metric_reader
from kvbench.records import Profile, Run

W = ("worker", "d0")


def span(name, t0, t1, track=W):
    return SimpleNamespace(name=name, track=track, t0=t0, t1=t1, attrs={})


def step(t0, launch, sync, *, pump=0.0, track=W):
    """A ``tick.step`` from ``t0``: a pump, the launch, the sync, 1 ms of its own."""
    kids, t = [], t0
    for name, d in (("step.pump", pump), ("step.launch", launch), ("step.sync", sync)):
        if d:
            kids.append(span(name, t, t + d, track))
            t += d
    return [span("tick.step", t0, t + 0.001, track), *kids]


def kernels(*starts, name="gemm"):
    return [(name, a, a + 0.0001) for a in starts]


def run_of(spans, device, t0=12.0, t1=20.0):
    profile = None if device is None else Profile(t0, t1, device, {}, busy_s=0.1)
    return Run("t", 10.0, 20.0, 40.0, 3.0, [], {}, list(spans), profile)


def read(run):
    return metric_reader("step_kernels").read(run)


def test_counts_the_kernels_between_a_steps_launch_and_its_sync():
    # step A: pump 13.000-13.010, launch 13.010-13.050, sync 13.050-13.060
    # step B: launch 15.000-15.020, sync 15.020-15.100
    spans = step(13.0, 0.04, 0.01, pump=0.01) + step(15.0, 0.02, 0.08)
    device = (kernels(13.001, 13.005)                 # in A's pump, before its launch
              + kernels(13.010, 13.02, 13.03, 13.049, 13.0599)   # A: 5
              + kernels(13.02, name="Memcpy HtoD (Pageable -> Device)")
              + kernels(13.03, name="Memset (Device)")
              + kernels(13.0605, 14.0)                # after A's sync
              + kernels(15.001, 15.05, 15.0999)       # B: 3
              + kernels(15.2))
    assert read(run_of(spans, device)) == pytest.approx((5 + 3) / 2)


def test_only_steps_inside_the_slice_and_on_their_own_track():
    inside = step(13.0, 0.04, 0.01)
    cut = step(11.99, 0.04, 0.01)                     # starts before the slice
    late = step(19.99, 0.02, 0.01)                    # ends after it
    other = [span("step.launch", 13.0, 13.05, ("worker", "p0"))]   # no step on its track
    device = kernels(12.0, 12.01, 13.01, 13.02, 19.995, 19.999)
    assert read(run_of(inside + cut + late + other, device)) == 2


def test_a_step_without_a_launch_counts_nothing():
    """A step that ran no forward (no resident request) is not a decode step."""
    spans = step(13.0, 0.04, 0.01) + [span("tick.step", 14.0, 14.002)]
    device = kernels(13.01, 14.001)
    assert read(run_of(spans, device)) == 1


@pytest.mark.parametrize("case", ["no profile", "no device events", "no step", "no step parts"])
def test_reads_nothing_without_a_trace_or_a_step(case):
    spans = step(13.0, 0.04, 0.01)
    device = kernels(13.01)
    if case == "no profile":
        run = run_of(spans, None)
    elif case == "no device events":
        run = run_of(spans, [])
    elif case == "no step":
        run = run_of([], device)
    else:   # what a program without the step spans records
        run = run_of([span("tick.step", 13.0, 13.1)], device)
    assert read(run) is None
