"""Share of the profiled slice in which the device was idle while the host
was issuing a decode step (``step.launch``), in percent."""
from kvbench.profiling import idle_gaps
from kvbench.spans import overlap_s


def read(run):
    p = run.profile
    launches = [(s.t0, s.t1) for s in run.loop_spans("step.launch")]
    if p is None or not p.device or not launches:
        return None
    return 100.0 * overlap_s(idle_gaps(p.device, p.t0, p.t1), launches) / (p.t1 - p.t0)
