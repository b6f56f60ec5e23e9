"""Share of the decode steps that ended inside the window whose forward
replayed captured CUDA graphs (``step.launch`` with ``graph`` set to
``"replay"``), in percent.  A program whose ``step.launch`` carries no
``graph`` reads nothing."""
from kvbench.spans import window_steps, within


def read(run):
    steps = window_steps(run)
    launches = [s for s in run.loop_spans("step.launch") if "graph" in s.attrs]
    if not steps or not launches:
        return None
    replayed = within([s for s in launches if s.attrs["graph"] == "replay"], steps)
    return 100.0 * len(replayed) / len(steps)
