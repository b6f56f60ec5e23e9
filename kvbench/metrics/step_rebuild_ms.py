"""The decode batch rebuilt on a join, a leave or an exhausted page margin
(``step.rebuild``), amortised over the decode steps that ended inside the
window."""
from kvbench.spans import step_part_ms


def read(run):
    return step_part_ms(run, "step.rebuild")
