"""The host waiting for a decode step's tokens (``step.sync``: the step's
``tolist()`` calls), per decode step that ended inside the window."""
from kvbench.spans import step_part_ms


def read(run):
    return step_part_ms(run, "step.sync")
