"""The transfer engine pumped inside a decode step (``step.pump``: pull
transactions executed and pulls promoted), per decode step that ended
inside the window."""
from kvbench.spans import step_part_ms


def read(run):
    return step_part_ms(run, "step.pump")
