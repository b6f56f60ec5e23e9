"""The host issuing the decode step (``step.launch``: the model's forward and
the argmax, enqueued), per decode step that ended inside the window."""
from kvbench.spans import step_part_ms


def read(run):
    return step_part_ms(run, "step.launch")
