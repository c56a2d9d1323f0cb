"""Host seconds of the process's first inverse-rendering step (the first
call of the span `rtx.train_step`: set-up's first checked step, Adam's
first step and its imports included)."""

from portbench.program_spans import span_seconds


def read(run):
    return span_seconds(run, "rtx.train_step", "first_s")
