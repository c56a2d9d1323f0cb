"""Host seconds of the COLLADA parse (the span `rtx.setup.parse`, textures
included) over the whole run, set-up included."""

from portbench.program_spans import span_seconds


def read(run):
    return span_seconds(run, "rtx.setup.parse")
