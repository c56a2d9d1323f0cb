"""Device idle time per render, over the traced window, while the host
is in no `rtx.*` span of the program (the benchmark's loop between
renders): the window's idle gaps split instant by instant over the
program's spans (portbench/program_spans.py)."""

from portbench.program_spans import idle_split


def read(run):
    split = idle_split(run.profile)
    return None if split is None else split["caller"] * 1e3 / run.units
