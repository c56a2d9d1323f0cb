"""Device idle time per render, over the traced window, while the
innermost `rtx.*` span open on the host is `rtx.readback` (the film
getters' copy to the host): the window's idle gaps split instant by
instant over the program's spans (portbench/program_spans.py)."""

from portbench.program_spans import idle_split


def read(run):
    split = idle_split(run.profile)
    return None if split is None else split["readback"] * 1e3 / run.units
