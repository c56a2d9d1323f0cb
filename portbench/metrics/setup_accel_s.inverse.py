"""Host seconds of the accelerator builds (the span `rtx.setup.accel`: the
host BVH build, its packing and upload; the target's and the start's)
over the whole run."""

from portbench.program_spans import span_seconds


def read(run):
    return span_seconds(run, "rtx.setup.accel")
