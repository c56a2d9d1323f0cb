"""Host time in the program's `rtx.all_gather` span (RayTracer.
render_sharded's gather of the film's moments and their fold into the
film) per render on rank 0, over the traced window; None off the card
(the harness's CPU tests read no device run's metric)."""

SPAN = "rtx.all_gather"


def read(run):
    if getattr(getattr(run.session, "device", None), "type", None) != "cuda":
        return None
    s = sum(end - start for name, start, end in run.profile._host
            if name == SPAN)
    return s * 1e-3 / run.units if s > 0 else None
