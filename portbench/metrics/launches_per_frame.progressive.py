"""Device operations (kernels, copies, sets) launched per frame, from the
traced window's profile."""


def read(run):
    n = run.profile.device_ops
    return n / run.units if n else None
