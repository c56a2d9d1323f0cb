"""Device time of the collectives' kernels (NCCL's, `nccl` in the name)
per render on rank 0, over the traced window: the all-gather of the
film's two moments, and rank 0's wait in it for the slowest rank."""

NCCL = r"(?i)nccl"


def read(run):
    s = run.profile.device_s(NCCL)
    return s * 1e3 / run.units if s > 0 else None
