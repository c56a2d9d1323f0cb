"""Device time of every device operation other than the two fused BVH
kernels (the wavefront glue's sorts, gathers and unsort, ray generation,
the draws, the film and its readback) per render, over the traced
window."""

FUSED = r"\b(spawn_kernel|shadow_shade_kernel)\b"


def read(run):
    p = run.profile
    total = sum(s for s, _ in p.by_name.values())
    if total <= 0:
        return None
    return (total - p.device_s(FUSED)) * 1e3 / run.units
