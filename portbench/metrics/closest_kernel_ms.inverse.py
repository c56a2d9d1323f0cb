"""Device time of the BVH closest-hit kernel (`closest_kernel`,
ops/cuda_bvh.py `bvh_closest`; not the cluster grid's) per
inverse-rendering step, over the traced window."""


def read(run):
    s = run.profile.device_s(r"(?<![A-Za-z0-9_])closest_kernel\b")
    return s * 1e3 / run.units if s > 0 else None
