"""Device time of the fused BVH kernels (`spawn_kernel` and
`shadow_shade_kernel`, ops/cuda_bvh.py) per render on rank 0, over the
traced window: its row-major slice of the frame, set against a quarter of
`fused_kernel_ms.render`'s tiled whole frame."""

FUSED = r"\b(spawn_kernel|shadow_shade_kernel)\b"


def read(run):
    s = run.profile.device_s(FUSED)
    return s * 1e3 / run.units if s > 0 else None
