"""Device time of PyTorch's index backward (kernels named
`indexing_backward*`: the backward of the gathers by triangle, material
and texel) per inverse-rendering step, over the traced window."""


def read(run):
    s = run.profile.device_s(r"\bindexing_backward")
    return s * 1e3 / run.units if s > 0 else None
