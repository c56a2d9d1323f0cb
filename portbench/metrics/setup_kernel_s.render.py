"""Host seconds of loading the CUDA kernels (the span `rtx.kernel_load`:
binding each library, and nvcc where the checkout has not built it)
over the whole run."""

from portbench.program_spans import span_seconds


def read(run):
    return span_seconds(run, "rtx.kernel_load")
