"""Device-side profiling hooks (PyTorch port of
``raytracer_tpu/utils/profiling.py``).

The reference's opt-in `timing` crate covers host phases
(utils/timing.py); this module adds the device side: a torch.profiler
trace of the CPU and (when present) the CUDA activity, written to a
directory as a Chrome/Perfetto trace, plus named regions.

    from raytracer_tpu_torch.utils.profiling import trace, annotate
    with trace("build/rtx-trace") as prof:
        with annotate("render-frame"):
            rt.trace_frame_additive()
    print(prof.key_averages().table(row_limit=10))
"""

from __future__ import annotations

import os
from contextlib import contextmanager

import torch


@contextmanager
def trace(log_dir: str):
    """Profile the block and write its trace to
    ``log_dir/trace.json`` (open with Perfetto or chrome://tracing);
    yields the `torch.profiler.profile` object for `key_averages()`."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def annotate(name: str):
    """Named region that shows up on the trace timeline."""
    return torch.profiler.record_function(name)
