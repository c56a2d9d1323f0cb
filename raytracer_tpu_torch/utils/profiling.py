"""The program's spans and counters, and a torch.profiler trace
(PyTorch port of ``raytracer_tpu/utils/profiling.py``).

A span marks one region of the program at a layer boundary
(`rtx.render`, `rtx.level`, `rtx.bvh_spawn`, `rtx.setup.parse`, ...).
Every span, always, adds its host seconds (`time.perf_counter`) to one
per-name aggregate (`SPANS`, a `utils.timing.BenchMark`: calls, total
and first call's seconds; read with `spans()`).  While a torch profiler
records, the span also opens a `torch.profiler.record_function` of its
name, so it sits on the profiler's clock beside the device operations
it launched.  With no profiler recording it does no profiler work,
records no CUDA event, never synchronises and allocates nothing on the
device.

A counter (`count(name, n)`) is a plain integer add, always on:
`kernel_builds` (nvcc runs), `kernel_loads` (libraries bound),
`row_block_builds` (`RayTracer._row_block` cache misses),
`readback_bytes` (device-to-host copies of the film's getters) and
`gather_rows.launches` (launches of the gather backward's kernel,
ops/cuda_gather.py).
`counters()` lists them with the kernel wrappers' own launch counts.

    from raytracer_tpu_torch.utils.profiling import span, trace
    with trace("build/rtx-trace") as prof:
        with span("render-frame"):
            rt.trace_frame_additive()
    print(prof.key_averages().table(row_limit=10))
"""

from __future__ import annotations

import functools
import os
import threading
import time
from contextlib import contextmanager

import torch

from raytracer_tpu_torch.utils.timing import BenchMark

SPANS = BenchMark()
_counts = dict.fromkeys(("kernel_builds", "kernel_loads",
                         "row_block_builds", "readback_bytes",
                         "gather_rows.launches"), 0)
_counts_lock = threading.Lock()
_recording = torch._C._autograd._profiler_enabled


class span:
    """A named region of the program: a context manager, or a decorator
    that runs each call of the function in a span of its own.  `args`
    (e.g. rays=n) go into the profiler's record only."""

    __slots__ = ("name", "args", "_t0", "_record")

    def __init__(self, name: str, /, **args):
        self.name, self.args = name, args

    def __enter__(self):
        self._record = None
        if _recording():
            self._record = torch.profiler.record_function(
                self.name, ", ".join(f"{k}={v}" for k, v in
                                     self.args.items()) or None)
            self._record.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        SPANS.add(self.name, time.perf_counter() - self._t0)
        if self._record is not None:
            self._record.__exit__(*exc)
        return False

    def __call__(self, fn):
        name, args = self.name, self.args

        @functools.wraps(fn)
        def spanned(*a, **k):
            with span(name, **args):
                return fn(*a, **k)
        return spanned


def spans() -> dict:
    """{name: {"calls", "total_s", "first_s"}} of every span so far in
    this process."""
    return SPANS.snapshot()


def count(name: str, n: int = 1):
    """Add `n` to the counter `name`."""
    with _counts_lock:
        _counts[name] = _counts.get(name, 0) + n


def counters() -> dict:
    """Every counter, and the launch count of each kernel wrapper
    (`launches.<wrapper>`, the wrappers' own `.launches`)."""
    from raytracer_tpu_torch.ops import cuda_bvh, cuda_cluster
    with _counts_lock:
        out = dict(_counts)
    for w in (cuda_bvh.bvh_spawn, cuda_bvh.bvh_shadow_shade,
              cuda_bvh.bvh_closest, cuda_cluster.cluster_closest):
        out[f"launches.{w.__name__}"] = w.launches
    return out


@contextmanager
def trace(log_dir: str):
    """Profile the block and write its trace to
    ``log_dir/trace.json`` (open with Perfetto or chrome://tracing);
    yields the `torch.profiler.profile` object for `key_averages()`.
    The program's spans appear in it by name."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
