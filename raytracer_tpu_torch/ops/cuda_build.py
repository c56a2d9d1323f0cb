"""Build and bind the port's hand-written CUDA kernels.

Each source ``csrc/<name>.cu`` has a plain C interface and compiles with
nvcc for sm_90a into its own shared library
``build/torch_kernels/lib<name>.so``, loaded through ctypes on first use
(or rebuilt when its source is newer).  `build_all` starts one nvcc per
source at once, so a cold start pays for the slowest file only.
`load_from` builds another version of a source (the same C interface)
beside it, and `use` makes the wrappers launch from that library within
a block, to time two versions in one process.  Built
with ``--fmad=false``: no a*b+c is contracted, so each operation rounds
on its own, as in the plain PyTorch versions beside every kernel.

Also the wrappers' shared checks: operands on one CUDA device and
contiguous, launch errors raised, optional CUDA-event timing, and the
refusal of autograd by the entries that have no gradient.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import itertools
import os
import shutil
import subprocess
import threading

import torch

from raytracer_tpu_torch.utils.profiling import count, span

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_ROOT, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_ROOT), "build", "torch_kernels")
SOURCES = ("cuda_bvh", "cuda_cluster", "cuda_gather")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "--fmad=false"]

_lock = threading.Lock()
_libs = {}
_builds = itertools.count()       # numbers each library `load_from` builds


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _paths(name):
    return (os.path.join(_CSRC, f"{name}.cu"),
            os.path.join(BUILD_DIR, f"lib{name}.so"))


def _nvcc_start(src, out, verbose):
    cmd = [_nvcc(), *NVCC_FLAGS, *(["-Xptxas", "-v"] if verbose else []),
           "-o", out, src]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


@span("rtx.kernel_build")
def build_all(names=SOURCES, verbose: bool = False) -> dict:
    """Compile every named source (unconditionally), one nvcc process
    each, all started together.  Returns {name: compiler output};
    `verbose` adds ptxas register/spill reports.  Raises if any build
    fails.  Each library is written to a per-process file and renamed
    into place, so a concurrent loader never sees half a file."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    count("kernel_builds", len(names))
    procs = {}
    for name in names:
        src, lib = _paths(name)
        tmp = f"{lib}.{os.getpid()}.tmp"
        procs[name] = (_nvcc_start(src, tmp, verbose), tmp, lib)
    reports, failed = {}, []
    for name, (proc, tmp, lib) in procs.items():
        out, _ = proc.communicate()
        reports[name] = out
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc failed ({proc.returncode}):\n{out}")
        else:
            os.replace(tmp, lib)
    if failed:
        raise RuntimeError("\n".join(failed))
    return reports


def load(name, setup):
    """The bound library `name`, built first if missing or older than
    its source; `setup(lib)` sets its argtypes once, at first load."""
    with _lock:
        lib = _libs.get(name)
        if lib is not None:
            return lib
        with span("rtx.kernel_load", name=name):
            src, path = _paths(name)
            if (not os.path.exists(path)
                    or os.path.getmtime(src) > os.path.getmtime(path)):
                build_all((name,))
            lib = ctypes.CDLL(path)
            setup(lib)
            count("kernel_loads")
        _libs[name] = lib
        return lib


def load_from(name, src, setup, verbose: bool = False):
    """Build `src`, another version of ``csrc/<name>.cu`` with the same C
    interface, into its own library beside `name`'s and bind it with
    `setup`; `name`'s own library stays the one the wrappers load.
    Returns (lib, compiler output).  Each call builds its own file, so
    one process can hold several versions of a source."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    out = os.path.join(BUILD_DIR,
                       f"lib{name}_from{next(_builds)}.{os.getpid()}.so")
    with span("rtx.kernel_build", name=name):
        count("kernel_builds")
        proc = _nvcc_start(os.path.abspath(src), out, verbose)
        report, _ = proc.communicate()
    if proc.returncode != 0:
        raise RuntimeError(f"{src}: nvcc failed ({proc.returncode}):\n"
                           f"{report}")
    lib = ctypes.CDLL(out)
    setup(lib)
    return lib, report


@contextlib.contextmanager
def use(name, lib):
    """Within the block, the wrappers of library `name` launch from
    `lib` (e.g. one from `load_from`)."""
    with _lock:
        before = _libs.get(name)
        _libs[name] = lib
    try:
        yield lib
    finally:
        with _lock:
            if before is None:
                _libs.pop(name, None)
            else:
                _libs[name] = before


# ctypes argument types: pointer (and stream), int, long long, float
P, I, L, Fl = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float


def ptr(t):
    return None if t is None else t.data_ptr()


def cuda_stream(dev):
    return torch.cuda.current_stream(dev).cuda_stream


def check_cuda(name, *tensors):
    for t in tensors:
        if t is None:
            continue
        if t.device.type != "cuda":
            raise ValueError(f"{name}: every operand must be on the same "
                             f"CUDA device, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: operands must be contiguous")


def refuse_autograd(name, *tensors, scene=None):
    """Raise a ValueError when grad mode is on and an operand, or a tensor
    of `scene` (a SceneArrays), requires grad.  The entries that call it
    have no gradient at all: the fused BVH kernels (`spawn`,
    `shadow_shade`, so `trace_radiance_fused`) and the winning-record
    paths (`query(emit_shade=True)`, `trace_radiance`'s shade_records),
    whose records are forward-only constants, as in the JAX package.
    Gradients through them would be silently zero.  The closest-hit
    queries of the kernel intersectors are differentiable to the rays
    (`core.intersect.winner_grad`)."""
    if not torch.is_grad_enabled():
        return
    if dataclasses.is_dataclass(scene):
        tensors += tuple(getattr(scene, f.name)
                         for f in dataclasses.fields(scene))
    if any(isinstance(t, torch.Tensor) and t.requires_grad for t in tensors):
        raise ValueError(
            f"{name} has no backward (its kernels and records carry no "
            "gradient); differentiate through trace_radiance without shade "
            "records, over accel=\"bvh\", \"cluster\" or \"brute\", or run "
            "under torch.no_grad()")


def event(wrapper):
    """A recorded CUDA timing event when the wrapper's `events` list is
    set (a caller timing the main path's launches), else None."""
    if wrapper.events is None:
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def raise_on(code, name, invalid=None):
    """Raise on a nonzero CUDA error code of `name`'s entry point;
    `invalid` says what code 1 (cudaErrorInvalidValue) means there."""
    if code != 0:
        why = f": {invalid}" if code == 1 and invalid else ""
        raise RuntimeError(f"{name}: CUDA error {code}{why} "
                           f"({torch.cuda.get_device_name()})")


def counted(wrapper, start, n):
    """Count one launch of `wrapper` (and close its timing event)."""
    wrapper.launches += 1
    if start is not None:
        wrapper.events.append((start, event(wrapper), n))
