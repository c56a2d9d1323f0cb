"""A row gather whose backward is a hand-written CUDA kernel: the
gathers of the differentiable shading (core/shade.py) under autograd.

`gather_rows(table, idx)` is `table[idx]` along dim 0, the same values
bit for bit.  Its backward adds each gradient row into the table's row:
out[idx[i]] += grad[i], the table seen as (N, C) rows (C = 9 for the
triangles' vertices, 3 for the diffuse colours and the texels).
PyTorch's own backward of `table[idx]` sorts the indices and sums each
row's duplicates in one thread, which leaves the card waiting on the few
hot rows of a small table (``csrc/cuda_gather.cu``: why, what bounds the
kernel, and its design).

Three tiers, as beside every kernel of the port:
- the plain version, `rows_backward_plain`: a zeroed table and
  `index_add_`, for CPU tensors only;
- the kernel, `rows_backward`: for CUDA tensors it launches
  ``indexing_backward_rows``, or raises; it never falls back to a
  library scatter.  Each launch counts `gather_rows.launches`
  (utils/profiling.py) and runs in the span `rtx.gather_backward`;
- the tests (tests/test_torch_gather.py).
The library is built with nvcc for sm_90a and loaded through ctypes at
the first backward on a card (ops/cuda_build.py); a render under no
grad never loads it.
"""

from __future__ import annotations

import math

import torch
from torch.autograd.function import once_differentiable

from raytracer_tpu_torch.ops import cuda_build
from raytracer_tpu_torch.ops.cuda_build import (I, L, P, check_cuda,
                                                cuda_stream, ptr, raise_on)
from raytracer_tpu_torch.utils.profiling import count, span


def _setup(lib):
    lib.rtx_gather_backward.restype = I
    lib.rtx_gather_backward.argtypes = [P, P, L, I, I, P, P]


def _load():
    """The bound library (csrc/cuda_gather.cu), built first if missing
    or older than its source."""
    return cuda_build.load("cuda_gather", _setup)


def sum_depth(k, m: int):
    """The most additions that each row's sum passes through in the
    kernel, for k (N,) entries a row among m: the warp's tree (at most 5
    rounds), then the leaders' adds into the output, one a warp at most
    and no more than the row's entries.  A float32 sum this deep errs by
    at most depth x 2^-24 x the sum of |values| (Higham), whatever the
    order."""
    return 5 + k.clamp(max=-(-m // 32))


def rows_backward_plain(grad, idx, n: int):
    """Plain PyTorch version: the (n, C) sum of grad's (M, C) rows by
    idx (M,) (CPU tensors)."""
    return torch.zeros((n, grad.shape[1]), dtype=grad.dtype).index_add_(
        0, idx, grad)


def rows_backward(grad, idx, n: int):
    """The (n, C) float32 sum of grad's (M, C) float32 rows by idx (M,)
    int64, each in [0, n).  The plain version for CPU tensors; for CUDA
    tensors the kernel, or a ValueError for an operand it does not take
    (another dtype, another device, not contiguous)."""
    if grad.dim() != 2 or idx.shape != (grad.shape[0],):
        raise ValueError(f"gather_rows backward: grad {tuple(grad.shape)}, "
                         f"idx {tuple(idx.shape)}")
    if grad.device.type == "cpu":
        return rows_backward_plain(grad, idx, n)
    check_cuda("gather_rows backward", grad, idx)
    if grad.dtype != torch.float32 or idx.dtype != torch.int64:
        raise ValueError(f"gather_rows backward: the kernel takes float32 "
                         f"rows and int64 indices, got {grad.dtype} and "
                         f"{idx.dtype}")
    if idx.device != grad.device:
        raise ValueError("gather_rows backward: grad and idx on "
                         f"{grad.device} and {idx.device}")
    m, c = grad.shape
    out = torch.zeros((n, c), dtype=torch.float32, device=grad.device)
    with span("rtx.gather_backward", rows=m):
        code = _load().rtx_gather_backward(
            ptr(grad), ptr(idx), m, n, c, ptr(out), cuda_stream(grad.device))
        raise_on(code, "gather_rows backward",
                 f"a shape the kernel does not take: ({n}, {c}) rows")
        count("gather_rows.launches")
    return out


class _GatherRows(torch.autograd.Function):

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.table_shape = table.shape
        return table[idx]

    @staticmethod
    @once_differentiable
    def backward(ctx, grad):
        idx, = ctx.saved_tensors
        shape = ctx.table_shape
        # autograd may hand a strided gradient; the kernel takes rows
        rows = grad.reshape(grad.shape[0], math.prod(shape[1:])).contiguous()
        return rows_backward(rows, idx, shape[0]).reshape(shape), None


def gather_rows(table, idx):
    """`table[idx]` for a 1-D int64 `idx` of rows in [0, len(table)),
    whose backward is `rows_backward` (the hand-written kernel on a
    card)."""
    return _GatherRows.apply(table, idx)
