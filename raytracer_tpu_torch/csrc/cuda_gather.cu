// A hand-written CUDA kernel (sm_90a) for the backward of a row gather of
// the PyTorch port (ops/cuda_gather.py `gather_rows`):
//
//   out[idx[i], c] += grad[i, c]   for i < M, c < C, out (N, C) float32
//
// the gradient of `table[idx]` under autograd.  No TPU kernel is
// replaced: on the TPU the gathers of the differentiable shading
// (core/shade.py: the triangles' vertices by hit triangle, the diffuse
// colours by geometry, the texels by flat texel index) are XLA's, and
// their transposes XLA's scatter-adds.  PyTorch's own backward of
// `table[idx]` on CUDA sorts the indices and gives each distinct row to
// one thread (`indexing_backward_kernel_small_stride`), which walks the
// row's duplicates one after another.  The differentiable path's tables
// have few rows and very many duplicates: 5 geometry rows and 608
// triangles for about a million hits a level, most rays on one geometry
// and every missed ray on row 0.  A few threads then walk hundreds of
// thousands of entries each while the card waits.
//
// What bounds it on an H100: the bytes, M x (4 C + 8) read once (the
// gradient rows and an int64 index each), about 0.34 GB over the three
// levels of a 1024² inverse step, 0.1 ms at 3.35 TB/s; and, where many
// rays share a row, the serial atomic adds to that row.
//
// Design: no sort and no row left to one thread.  Each warp takes 32
// consecutive rays; `__match_any_sync` groups the lanes that hold the
// same row, and each group sums its lanes' values in a tree of shuffles
// (at most 5 rounds; the schedule depends on the groups only, so it is
// computed once for all C columns); one leader a group adds the sum to
// the output with a global atomicAdd.  A row that all 32 lanes hold
// costs one atomic a warp, not 32.  Exact zeros are not added (adding +0
// leaves every float as it is but -0, and the zeroed output never holds
// -0): missed rays gather row 0 with a zero gradient, so the hottest row
// of the shading's tables mostly adds nothing.  A block's private copy
// of the table in shared memory gains nothing on the inverse step's
// gradients, whose hot rows are those zeros (PERF.md); it pays only
// where a hot row's values are nonzero.  Float atomics add in an order
// that changes from run to run; a row's sum is at most 5 + (the warps
// that hold the row) additions deep, far shallower than one thread's
// walk over its duplicates.  Built with --fmad=false like every kernel of the port (no
// contraction is possible in a sum, so it changes nothing here).  The
// name starts with `indexing_backward`, PyTorch's prefix for this
// backward, so that a profile reads the index backward of every gather
// under one name.

#include <cuda_runtime.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int MAX_ROUNDS = 5;            // log2(32): a group of 32 lanes
constexpr int THREADS = 512;             // 16 warps a block

struct RowsArgs {
  const float* grad;        // (M, C) row-major
  const long long* idx;     // (M,) in [0, N); other values add nothing
  long long M;
  int N;
  int C;
  float* out;               // (N, C) float32, zeroed by the caller
};

// One warp's 32 rays starting at `base` into the output.  Every lane of
// the warp calls it with the same `base`.
__device__ __forceinline__ void warp_rows(const RowsArgs& a, long long base,
                                          int lane) {
  const long long i = base + lane;
  int row = -1;
  if (i < a.M) {
    const long long r = a.idx[i];
    if (r >= 0 && r < a.N) row = static_cast<int>(r);
  }
  const unsigned peers = __match_any_sync(FULL, row);
  const unsigned below = peers & ((1u << lane) - 1u);
  const bool leader = row >= 0 && below == 0u;
  // The tree: in each round a lane adds the partial of the next peer
  // above it that is still in the tree, and the lanes at odd positions
  // leave it.  src[s] is that peer's lane, -1 where there is none.
  unsigned rest = peers & ~((2u << lane) - 1u);
  int rel = __popc(below);
  int src[MAX_ROUNDS];
  int rounds = 0;
#pragma unroll
  for (int s = 0; s < MAX_ROUNDS; ++s) {
    src[s] = -1;
    if (__any_sync(FULL, rest != 0u)) {
      src[s] = __ffs(rest) - 1;
      rest &= __ballot_sync(FULL, (rel & 1) == 0);
      rel >>= 1;
      rounds = s + 1;
    }
  }
  const float* g = a.grad + i * a.C;
  for (int c = 0; c < a.C; ++c) {
    float x = row >= 0 ? g[c] : 0.0f;
#pragma unroll
    for (int s = 0; s < MAX_ROUNDS; ++s) {
      if (s < rounds) {                       // the same in every lane
        const float t = __shfl_sync(FULL, x, src[s] & 31);
        if (src[s] >= 0) x += t;
      }
    }
    if (leader && x != 0.0f)
      atomicAdd(a.out + static_cast<long long>(row) * a.C + c, x);
  }
}

}  // namespace

// Named at namespace scope, for the profile (see the top of the file).
// One warp for each 32 rays.
__global__ void indexing_backward_rows(RowsArgs a) {
  const long long w = static_cast<long long>(blockIdx.x) * (THREADS / 32) +
                      (threadIdx.x >> 5);
  if (w * 32 < a.M) warp_rows(a, w * 32, threadIdx.x & 31);
}

// out (N, C) must be zeroed.  Returns a CUDA error code (1, invalid
// value, for a shape the kernel does not take).
extern "C" int rtx_gather_backward(const float* grad, const long long* idx,
                                   long long M, int N, int C, float* out,
                                   void* stream) {
  if (N < 0 || C < 1 || M < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (M == 0 || N == 0) return 0;
  const long long blocks = (M + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const RowsArgs a{grad, idx, M, N, C, out};
  indexing_backward_rows<<<static_cast<unsigned>(blocks), THREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
