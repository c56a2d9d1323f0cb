// Hand-written CUDA kernel (sm_90a) for the flat Morton-cluster grid of
// the PyTorch port (ops/cluster.py: K clusters of C triangle lanes, one
// AABB each).  It replaces the Pallas TPU kernel
//
//   rtx_cluster_closest  <- pallas_cluster_closest
//                           (raytracer_tpu/ops/pallas_intersect.py:312)
//
// the closest hit of accel="cluster" (ClusterIntersector.query/shadow):
// t, u, v and the packed slot of the winning lane for every ray, exact
// below a runtime t limit (a static one on the TPU; shadow queries pass
// the window's 1.0).
//
// What bounds it on an H100: the Moller-Trumbore arithmetic (54 f32
// operations per ray-triangle test, the C lanes of every cluster a ray
// enters before its best t) against the card's f32 instruction rate,
// 33.5 T instructions/s with nothing contracted (see below).  Ray I/O is
// about 40 bytes a ray and the triangle planes (9 x K*C floats, 0.72 MB
// for thai2 at C = 128) stay in L2.  A kernel nears the ceiling only if
// nearly every instruction slot goes to those 54 operations: no
// divergence inside a test, no reloads, no lanes idled by dead rays.
//
// Design: the walk of csrc/cuda_bvh.cu's closest kernel, written for the
// flat grid (cluster_closest_kernel, warp_walk).  A block of B threads
// (128 by default) takes B consecutive rays and packs their live rays to
// the front in order (a stable partition: dead rays idle no lane), one
// ray a thread; a warp with no live ray walks nothing.  Each warp then
// walks its 32 rays on its own, with no block barrier: it takes the
// clusters in one of six precomputed centroid orders, picked from its
// summed live directions by dominant axis and sign (the TPU kernel's rule
// per 128-ray block, pallas_intersect.py:341-345).  Each thread
// slab-tests the cluster's box, read by the whole warp at once, against
// min(its best t, limit).  When one of the warp's rays enters the
// cluster, the warp stages its lanes chunk by chunk (128 lanes, 9 planes,
// 4,608 B) into its own shared-memory buffer with cp.async, and all 32
// threads test them in the same order from float4 broadcasts: the warp
// never diverges inside a test, no thread reloads a lane from L2, and no
// warp waits for a block-mate that needs more clusters (a block-wide
// walk, one barrier per staged chunk, ran slower, as did windows of
// several batches: PERF.md).  Any C that is a multiple of 128 runs.
// Ties go to the first lane of a cluster (strict '<' as lanes run in
// order) and a cluster replaces the best only on a strict '<'
// (pallas_intersect.py:274-286).  The kernel counts, per ray, the tests
// its warp ran (tests_out).
//
// Semantics kept from the TPU kernel that differ from the BVH walk:
// - directions are inverted raw (1/d, pallas_intersect.py:198), so a
//   zero component gives +-inf, and an origin on that box plane gives
//   0 * inf = NaN.  jnp.minimum/maximum propagate NaN and every
//   comparison with it is false, so that cluster is culled for that ray.
//   CUDA's fminf/fmaxf drop a NaN operand instead, so the slab test here
//   uses min_nan/max_nan, which propagate it.  The TPU kernel then still
//   updates every ray of its 128-ray block when another ray of the block
//   enters the cluster, so there the cull bites only when no ray of the
//   block does.  Here it bites per ray: a ray takes a hit from a cluster
//   only where its own gate entered it, though its warp tests the union
//   (mt_chunk's `need`), and the plain version (cluster_closest_plain)
//   culls the same pairs;
// - acceptance is the chain u >= 0, u <= 1, v >= 0, u + v <= 1, t >= 0
//   (pallas_intersect.py:270-271), equal to the BVH kernels' one sign
//   test (tests/test_torch_intersect.py holds the two equal).
// Testing lanes a ray did not need never changes its closest t, so walk
// order changes only the speed, and which triangle wins an exact-t tie
// across clusters.
//
// rtx_cluster_tests_needed keeps the per-ray walk of the first version,
// one thread per ray in its own dominant-direction order, as a counting
// entry that no timed path runs: the clusters each ray enters before its
// best t (x C: the tests the ray needs) are the yardstick of the
// kernel's bound.
//
// Built with --fmad=false (no contraction of a*b+c), so each operation
// rounds on its own, as in the plain PyTorch version in
// ops/cuda_cluster.py.  The entry points launch on the caller's stream,
// allocate nothing and return cudaGetLastError() (0 on success), or
// cudaErrorInvalidValue for a shape the walk does not take
// (walk_takes).  This file shares no header with csrc/cuda_bvh.cu:
// each builds on its own.

#include <cuda_runtime.h>

namespace {

constexpr float kBigT = 3.0e38f;              // core/intersect.py BIG_T
constexpr float kF32Eps = 1.1920929e-07f;     // f32::EPSILON
constexpr float kAliveLimit = 1.0e30f;        // |ox| >= this: dead ray
constexpr float kDeadOrigin = 1.0e35f;

// The walk's shapes (walk_takes refuses any other).
constexpr int kChunk = 128;                   // lanes staged at a time
constexpr int kChunk4 = kChunk / 4;           // float4s per plane chunk
constexpr int kChunkFloats = 9 * kChunk;      // one staged chunk
constexpr int kMaxBlock = 256;                // threads (rays) per block

struct Grid {
  const float* __restrict__ tri;   // (9, ns): v0 xyz, e1 xyz, e2 xyz planes
  const float* __restrict__ aabb;  // (K, 8) [min xyz, max xyz, pad, pad]
  const int* __restrict__ orders;  // (6, K) cluster visit orders
  long long ns;                    // K*C packed slots
  int C, K;
};

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

// jnp.minimum / jnp.maximum: a NaN operand gives NaN.
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// Slab entry distance of a cluster box lo = (min xyz, max x), hi = (max
// yz, pad, pad); BIG_T when the ray misses it, the box lies behind, or a
// NaN arises (pallas_intersect.py:223-234).
__device__ __forceinline__ float slab_entry(float4 lo, float4 hi,
                                            const Ray& r, float ix, float iy,
                                            float iz) {
  const float tx1 = (lo.x - r.ox) * ix, tx2 = (lo.w - r.ox) * ix;
  const float ty1 = (lo.y - r.oy) * iy, ty2 = (hi.x - r.oy) * iy;
  const float tz1 = (lo.z - r.oz) * iz, tz2 = (hi.y - r.oz) * iz;
  const float tmin = max_nan(max_nan(min_nan(tx1, tx2), min_nan(ty1, ty2)),
                             min_nan(tz1, tz2));
  const float tmax = min_nan(min_nan(max_nan(tx1, tx2), max_nan(ty1, ty2)),
                             max_nan(tz1, tz2));
  return (tmax >= tmin && tmax > 0.0f) ? tmin : kBigT;
}

// The same, for a box in global memory.
__device__ __forceinline__ float slab_entry(const float* __restrict__ box,
                                            const Ray& r, float ix, float iy,
                                            float iz) {
  return slab_entry(__ldg(reinterpret_cast<const float4*>(box)),
                    __ldg(reinterpret_cast<const float4*>(box) + 1), r, ix,
                    iy, iz);
}

// Walk order (one of the six precomputed centroid orders) from a
// direction's dominant axis and sign (pallas_intersect.py:341-345).
__device__ __forceinline__ int order_index(float x, float y, float z) {
  const float ax = fabsf(x), ay = fabsf(y), az = fabsf(z);
  int axis = ay > ax ? 1 : 0;
  axis = az > fmaxf(ax, ay) ? 2 : axis;
  const float sgn = axis == 0 ? x : (axis == 1 ? y : z);
  return axis * 2 + (sgn < 0.0f);
}

// Moller-Trumbore of one ray against one triangle
// (pallas_intersect.py:256-286); the hit replaces the best only on a
// strict '<'.  `kUV`: also keep u and v.
template <bool kUV, typename H>
__device__ __forceinline__ void mt_test(float v0x, float v0y, float v0z,
                                        float e1x, float e1y, float e1z,
                                        float e2x, float e2y, float e2z,
                                        int s, const Ray& r, H& h) {
  const float px = r.dy * e2z - r.dz * e2y;
  const float py = r.dz * e2x - r.dx * e2z;
  const float pz = r.dx * e2y - r.dy * e2x;
  const float det = e1x * px + e1y * py + e1z * pz;
  const bool non_par = fabsf(det) >= kF32Eps;
  const float inv_det = 1.0f / (non_par ? det : 1.0f);
  const float tvx = r.ox - v0x, tvy = r.oy - v0y, tvz = r.oz - v0z;
  const float uu = (tvx * px + tvy * py + tvz * pz) * inv_det;
  const float qx = tvy * e1z - tvz * e1y;
  const float qy = tvz * e1x - tvx * e1z;
  const float qz = tvx * e1y - tvy * e1x;
  const float vv = (r.dx * qx + r.dy * qy + r.dz * qz) * inv_det;
  const float tt = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
  const bool ok = non_par && uu >= 0.0f && uu <= 1.0f && vv >= 0.0f &&
                  uu + vv <= 1.0f && tt >= 0.0f;
  if (ok && tt < h.t) {
    h.t = tt;
    if constexpr (kUV) {
      h.u = uu;
      h.v = vv;
    }
    h.slot = s;
  }
}

// Plane-form ray i of (6, R) rays; past the last ray, a dead one.
__device__ __forceinline__ Ray load_ray(const float* __restrict__ rays,
                                        long long R, long long i) {
  if (i >= R) return Ray{kDeadOrigin, kDeadOrigin, kDeadOrigin, 1.0f, 1.0f,
                         1.0f};
  return Ray{rays[i], rays[R + i], rays[2 * R + i], rays[3 * R + i],
             rays[4 * R + i], rays[5 * R + i]};
}

// --- the per-ray walk (needed_kernel: the bound's yardstick) --------------

struct Needed {
  float t;
  int slot;        // packed slot of the winning lane, -1 on a miss
  int clusters;    // clusters entered before the best t (C tests each)
};

// Closest hit below `limit`, one ray in its own order, each lane loaded
// from global memory.
__device__ Needed traverse(const Grid& g, const Ray& r, float limit) {
  Needed h{kBigT, -1, 0};
  const float ix = 1.0f / r.dx, iy = 1.0f / r.dy, iz = 1.0f / r.dz;
  const int* __restrict__ order =
      g.orders + order_index(r.dx, r.dy, r.dz) * g.K;
  const float* __restrict__ T = g.tri;
  const long long ns = g.ns;
  for (int k = 0; k < g.K; ++k) {
    const int kk = __ldg(order + k);
    if (!(slab_entry(g.aabb + 8LL * kk, r, ix, iy, iz) < fminf(h.t, limit)))
      continue;
    ++h.clusters;
    for (int j = 0; j < g.C; ++j) {
      const long long s = static_cast<long long>(kk) * g.C + j;
      mt_test<false>(__ldg(T + s), __ldg(T + ns + s), __ldg(T + 2 * ns + s),
                     __ldg(T + 3 * ns + s), __ldg(T + 4 * ns + s),
                     __ldg(T + 5 * ns + s), __ldg(T + 6 * ns + s),
                     __ldg(T + 7 * ns + s), __ldg(T + 8 * ns + s),
                     static_cast<int>(s), r, h);
    }
  }
  return h;
}

struct NeededArgs {
  Grid grid;
  const float* __restrict__ rays;  // (6, R)
  long long R;
  float limit;
  int* clusters_out;  // (R,) clusters entered before the best t
  float* t_out;       // (R,) BIG_T on a miss
  int* slot_out;      // (R,) packed slot, -1 on a miss
};

__global__ void needed_kernel(NeededArgs a) {
  const long long i =
      blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (i >= a.R) return;
  const Ray r = load_ray(a.rays, a.R, i);
  Needed h{kBigT, -1, 0};
  if (fabsf(r.ox) < kAliveLimit) h = traverse(a.grid, r, a.limit);
  a.clusters_out[i] = h.clusters;
  a.t_out[i] = h.t;
  a.slot_out[i] = h.slot;
}

// --- the warp walk (cluster_closest_kernel) ---------------------------------

struct BlockHit {
  float t, u, v;
  int slot;        // packed slot of the winning lane, -1 on a miss
  int tests;       // ray-triangle tests this thread's warp ran
};

// Dynamic shared memory of a block, in floats: one staged chunk
// (9 x 128 lanes) for each warp.
constexpr int walk_smem_floats(int block) {
  return block / 32 * kChunkFloats;
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// One ray against the 128 lanes of a staged chunk, in lane order.  Every
// thread of the warp reads the same lanes: each float4 read is a
// broadcast of four lanes of one plane.  `need`: the ray's own gate
// entered the cluster before its best t; without it, no lane may win
// (best t at -1 for the chunk), so a ray never takes a hit from a cluster
// that its slab test culled (a NaN entry included).
__device__ __forceinline__ void mt_chunk(const float* buf, int base,
                                         const Ray& r, bool need,
                                         BlockHit& h) {
  const float best = h.t;
  if (!need) h.t = -1.0f;
  const float4* q = reinterpret_cast<const float4*>(buf);
#pragma unroll 1
  for (int j = 0; j < kChunk4; ++j) {
    const float4 a0 = q[j], a1 = q[kChunk4 + j], a2 = q[2 * kChunk4 + j];
    const float4 b0 = q[3 * kChunk4 + j], b1 = q[4 * kChunk4 + j],
                 b2 = q[5 * kChunk4 + j];
    const float4 c0 = q[6 * kChunk4 + j], c1 = q[7 * kChunk4 + j],
                 c2 = q[8 * kChunk4 + j];
    const int s = base + 4 * j;
    mt_test<true>(a0.x, a1.x, a2.x, b0.x, b1.x, b2.x, c0.x, c1.x, c2.x, s,
                  r, h);
    mt_test<true>(a0.y, a1.y, a2.y, b0.y, b1.y, b2.y, c0.y, c1.y, c2.y,
                  s + 1, r, h);
    mt_test<true>(a0.z, a1.z, a2.z, b0.z, b1.z, b2.z, c0.z, c1.z, c2.z,
                  s + 2, r, h);
    mt_test<true>(a0.w, a1.w, a2.w, b0.w, b1.w, b2.w, c0.w, c1.w, c2.w,
                  s + 3, r, h);
  }
  if (!need) h.t = best;
}

// Closest hit of the warp's 32 rays below `limit` (exact below it); every
// thread of the warp calls it, a dead ray where a lane has no live one.
// The warp walks on its own (no block barrier), staging each chunk it
// tests into its own buffer `buf`.  A dead ray gets t = BIG_T, slot -1.
__device__ BlockHit warp_walk(const Grid& g, const Ray& r, bool alive,
                              float limit, float* buf) {
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  // a dead ray's best t stays below every accepted t (>= 0): it never
  // takes a hit, and its entries are BIG_T
  BlockHit h{alive ? kBigT : -1.0f, 0.0f, 0.0f, -1, 0};
  if (__any_sync(full, alive)) {
    // the warp's summed live directions pick its order
    float sx = alive ? r.dx : 0.0f, sy = alive ? r.dy : 0.0f,
          sz = alive ? r.dz : 0.0f;
    for (int o = 16; o > 0; o >>= 1) {
      sx += __shfl_xor_sync(full, sx, o);
      sy += __shfl_xor_sync(full, sy, o);
      sz += __shfl_xor_sync(full, sz, o);
    }
    const int* __restrict__ order = g.orders + order_index(sx, sy, sz) * g.K;
    const float ix = 1.0f / r.dx, iy = 1.0f / r.dy, iz = 1.0f / r.dz;
    const int ns = static_cast<int>(g.ns);
    const int nch = g.C / kChunk;
    for (int k = 0; k < g.K; ++k) {
      const int kk = __ldg(order + k);
      // this ray's gate (the per-ray walk's): the slab entry against
      // min(best t, limit), each box read by the whole warp at once
      const float e = alive ? slab_entry(g.aabb + 8 * kk, r, ix, iy, iz)
                            : kBigT;
      for (int c = 0; c < nch; ++c) {
        // the warp tests the chunk when one of its rays still enters the
        // cluster before its best t; when none does, none will later
        const bool need = e < fminf(h.t, limit);
        if (!__any_sync(full, need)) break;
        const float* src = g.tri + kk * g.C + c * kChunk;
        __syncwarp();          // the previous chunk has been tested
        for (int q = lane; q < 9 * kChunk4; q += 32) {
          const int p = q / kChunk4, w = q - p * kChunk4;
          cp_async16(buf + p * kChunk + 4 * w, src + p * ns + 4 * w);
        }
        cp_async_wait_all();
        __syncwarp();          // every lane's copies are in
        h.tests += kChunk;
        mt_chunk(buf, kk * g.C + c * kChunk, r, need, h);
      }
    }
  }
  if (!alive) h.t = kBigT;
  return h;
}

struct ClosestArgs {
  Grid grid;
  const float* __restrict__ rays;  // (6, R) origin xyz, direction xyz
  long long R;
  float limit;
  float* t_out;     // (R,) BIG_T on a miss
  float* uv_out;    // (2, R), 0 on a miss
  int* slot_out;    // (R,) packed slot, -1 on a miss
  int* tests_out;   // (R,) or null: tests each ray's warp ran
};

__device__ __forceinline__ void write_hit(const ClosestArgs& a, long long i,
                                          const BlockHit& h) {
  a.t_out[i] = h.t;
  a.uv_out[i] = h.u;
  a.uv_out[a.R + i] = h.v;
  a.slot_out[i] = h.slot;
  if (a.tests_out) a.tests_out[i] = h.tests;
}

// The block's blockDim consecutive rays: their live rays are packed to
// the front in their order (a stable partition), so dead rays scattered
// among live ones idle no lane, and each warp walks 32 of them; a warp
// with no live ray walks nothing.  Every ray gets its outputs written
// once.  (Windows of several batches ran slower: a block holds its
// resources until its slowest warp ends, PERF.md.)
__global__ void __launch_bounds__(kMaxBlock, 3)
    cluster_closest_kernel(ClosestArgs a) {
  extern __shared__ float4 smem4[];
  __shared__ int part_sm[kMaxBlock];
  __shared__ int count_sm[kMaxBlock / 32];
  const long long R = a.R;
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31,
            warp = tid >> 5, nw = nt / 32;
  float* const buf = reinterpret_cast<float*>(smem4) + warp * kChunkFloats;
  const long long base = blockIdx.x * static_cast<long long>(nt);
  const bool alive = base + tid < R && fabsf(a.rays[base + tid]) < kAliveLimit;
  const unsigned ballot = __ballot_sync(0xffffffffu, alive);
  if (lane == 0) count_sm[warp] = __popc(ballot);
  __syncthreads();
  int live = 0, before = 0;
  for (int w = 0; w < nw; ++w) {
    if (w == warp) before = live;
    live += count_sm[w];
  }
  const int rank = before + __popc(ballot & ((1u << lane) - 1u));
  part_sm[alive ? rank : live + tid - rank] = tid;
  __syncthreads();
  const long long i = base + part_sm[tid];
  const BlockHit h =
      warp_walk(a.grid, load_ray(a.rays, R, i), tid < live, a.limit, buf);
  if (i < R) write_hit(a, i, h);
}

// The one check of the shapes the walk takes: C a positive
// multiple of kChunk, K*C packed slots, blocks of 32 to kMaxBlock threads
// in whole warps, 32-bit plane and box offsets, triangle planes and
// boxes 16-byte aligned (cp.async and float4 loads).  Its dynamic shared
// memory (a chunk per warp: 18,432 B at 128 threads) is opted in beside
// the window's static 1 KB.
bool walk_takes(const Grid& g, int block) {
  return g.C >= kChunk && g.C % kChunk == 0 && g.K >= 0 &&
         g.ns == static_cast<long long>(g.K) * g.C && block % 32 == 0 &&
         block >= 32 && block <= kMaxBlock && 9 * g.ns < (1LL << 31) &&
         8LL * g.K < (1LL << 31) &&
         reinterpret_cast<unsigned long long>(g.tri) % 16 == 0 &&
         reinterpret_cast<unsigned long long>(g.aabb) % 16 == 0;
}

}  // namespace

extern "C" int rtx_cluster_closest(
    const float* rays, long long R, const float* tri, const float* aabb,
    const int* orders, long long ns, int C, int K, float limit, float* t_out,
    float* uv_out, int* slot_out, int* tests_out, int block, void* stream) {
  const Grid g{tri, aabb, orders, ns, C, K};
  if (!walk_takes(g, block)) return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0) return 0;
  ClosestArgs a{g, rays, R, limit, t_out, uv_out, slot_out, tests_out};
  const long long grid = (R + block - 1) / block;
  const int smem = static_cast<int>(sizeof(float) * walk_smem_floats(block));
  const cudaError_t err = cudaFuncSetAttribute(
      cluster_closest_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) {
    cudaGetLastError();   // not left behind for the next launch's check
    return static_cast<int>(err);
  }
  cluster_closest_kernel<<<static_cast<unsigned>(grid), block, smem,
                           static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rtx_cluster_tests_needed(
    const float* rays, long long R, const float* tri, const float* aabb,
    const int* orders, long long ns, int C, int K, float limit,
    int* clusters_out, float* t_out, int* slot_out, int block,
    void* stream) {
  if (R == 0) return 0;
  NeededArgs a{Grid{tri, aabb, orders, ns, C, K}, rays, R, limit,
               clusters_out, t_out, slot_out};
  const long long grid = (R + block - 1) / block;
  needed_kernel<<<static_cast<unsigned>(grid), block, 0,
                  static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
