// Hand-written CUDA kernels (sm_90a) for the packed two-level BVH of
// the PyTorch port.  They replace the three Pallas TPU kernels of
// raytracer_tpu/ops/pallas_bvh.py:
//
//   rtx_bvh_spawn         <- pallas_bvh_spawn        (pallas_bvh.py:985)
//   rtx_bvh_shadow_shade  <- pallas_bvh_shadow_shade (pallas_bvh.py:1068)
//   rtx_bvh_closest       <- pallas_bvh_closest      (pallas_bvh.py:411)
//
// All find the closest hit over the packed two-level BVH of ops/bvh.py
// (superclusters of G rows, rows of C triangle lanes, S segment boxes
// per row).  The first two are the fused wavefront levels and run their
// epilogue in the same thread:
//   spawn:        the winning triangle's shading record (+ u/v for
//                 textured scenes), one shadow ray per light, one
//                 hemisphere bounce ray per child and its dir6/dir9 sort
//                 key (pallas_bvh.py:811-896);
//   shadow_shade: blocked = 0.01 < t < 1.0 on the CLOSEST hit (not any
//                 hit, reference mod.rs:224-230), then Phong
//                 (c * dot_ln + (v.r)^32) * light_color where lit
//                 (pallas_bvh.py:934-960).
// rtx_bvh_closest is the generic closest hit of the composable wavefront
// (BVHIntersector.query/shadow): t, u, v and the packed slot, or t only
// in shadow mode, plus the winning triangle's record values when record
// planes are given (pallas_bvh.py:361-405); its t limit is a runtime
// argument (static on the TPU).  The TPU kernel's exact_order and stream
// variants pick the walk order and the staging only; this kernel has one
// form for all of them.
//
// What bounds them on an H100: the Moller-Trumbore arithmetic, 54 f32
// operations per ray-triangle test and hundreds of tests per bounce ray on
// thai2, against the card's f32 instruction rate.  The 67 TFLOP/s
// data-sheet peak counts an FMA as two flops; this build contracts nothing
// (see below), so each operation is one instruction and the ceiling is
// about 33.5 T operations/s (128 f32 lanes x 132 SMs x 1.98 GHz).  The ray
// I/O (~100-300 bytes a ray) is far below the 3.35 TB/s line, and the
// triangle planes (9 x NL*C floats, 0.74 MB for thai2 at 256 lanes) stay
// in L2.  A kernel nears the ceiling only if nearly every instruction slot
// goes to those 54 operations: no divergence inside a test, no reloads, no
// lanes idled by dead rays.
//
// The fused kernels walk per block (walk_window, block_walk).  A block of
// B threads (128 by default) takes a window of 4 x B consecutive rays,
// packs their live rays to the front in order (a stable partition: dead
// shadow rays, scattered among live ones in the light-major layout, idle
// no lane) and walks them in batches of B, one ray a thread; a window with
// no live ray walks nothing (levels 1-2 sort dead rays last).  The rays
// are sorted (tile swizzle at level 0, dir6 key after it), so neighbours
// need mostly the same rows.  A batch walks the superclusters in one
// order, picked from its summed live directions as the TPU kernel picks it
// (pallas_bvh.py:149-155).  Per supercluster the block stages its box and
// its G*S segment boxes in shared memory; each live thread slab-tests them
// against min(its best t, limit), keeps its segment entries in shared
// memory, and the block's OR of the rows the threads would enter (a row on
// the min of its S segments, the per-ray walk's gate) is the row list.
// The rows of the list are staged chunk by chunk (128 lanes, 9 planes,
// 4,608 B) into a ring of three shared-memory buffers with cp.async, two
// chunks in flight while one is tested, one barrier per chunk; any C that
// is a multiple of 128 runs.  Each warp then tests only the segments of
// the chunk (C/S lanes each, 64 on the main path) that one of its rays
// still enters before its best t so far, and all 32 threads test those
// lanes in the same order: the reads are shared-memory broadcasts (float4,
// four lanes a load), the warp never diverges inside a test, and offsets
// are 32-bit.  So a warp pays for the union of its rays' segments, not for
// their divergence, and no thread reloads a lane from L2.  Testing lanes a
// ray did not need never changes its closest t, so every ray gets the
// exact closest hit (up to slab rounding at a box face, as in any culled
// walk): the first lane of a row keeps a tie (strict '<' as lanes run in
// order) and a row wins only on a strict '<' (pallas_bvh.py:248-253).
// Walk order changes only the speed, and which triangle wins an exact-t
// tie across rows.  Each kernel counts, per ray, the tests its warp ran
// (tests_out).
//
// rtx_bvh_closest runs the same gates and tests with each warp on its own
// (warp_walk): its order from the warp's summed live directions, the boxes
// read by the whole warp at once, and each chunk it needs staged into the
// warp's own shared-memory buffer; its window is one batch of B rays.  No
// warp then waits at a barrier for a block-mate that needs more segments,
// and no block holds its resources while its slowest warp walks three more
// batches: at the composable wavefront's batches (1-2 M rays) the block
// walk with 4-batch windows ran 1.3-1.4 times as long (PERF.md).
//
// rtx_bvh_tests_needed keeps the per-ray walk of the first versions
// (traverse), one thread per ray, as a counting entry that no timed path
// runs: each thread walks in its own dominant-direction order and gates
// each supercluster and row for itself, every lane of a row loaded per
// thread with __ldg.  Its per-ray counters are the yardstick of every BVH
// kernel's bound, fixed whatever the timed kernels waste: rows_out counts
// the rows it tests (whole rows, the first slice's yardstick), lanes_out
// the lanes of the segments among them that the ray enters before its
// best t so far (the finest gate of an exact walk here: the tests the ray
// needs).
//
// Built with --fmad=false (no contraction of a*b+c), so each operation
// rounds on its own, as in the plain PyTorch versions in
// ops/cuda_bvh.py: the two agree bit for bit on nearly every ray.
//
// Every entry point launches on the caller's stream, allocates nothing
// and returns cudaGetLastError() (0 on success), or cudaErrorInvalidValue
// for a shape its kernel does not take.

#include <cuda_runtime.h>

namespace {

constexpr float kBigT = 3.0e38f;              // core/intersect.py BIG_T
constexpr float kF32Eps = 1.1920929e-07f;     // f32::EPSILON
constexpr float kAliveLimit = 1.0e30f;        // |ox| >= this: dead ray
constexpr float kDeadOrigin = 1.0e35f;
constexpr float kDirTiny = 1.0e-30f;          // slab inverse guard
constexpr float kHitOffset = 1e-5f;           // mod.rs:193
constexpr float kShadowOffset = 0.01f;        // mod.rs:224-225
constexpr float kShadowTMin = 0.01f;          // mod.rs:227 window
constexpr float kShadowTMax = 1.0f;
constexpr int kDeadKey = 1 << 30;
constexpr int kMaxRec = 8;

// The block walk's shapes (walk_config refuses any other).
constexpr int kChunk = 128;                   // lanes staged at a time
constexpr int kChunk4 = kChunk / 4;           // float4s per plane chunk
constexpr int kChunkFloats = 9 * kChunk;      // one staged chunk
constexpr int kMaxG = 32;                     // rows per supercluster mask
constexpr int kMaxBlock = 256;                // threads (rays) per block
constexpr int kBatches = 4;                   // batches per block-walk window

struct Bvh {
  const float* __restrict__ tri;   // (9, ns): v0 xyz, e1 xyz, e2 xyz planes
  const float* __restrict__ seg;   // (NL*S, 8) segment boxes
  const float* __restrict__ sc;    // (K1, 8) supercluster boxes
  const int* __restrict__ orders;  // (6, K1) supercluster visit orders
  long long ns;                    // NL*C packed slots
  int C, S, G, K1;
};

struct Ray {
  float ox, oy, oz, dx, dy, dz;
};

struct Hit {
  float t, u, v;
  long long slot;  // packed slot of the winning lane, -1 on a miss
  int rows;        // rows that ran Moller-Trumbore
  int lanes;       // lanes of the segments entered before the best t
};

// 1/x with |x| clamped to +1e-30 (sign dropped, as _safe_inv,
// pallas_bvh.py:79-82): keeps every slab product finite.
__device__ __forceinline__ float safe_inv(float x) {
  return 1.0f / (fabsf(x) < kDirTiny ? kDirTiny : x);
}

// One axis of the slab test for a ray parallel to the slab (a direction
// component below 1e-30 in magnitude): the ray lies inside the slab
// (lo <= o <= hi, no bound on t) or misses the box.  The TPU kernel
// multiplies by the clamped inverse instead, which gives an exit of 0 for
// a ray lying in a box's max face, so tmax > 0 fails for that ray alone;
// its 128-ray block gate still tests the box when a block-mate enters it,
// and its own test expects such rays to hit
// (tests/test_pallas_bvh.py::test_bvh_axis_parallel_rays_zero_direction).
// Both walks here gate each box per ray, so they take the parallel case
// exactly.
__device__ __forceinline__ void slab_axis(float lo, float hi, float o,
                                          float d, float inv, float& tmin,
                                          float& tmax) {
  if (fabsf(d) < kDirTiny) {
    if (o < lo || o > hi) tmax = -kBigT;
    return;
  }
  const float t1 = (lo - o) * inv, t2 = (hi - o) * inv;
  tmin = fmaxf(tmin, fminf(t1, t2));
  tmax = fminf(tmax, fmaxf(t1, t2));
}

// Slab entry distance of a box lo = (min xyz, max x), hi = (max yz, pad,
// pad); BIG_T when the ray misses it or the box lies behind
// (pallas_bvh.py:166-175).  `parallel`: the ray has a component below
// 1e-30 and each axis takes slab_axis; the walk decides it once per ray,
// so rays without such a component (all of a render's) run the plain
// six-product test.
__device__ __forceinline__ float slab_entry(float4 lo, float4 hi,
                                            const Ray& r, float ix, float iy,
                                            float iz, bool parallel) {
  float tmin, tmax;
  if (parallel) {
    tmin = -kBigT;
    tmax = kBigT;
    slab_axis(lo.x, lo.w, r.ox, r.dx, ix, tmin, tmax);
    slab_axis(lo.y, hi.x, r.oy, r.dy, iy, tmin, tmax);
    slab_axis(lo.z, hi.y, r.oz, r.dz, iz, tmin, tmax);
  } else {
    const float tx1 = (lo.x - r.ox) * ix, tx2 = (lo.w - r.ox) * ix;
    const float ty1 = (lo.y - r.oy) * iy, ty2 = (hi.x - r.oy) * iy;
    const float tz1 = (lo.z - r.oz) * iz, tz2 = (hi.y - r.oz) * iz;
    tmin = fmaxf(fmaxf(fminf(tx1, tx2), fminf(ty1, ty2)), fminf(tz1, tz2));
    tmax = fminf(fminf(fmaxf(tx1, tx2), fmaxf(ty1, ty2)), fmaxf(tz1, tz2));
  }
  return (tmax >= tmin && tmax > 0.0f) ? tmin : kBigT;
}

// The same, for a box [min xyz, max xyz, pad, pad] in global memory.
__device__ __forceinline__ float slab_entry(const float* __restrict__ box,
                                            const Ray& r, float ix, float iy,
                                            float iz, bool parallel) {
  return slab_entry(__ldg(reinterpret_cast<const float4*>(box)),
                    __ldg(reinterpret_cast<const float4*>(box) + 1), r, ix,
                    iy, iz, parallel);
}

// Walk order of the superclusters (one of the six precomputed centroid
// orders) from a direction's dominant axis and sign
// (pallas_bvh.py:149-155).
__device__ __forceinline__ int order_index(float x, float y, float z) {
  const float ax = fabsf(x), ay = fabsf(y), az = fabsf(z);
  int axis = ay > ax ? 1 : 0;
  axis = az > fmaxf(ax, ay) ? 2 : axis;
  const float sgn = axis == 0 ? x : (axis == 1 ? y : z);
  return axis * 2 + (sgn < 0.0f);
}

// Moller-Trumbore of one ray against one triangle (pallas_bvh.py:224-253):
// inv_det multiplies, one sign test for acceptance; the hit replaces the
// best only on a strict '<'.  `kUV` / `kSlot`: also keep u, v / the slot.
template <bool kUV, bool kSlot, typename H, typename S>
__device__ __forceinline__ void mt_test(float v0x, float v0y, float v0z,
                                        float e1x, float e1y, float e1z,
                                        float e2x, float e2y, float e2z,
                                        S s, const Ray& r, H& h) {
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
  const bool ok = non_par &&
      fminf(fminf(uu, vv), fminf(1.0f - (uu + vv), tt)) >= 0.0f;
  if (ok && tt < h.t) {
    h.t = tt;
    if (kUV) {
      h.u = uu;
      h.v = vv;
    }
    if (kSlot) h.slot = s;
  }
}

// --- the per-ray walk (needed_kernel: the bound's yardstick) -------------

// One ray against the C lanes of packed row `row`, each lane loaded from
// global memory; lanes in order, so the first lane keeps a tie.  At the
// first lane of each segment, count its lanes when the ray enters its box
// before min(best t so far, limit); every lane is tested either way.
__device__ __forceinline__ void mt_row(const Bvh& b, long long row,
                                       const Ray& r, float ix, float iy,
                                       float iz, bool par, float limit,
                                       Hit& h) {
  const float* __restrict__ T = b.tri;
  const long long ns = b.ns;
  const long long base = row * b.C;
  const int LC = b.C / b.S;
  for (int j = 0; j < b.C; ++j) {
    if (j % LC == 0 &&
        slab_entry(b.seg + 8LL * (row * b.S + j / LC), r, ix, iy, iz, par) <
            fminf(h.t, limit))
      h.lanes += LC;
    const long long s = base + j;
    mt_test<true, true>(__ldg(T + s), __ldg(T + ns + s),
                        __ldg(T + 2 * ns + s), __ldg(T + 3 * ns + s),
                        __ldg(T + 4 * ns + s), __ldg(T + 5 * ns + s),
                        __ldg(T + 6 * ns + s), __ldg(T + 7 * ns + s),
                        __ldg(T + 8 * ns + s), s, r, h);
  }
}

// Closest hit below `limit` (exact below it; beyond it the walk may cull,
// as the TPU kernel's static t-limit, pallas_bvh.py:425-427).
__device__ Hit traverse(const Bvh& b, const Ray& r, float limit) {
  Hit h{kBigT, 0.0f, 0.0f, -1, 0, 0};
  const float ix = safe_inv(r.dx), iy = safe_inv(r.dy), iz = safe_inv(r.dz);
  const bool par = fabsf(r.dx) < kDirTiny || fabsf(r.dy) < kDirTiny ||
                   fabsf(r.dz) < kDirTiny;
  const int* __restrict__ order =
      b.orders + order_index(r.dx, r.dy, r.dz) * b.K1;
  for (int k = 0; k < b.K1; ++k) {
    const int kk = __ldg(order + k);
    if (!(slab_entry(b.sc + 8LL * kk, r, ix, iy, iz, par) <
          fminf(h.t, limit)))
      continue;
    for (int g = 0; g < b.G; ++g) {
      const long long row = static_cast<long long>(kk) * b.G + g;
      float m = kBigT;
      for (int s = 0; s < b.S; ++s)
        m = fminf(m, slab_entry(b.seg + 8LL * (row * b.S + s), r, ix, iy,
                                iz, par));
      if (!(m < fminf(h.t, limit))) continue;
      ++h.rows;
      mt_row(b, row, r, ix, iy, iz, par, limit, h);
    }
  }
  return h;
}

// --- the block walk (spawn_kernel, shadow_shade_kernel, closest_kernel) ---

struct BlockHit {
  float t, u, v;
  int slot;        // packed slot of the winning lane, -1 on a miss
  int tests;       // ray-triangle tests this thread's warp ran
};

// Dynamic shared memory of a block walk, in floats: a ring of three
// chunks (3 x 9 x 128), the supercluster box and its G*S segment boxes
// ((1 + G*S) x 8), and each thread's segment entries (G*S x block).
constexpr int walk_smem_floats(int G, int S, int block) {
  return 3 * kChunkFloats + 8 * (1 + G * S) + G * S * block;
}

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Bits [lo, hi) of a 32-bit mask (0 <= lo < hi <= 32).
__device__ __forceinline__ unsigned bit_range(int lo, int hi) {
  return (hi >= 32 ? ~0u : (1u << hi) - 1u) & ~((1u << lo) - 1u);
}

// One ray against the float4 lane groups `groups` (bit j: lanes 4j..4j+3)
// of a staged chunk, in lane order.  Every thread of the warp reads the
// same lanes: each float4 read is a broadcast of four lanes of one plane.
template <bool kUV, bool kSlot>
__device__ __forceinline__ void mt_chunk(const float* buf, unsigned groups,
                                         int base, const Ray& r,
                                         BlockHit& h) {
  const float4* q = reinterpret_cast<const float4*>(buf);
  while (groups) {
    const int j = __ffs(groups) - 1;
    groups &= groups - 1u;
    const float4 a0 = q[j], a1 = q[kChunk4 + j], a2 = q[2 * kChunk4 + j];
    const float4 b0 = q[3 * kChunk4 + j], b1 = q[4 * kChunk4 + j],
                 b2 = q[5 * kChunk4 + j];
    const float4 c0 = q[6 * kChunk4 + j], c1 = q[7 * kChunk4 + j],
                 c2 = q[8 * kChunk4 + j];
    const int s = base + 4 * j;
    mt_test<kUV, kSlot>(a0.x, a1.x, a2.x, b0.x, b1.x, b2.x, c0.x, c1.x, c2.x,
                        s, r, h);
    mt_test<kUV, kSlot>(a0.y, a1.y, a2.y, b0.y, b1.y, b2.y, c0.y, c1.y, c2.y,
                        s + 1, r, h);
    mt_test<kUV, kSlot>(a0.z, a1.z, a2.z, b0.z, b1.z, b2.z, c0.z, c1.z, c2.z,
                        s + 2, r, h);
    mt_test<kUV, kSlot>(a0.w, a1.w, a2.w, b0.w, b1.w, b2.w, c0.w, c1.w, c2.w,
                        s + 3, r, h);
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

// Closest hit of every ray of the block below `limit` (exact below it).
// Every thread of the block calls it, with a dead ray past the live ones:
// it holds barriers.  A dead ray gets t = BIG_T, slot -1.  Inlined into
// each kernel, also where two kernels share one instance.
template <bool kUV, bool kSlot>
__device__ __forceinline__ BlockHit block_walk(const Bvh& b, const Ray& r,
                                               bool alive, float limit) {
  extern __shared__ float4 smem4[];
  __shared__ unsigned mask_sm[2];
  __shared__ float sum_sm[kMaxBlock / 32][3];
  const int GS = b.G * b.S;
  float* const rowbuf = reinterpret_cast<float*>(smem4);
  float4* const box4 = reinterpret_cast<float4*>(rowbuf + 3 * kChunkFloats);
  float* const segent = rowbuf + 3 * kChunkFloats + 8 * (1 + GS);
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;

  // a dead ray's best t stays below every accepted t (>= 0): it never
  // takes a hit, and its gates are closed by `alive`
  BlockHit h{alive ? kBigT : -1.0f, 0.0f, 0.0f, -1, 0};

  // the block's summed live directions, in a fixed order
  float sx = alive ? r.dx : 0.0f, sy = alive ? r.dy : 0.0f,
        sz = alive ? r.dz : 0.0f;
  for (int o = 16; o > 0; o >>= 1) {
    sx += __shfl_xor_sync(0xffffffffu, sx, o);
    sy += __shfl_xor_sync(0xffffffffu, sy, o);
    sz += __shfl_xor_sync(0xffffffffu, sz, o);
  }
  __syncthreads();   // a previous walk has read mask_sm and sum_sm
  if (lane == 0) {
    sum_sm[tid >> 5][0] = sx;
    sum_sm[tid >> 5][1] = sy;
    sum_sm[tid >> 5][2] = sz;
  }
  if (tid == 0) mask_sm[0] = mask_sm[1] = 0u;
  if (__syncthreads_or(alive)) {
    sx = sy = sz = 0.0f;
    for (int w = 0; w < nt / 32; ++w) {
      sx += sum_sm[w][0];
      sy += sum_sm[w][1];
      sz += sum_sm[w][2];
    }
    const int* __restrict__ order = b.orders + order_index(sx, sy, sz) * b.K1;
    const float ix = safe_inv(r.dx), iy = safe_inv(r.dy), iz = safe_inv(r.dz);
    const bool par = fabsf(r.dx) < kDirTiny || fabsf(r.dy) < kDirTiny ||
                     fabsf(r.dz) < kDirTiny;
    const int ns = static_cast<int>(b.ns);
    const int nch = b.C / kChunk;
    const int LC = b.C / b.S;   // lanes per segment

    for (int k = 0; k < b.K1; ++k) {
      const int kk = __ldg(order + k);
      // stage the supercluster box and its segment boxes
      const float4* sc4 = reinterpret_cast<const float4*>(b.sc + 8 * kk);
      const float4* seg4 =
          reinterpret_cast<const float4*>(b.seg + 8 * kk * GS);
      for (int q = tid; q < 2 * (1 + GS); q += nt)
        box4[q] = q < 2 ? __ldg(sc4 + q) : __ldg(seg4 + q - 2);
      __syncthreads();
      // this thread's gates: the supercluster, then each row on the min
      // of its S segment entries (the per-ray walk's gates)
      const float cap = fminf(h.t, limit);
      const bool entered =
          alive && slab_entry(box4[0], box4[1], r, ix, iy, iz, par) < cap;
      unsigned bits = 0u;
      if (entered) {
        for (int g = 0; g < b.G; ++g) {
          float m = kBigT;
          for (int s = 0; s < b.S; ++s) {
            const int q = g * b.S + s;
            const float e = slab_entry(box4[2 + 2 * q], box4[3 + 2 * q], r,
                                       ix, iy, iz, par);
            segent[q * nt + tid] = e;
            m = fminf(m, e);
          }
          bits |= (m < cap ? 1u : 0u) << g;
        }
      }
      bits = __reduce_or_sync(0xffffffffu, bits);
      if (lane == 0 && bits) atomicOr(&mask_sm[k & 1], bits);
      __syncthreads();
      const unsigned rowmask = mask_sm[k & 1];
      if (tid == 0) mask_sm[(k + 1) & 1] = 0u;  // read before this barrier
      if (!rowmask) continue;

      // the block's rows, chunk by chunk, in a ring of three buffers:
      // the copies of units u+1 and u+2 are in flight while unit u is
      // tested, and one barrier per unit both publishes unit u and frees
      // the buffer of unit u-1
      const int units = __popc(rowmask) * nch;
      unsigned pm = rowmask;   // producer: rows not yet started
      int pg = __ffs(pm) - 1, pc = 0;
      pm &= pm - 1;
      auto stage = [&](int buf) {
        const float* src = b.tri + (kk * b.G + pg) * b.C + pc * kChunk;
        float* dst = rowbuf + buf * kChunkFloats;
        for (int q = tid; q < 9 * kChunk4; q += nt) {
          const int p = q / kChunk4, w = q - p * kChunk4;
          cp_async16(dst + p * kChunk + 4 * w, src + p * ns + 4 * w);
        }
        cp_async_commit();
        if (++pc == nch) {
          pc = 0;
          pg = __ffs(pm) - 1;
          pm &= pm - 1;
        }
      };
      unsigned cm = rowmask;   // consumer: rows not yet tested
      int cg = 0, cc = nch - 1;
      stage(0);
      if (units > 1)
        stage(1);
      else
        cp_async_commit();     // an empty group keeps the count uniform
      for (int u = 0; u < units; ++u) {
        if (++cc == nch) {
          cc = 0;
          cg = __ffs(cm) - 1;
          cm &= cm - 1;
        }
        // the lanes this warp tests: the segments of the chunk that one
        // of its rays still enters before its best t (the per-ray walk's
        // gate, per segment and against the best t so far)
        const int lo = cc * kChunk, hi = lo + kChunk;
        const float cur = fminf(h.t, limit);
        unsigned groups = 0u;
        for (int s = lo / LC; s < b.S && s * LC < hi; ++s) {
          const bool need =
              entered && segent[(cg * b.S + s) * nt + tid] < cur;
          if (__any_sync(0xffffffffu, need))
            groups |= bit_range((max(s * LC, lo) - lo) >> 2,
                                (min((s + 1) * LC, hi) - lo + 3) >> 2);
        }
        h.tests += 4 * __popc(groups);
        cp_async_wait_prev();  // unit u has landed (u+1 may be in flight)
        __syncthreads();
        if (u + 2 < units)
          stage((u + 2) % 3);
        else
          cp_async_commit();
        mt_chunk<kUV, kSlot>(rowbuf + (u % 3) * kChunkFloats, groups,
                             (kk * b.G + cg) * b.C + lo, r, h);
      }
    }
  }
  if (!alive) h.t = kBigT;
  return h;
}

// Dynamic shared memory of a warp walk, in floats: one staged chunk for
// each warp of the block.
constexpr int warp_smem_floats(int block) { return block / 32 * kChunkFloats; }

// The block walk's gates and tests, walked by each warp on its own (no
// block barrier): its order from the warp's summed live directions, the
// supercluster and segment boxes read by the whole warp at once, and each
// chunk that one of its rays still needs staged into the warp's own
// buffer (the float4 groups of the needed segments) and tested from
// broadcasts.  A warp then waits for no block-mate that needs more
// segments.  Every thread of the warp calls it, with a dead ray where a
// lane has no live one.  A dead ray gets t = BIG_T, slot -1.
template <bool kUV, bool kSlot>
__device__ __forceinline__ BlockHit warp_walk(const Bvh& b, const Ray& r,
                                              bool alive, float limit) {
  extern __shared__ float4 smem4[];
  const unsigned full = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  float* const buf =
      reinterpret_cast<float*>(smem4) + (threadIdx.x >> 5) * kChunkFloats;
  BlockHit h{alive ? kBigT : -1.0f, 0.0f, 0.0f, -1, 0};
  if (__any_sync(full, alive)) {
    float sx = alive ? r.dx : 0.0f, sy = alive ? r.dy : 0.0f,
          sz = alive ? r.dz : 0.0f;
    for (int o = 16; o > 0; o >>= 1) {
      sx += __shfl_xor_sync(full, sx, o);
      sy += __shfl_xor_sync(full, sy, o);
      sz += __shfl_xor_sync(full, sz, o);
    }
    const int* __restrict__ order = b.orders + order_index(sx, sy, sz) * b.K1;
    const float ix = safe_inv(r.dx), iy = safe_inv(r.dy), iz = safe_inv(r.dz);
    const bool par = fabsf(r.dx) < kDirTiny || fabsf(r.dy) < kDirTiny ||
                     fabsf(r.dz) < kDirTiny;
    const int ns = static_cast<int>(b.ns);
    const int nch = b.C / kChunk;
    const int LC = b.C / b.S;   // lanes per segment
    for (int k = 0; k < b.K1; ++k) {
      const int kk = __ldg(order + k);
      const bool entered =
          alive && slab_entry(b.sc + 8 * kk, r, ix, iy, iz, par) <
                       fminf(h.t, limit);
      if (!__any_sync(full, entered)) continue;
      for (int g = 0; g < b.G; ++g) {
        const int row = kk * b.G + g;
        for (int c = 0; c < nch; ++c) {
          // the segments of the chunk that one of the warp's rays still
          // enters before its best t (the per-ray walk's gates)
          const int lo = c * kChunk, hi = lo + kChunk;
          const float cur = fminf(h.t, limit);
          unsigned groups = 0u;
          for (int s = lo / LC; s < b.S && s * LC < hi; ++s) {
            const bool need =
                entered && slab_entry(b.seg + 8 * (row * b.S + s), r, ix,
                                      iy, iz, par) < cur;
            if (__any_sync(full, need))
              groups |= bit_range((max(s * LC, lo) - lo) >> 2,
                                  (min((s + 1) * LC, hi) - lo + 3) >> 2);
          }
          if (!groups) continue;
          const float* src = b.tri + row * b.C + lo;
          __syncwarp();          // the previous chunk has been tested
          for (int q = lane; q < 9 * kChunk4; q += 32) {
            const int p = q / kChunk4, w = q - p * kChunk4;
            if ((groups >> w) & 1u)
              cp_async16(buf + p * kChunk + 4 * w, src + p * ns + 4 * w);
          }
          cp_async_wait_all();
          __syncwarp();          // every lane's copies are in
          h.tests += 4 * __popc(groups);
          mt_chunk<kUV, kSlot>(buf, groups, row * b.C + lo, r, h);
        }
      }
    }
  }
  if (!alive) h.t = kBigT;
  return h;
}

// Batches of blockDim rays in a window: kBatches for the block walk, one
// for the warp walk, whose warps hold their block's resources until the
// slowest one ends (longer windows ran slower: PERF.md).
__host__ __device__ constexpr int window_batches(bool warp) {
  return warp ? 1 : kBatches;
}

// A window of window_batches * blockDim consecutive rays per block: its
// live rays are packed to the front in their order (a stable partition)
// and walked in batches of blockDim, so dead rays scattered among live
// ones (shadow rays of misses and back faces) idle no lane; a window with
// no live ray walks nothing.  kWarp: each warp walks its rays on its own
// (warp_walk), else the block together (block_walk).  `epi(i, ray,
// alive, hit)` writes ray i's outputs; every ray of the window gets
// exactly one call.
template <bool kWarp, bool kUV, bool kSlot, typename Epilogue>
__device__ void walk_window(const Bvh& b, const float* __restrict__ rays,
                            long long R, float limit, int* tests_out,
                            Epilogue epi) {
  constexpr int kB = window_batches(kWarp);
  __shared__ int part_sm[kB * kMaxBlock];
  __shared__ int count_sm[kB][kMaxBlock / 32];
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31,
            warp = tid >> 5, nw = nt / 32;
  const long long base = blockIdx.x * static_cast<long long>(kB * nt);
  unsigned ballots[kB];
#pragma unroll
  for (int k = 0; k < kB; ++k) {
    const long long i = base + k * nt + tid;
    const bool alive = i < R && fabsf(rays[i]) < kAliveLimit;
    ballots[k] = __ballot_sync(0xffffffffu, alive);
    if (lane == 0) count_sm[k][warp] = __popc(ballots[k]);
  }
  __syncthreads();
  int live = 0, before[kB];
#pragma unroll
  for (int k = 0; k < kB; ++k)
    for (int w = 0; w < nw; ++w) {
      if (w == warp) before[k] = live;
      live += count_sm[k][w];
    }
  const unsigned lt = (1u << lane) - 1u;
#pragma unroll
  for (int k = 0; k < kB; ++k) {
    const int off = k * nt + tid;
    const int rank = before[k] + __popc(ballots[k] & lt);   // live before
    part_sm[(ballots[k] >> lane) & 1u ? rank : live + off - rank] = off;
  }
  __syncthreads();
  const int batches = (live + nt - 1) / nt;
  for (int bt = 0; bt < batches; ++bt) {
    const int p = bt * nt + tid;
    const long long i = base + part_sm[p];
    const Ray r = load_ray(rays, R, i);
    BlockHit h;
    if constexpr (kWarp)
      h = warp_walk<kUV, kSlot>(b, r, p < live, limit);
    else
      h = block_walk<kUV, kSlot>(b, r, p < live, limit);
    if (i < R) {
      if (tests_out) tests_out[i] = h.tests;
      epi(i, r, p < live, h);
    }
  }
  const BlockHit miss{kBigT, 0.0f, 0.0f, -1, 0};
  for (int p = batches * nt + tid; p < kB * nt; p += nt) {
    const long long i = base + part_sm[p];
    if (i < R) {
      if (tests_out) tests_out[i] = 0;
      epi(i, load_ray(rays, R, i), false, miss);
    }
  }
}

// Launch configuration of a walk_window kernel, and the one check of the
// shapes it takes: C a multiple of kChunk, S segments dividing C, 1 to
// kMaxG rows per supercluster, blocks of 32 to kMaxBlock threads in whole
// warps, 32-bit plane and box offsets, triangle planes 16-byte aligned
// (cp.async copies 16 B).  Its dynamic shared memory (warp_smem_floats
// for a warp walk, else walk_smem_floats) is always opted in, as the
// default 48 KB counts the window's static 4 KB too (a block walk of 256
// threads needs 47,648 B dynamic at G = 8, S = 4); past the card's limit
// that opt-in fails.
template <typename K>
cudaError_t walk_config(K kernel, const Bvh& b, int block, bool warp,
                        size_t* smem) {
  if (b.C % kChunk != 0 || b.G < 1 || b.G > kMaxG || b.S < 1 ||
      b.C % b.S != 0 ||
      block % 32 != 0 || block < 32 || block > kMaxBlock ||
      9 * b.ns >= (1LL << 31) ||
      8LL * b.K1 * b.G * b.S >= (1LL << 31) ||
      reinterpret_cast<unsigned long long>(b.tri) % 16 != 0 || b.ns % 4 != 0)
    return cudaErrorInvalidValue;
  *smem = sizeof(float) * (warp ? warp_smem_floats(block)
                                : walk_smem_floats(b.G, b.S, block));
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(*smem));
  // a refused opt-in is also the thread's last error: clear it, so that
  // the next launch's cudaGetLastError() reports that launch alone
  if (err != cudaSuccess) cudaGetLastError();
  return err;
}

// --- shading helpers ------------------------------------------------------

// shade._normalize / pallas_bvh._norm3: v / where(|v| > 0, |v|, 1).
__device__ __forceinline__ void norm3(float x, float y, float z, float& ox,
                                      float& oy, float& oz) {
  const float n = sqrtf(x * x + y * y + z * z);
  const float safe = n > 0.0f ? n : 1.0f;
  ox = x / safe;
  oy = y / safe;
  oz = z / safe;
}

// Morton bit-spread of 7 bits (wavefront._expand3).
__device__ __forceinline__ int expand3(int x) {
  x = (x | (x << 8)) & 0x0100F00F;
  x = (x | (x << 4)) & 0x010C30C3;
  x = (x | (x << 2)) & 0x09249249;
  return x;
}

__device__ __forceinline__ int quant_pos(float c, float lo, float inv) {
  return static_cast<int>(fminf(fmaxf((c - lo) * inv * 128.0f, 0.0f), 127.0f));
}

// Sort key of a live child ray (pallas_bvh.py:868-893): direction bins
// major, origin Morton minor; key_mode 1 = dir6, 2 = dir9, 0 = none.
__device__ __forceinline__ int sort_key(int key_mode, float cox, float coy,
                                        float coz, float cdx, float cdy,
                                        float cdz, const float* lo,
                                        const float* inv) {
  if (key_mode == 0) return 0;
  const int morton = (expand3(quant_pos(cox, lo[0], inv[0])) << 2) |
                     (expand3(quant_pos(coy, lo[1], inv[1])) << 1) |
                     expand3(quant_pos(coz, lo[2], inv[2]));
  float mag = fmaxf(fmaxf(fabsf(cdx), fabsf(cdy)), fabsf(cdz));
  mag = fmaxf(mag, 1e-30f);
  const int bits = key_mode == 1 ? 2 : 3;
  const float scale = key_mode == 1 ? 2.0f : 4.0f;
  const float hi = key_mode == 1 ? 3.0f : 7.0f;
  const int q0 = static_cast<int>(fminf(fmaxf((cdx / mag + 1.0f) * scale, 0.0f), hi));
  const int q1 = static_cast<int>(fminf(fmaxf((cdy / mag + 1.0f) * scale, 0.0f), hi));
  const int q2 = static_cast<int>(fminf(fmaxf((cdz / mag + 1.0f) * scale, 0.0f), hi));
  const int dirbin = (q0 << (2 * bits)) | (q1 << bits) | q2;
  return key_mode == 1 ? ((dirbin << 15) | (morton >> 6))
                       : ((dirbin << 21) | morton);
}

// --- the fused kernels ------------------------------------------------------

struct SpawnArgs {
  Bvh bvh;
  const float* __restrict__ rays;    // (6, R) origin xyz, direction xyz
  long long R;
  const float* __restrict__ gauss;   // (3*b, R) canonical Gaussian draws
  int b;
  const float* __restrict__ lights;  // (L, 3) light positions
  int L;
  const float* __restrict__ rec;     // (n_rec, ns) shading-record planes
  int n_rec;
  float lo[3], inv[3];               // world bounds for the sort key
  int key_mode;
  float* t_out;        // (R,)
  float* uv_out;       // (2, R) or null
  float* rec_out;      // (n_rec, R)
  float* shadow_out;   // (6, L*R) light-major shadow rays
  float* child_out;    // (6, R*b) child rays, parent-major interleave
  int* key_out;        // (R*b,)
  int* tests_out;      // (R,) or null: tests each ray's warp ran
};

// Spawn outputs of ray i (pallas_bvh.py:811-896): t (+ u, v), the winning
// record, one shadow ray per light and the child rays with their keys.
template <bool kUV>
__device__ __forceinline__ void spawn_epilogue(const SpawnArgs& a,
                                               long long i, const Ray& r,
                                               bool alive, const BlockHit& h) {
  const long long R = a.R;
  a.t_out[i] = h.t;
  if (kUV) {
    a.uv_out[i] = h.u;
    a.uv_out[R + i] = h.v;
  }
  float rec[kMaxRec];
  for (int k = 0; k < a.n_rec; ++k) {
    rec[k] = h.slot >= 0 ? __ldg(a.rec + k * a.bvh.ns + h.slot) : 0.0f;
    a.rec_out[k * R + i] = rec[k];
  }

  const bool hit = alive && h.t < kBigT;
  const float ts = hit ? h.t : 0.0f;   // prepare_shade t sanitization
  const float hpx = r.ox + ts * r.dx;
  const float hpy = r.oy + ts * r.dy;
  const float hpz = r.oz + ts * r.dz;
  const float nx = rec[0], ny = rec[1], nz = rec[2];

  // shadow rays: origin offset along the UNNORMALIZED to-light vector,
  // facing tested with the normalized one (pallas_bvh.py:834-846)
  const long long ss = static_cast<long long>(a.L) * R;
  for (int li = 0; li < a.L; ++li) {
    const float tlx = __ldg(a.lights + 3 * li) - hpx;
    const float tly = __ldg(a.lights + 3 * li + 1) - hpy;
    const float tlz = __ldg(a.lights + 3 * li + 2) - hpz;
    float tnx, tny, tnz;
    norm3(tlx, tly, tlz, tnx, tny, tnz);
    const float dln = nx * tnx + ny * tny + nz * tnz;
    const bool sal = hit && dln >= 0.0f;
    const long long o = li * R + i;
    a.shadow_out[o] = sal ? hpx + kShadowOffset * tlx : kDeadOrigin;
    a.shadow_out[ss + o] = sal ? hpy + kShadowOffset * tly : kDeadOrigin;
    a.shadow_out[2 * ss + o] = sal ? hpz + kShadowOffset * tlz : kDeadOrigin;
    a.shadow_out[3 * ss + o] = sal ? tlx : 1.0f;
    a.shadow_out[4 * ss + o] = sal ? tly : 1.0f;
    a.shadow_out[5 * ss + o] = sal ? tlz : 1.0f;
  }

  // child bounce rays: normalized Gaussian flipped into the normal's
  // hemisphere, spawned HIT_OFFSET along it (pallas_bvh.py:850-867)
  const long long cs = R * a.b;
  for (int j = 0; j < a.b; ++j) {
    float ux, uy, uz;
    norm3(a.gauss[(3 * j) * R + i], a.gauss[(3 * j + 1) * R + i],
          a.gauss[(3 * j + 2) * R + i], ux, uy, uz);
    const bool flip = ux * nx + uy * ny + uz * nz < 0.0f;
    const float cdx = flip ? -ux : ux;
    const float cdy = flip ? -uy : uy;
    const float cdz = flip ? -uz : uz;
    const float cox = hpx + kHitOffset * cdx;
    const float coy = hpy + kHitOffset * cdy;
    const float coz = hpz + kHitOffset * cdz;
    const long long c = i * a.b + j;
    a.child_out[c] = hit ? cox : kDeadOrigin;
    a.child_out[cs + c] = hit ? coy : kDeadOrigin;
    a.child_out[2 * cs + c] = hit ? coz : kDeadOrigin;
    a.child_out[3 * cs + c] = hit ? cdx : 1.0f;
    a.child_out[4 * cs + c] = hit ? cdy : 1.0f;
    a.child_out[5 * cs + c] = hit ? cdz : 1.0f;
    a.key_out[c] = hit ? sort_key(a.key_mode, cox, coy, coz, cdx, cdy, cdz,
                                  a.lo, a.inv)
                       : kDeadKey;
  }
}

template <bool kUV>
__global__ void __launch_bounds__(kMaxBlock, 3) spawn_kernel(SpawnArgs a) {
  walk_window<false, kUV, true>(
      a.bvh, a.rays, a.R, kBigT, a.tests_out,
      [&](long long i, const Ray& r, bool alive, const BlockHit& h) {
        spawn_epilogue<kUV>(a, i, r, alive, h);
      });
}

struct ShadowArgs {
  Bvh bvh;
  const float* __restrict__ rays;    // (6, NS) shadow rays, light-major
  long long NS, R;                   // NS = L * R
  const float* __restrict__ normal;  // (3, R) parent-level planes
  const float* __restrict__ color;   // (3, R)
  const float* __restrict__ view;    // (3, R) parent ray directions
  const float* __restrict__ light_color;  // (L, 3)
  float* out;                        // (3, NS) radiance per light chunk
  int* tests_out;                    // (NS,) or null
};

// Radiance of shadow ray i: occlusion in the (0.01, 1.0) window of the
// closest hit, then Phong (pallas_bvh.py:934-960).  `alive`: the parent
// hit and faces the light (from spawn).
__device__ __forceinline__ void shade_epilogue(const ShadowArgs& a,
                                               long long i, const Ray& r,
                                               bool alive, const BlockHit& h) {
  const long long NS = a.NS, R = a.R;
  const bool blocked = h.t < kBigT && h.t > kShadowTMin && h.t < kShadowTMax;

  const long long li = i / R;          // light chunk of this shadow ray
  const long long p = i - li * R;      // its parent ray
  const float nx = a.normal[p], ny = a.normal[R + p], nz = a.normal[2 * R + p];
  float vx, vy, vz, tnx, tny, tnz;
  norm3(a.view[p], a.view[R + p], a.view[2 * R + p], vx, vy, vz);
  norm3(r.dx, r.dy, r.dz, tnx, tny, tnz);
  const float dln = nx * tnx + ny * tny + nz * tnz;
  // reflect + unclamped even-power Phong (mod.rs:252-256, pow32)
  const float rx = 2.0f * dln * nx - tnx;
  const float ry = 2.0f * dln * ny - tny;
  const float rz = 2.0f * dln * nz - tnz;
  float s = vx * rx + vy * ry + vz * rz;
  for (int k = 0; k < 5; ++k) s = s * s;
  const bool lit = alive && !blocked;
  for (int k = 0; k < 3; ++k) {
    const float c = a.color[k * R + p];
    const float lc = __ldg(a.light_color + 3 * li + k);
    a.out[k * NS + i] = lit ? (c * dln + s) * lc : 0.0f;
  }
}

__global__ void __launch_bounds__(kMaxBlock, 3)
    shadow_shade_kernel(ShadowArgs a) {
  walk_window<false, false, false>(
      a.bvh, a.rays, a.NS, kShadowTMax, a.tests_out,
      [&](long long i, const Ray& r, bool alive, const BlockHit& h) {
        shade_epilogue(a, i, r, alive, h);
      });
}

// --- the generic closest hit ------------------------------------------------

struct ClosestArgs {
  Bvh bvh;
  const float* __restrict__ rays;    // (6, R) origin xyz, direction xyz
  long long R;
  float limit;                       // exact below it (pallas t_limit)
  const float* __restrict__ rec;     // (n_rec, ns) record planes or null
  int n_rec;
  float* t_out;     // (R,) BIG_T on a miss
  float* uv_out;    // (2, R); null in shadow mode
  int* slot_out;    // (R,) packed slot, -1 on a miss; null in shadow mode
  float* rec_out;   // (n_rec, R) winning record, 0 on a miss
  int* tests_out;   // (R,) or null: tests each ray's warp ran
};

// Generic closest hit (pallas_bvh.py:361-405, _bvh_kernel) on the warp
// walk: t, u, v, the slot and the winning record, taken as the spawn
// epilogue takes it; in shadow mode (kShadow) t only.
template <bool kShadow>
__global__ void __launch_bounds__(kMaxBlock, 3)
    closest_kernel(ClosestArgs a) {
  walk_window<true, !kShadow, !kShadow>(
      a.bvh, a.rays, a.R, a.limit, a.tests_out,
      [&](long long i, const Ray&, bool, const BlockHit& h) {
        a.t_out[i] = h.t;
        if constexpr (!kShadow) {
          a.uv_out[i] = h.u;
          a.uv_out[a.R + i] = h.v;
          a.slot_out[i] = h.slot;
          for (int k = 0; k < a.n_rec; ++k)
            a.rec_out[k * a.R + i] =
                h.slot >= 0 ? __ldg(a.rec + k * a.bvh.ns + h.slot) : 0.0f;
        }
      });
}

struct NeededArgs {
  Bvh bvh;
  const float* __restrict__ rays;    // (6, R)
  long long R;
  float limit;
  int* rows_out;    // (R,) rows that ran Moller-Trumbore
  int* lanes_out;   // (R,) lanes of the segments entered before the best t
  float* t_out;     // (R,) BIG_T on a miss
  int* slot_out;    // (R,) packed slot, -1 on a miss
};

// The per-ray walk's counters (and its closest hit) for every ray.
__global__ void needed_kernel(NeededArgs a) {
  const long long i =
      blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (i >= a.R) return;
  const Ray r = load_ray(a.rays, a.R, i);
  Hit h{kBigT, 0.0f, 0.0f, -1, 0, 0};
  if (fabsf(r.ox) < kAliveLimit) h = traverse(a.bvh, r, a.limit);
  a.rows_out[i] = h.rows;
  a.lanes_out[i] = h.lanes;
  a.t_out[i] = h.t;
  a.slot_out[i] = static_cast<int>(h.slot);
}

Bvh make_bvh(const float* tri, const float* seg, const float* sc,
             const int* orders, long long ns, int C, int S, int G, int K1) {
  return Bvh{tri, seg, sc, orders, ns, C, S, G, K1};
}

}  // namespace

extern "C" int rtx_bvh_spawn(
    const float* rays, long long R, const float* gauss, int b,
    const float* lights, int L, const float* tri, const float* rec, int n_rec,
    const float* seg, const float* sc, const int* orders, long long ns, int C,
    int S, int G, int K1, float lo0, float lo1, float lo2, float inv0,
    float inv1, float inv2, int key_mode, float* t_out, float* uv_out,
    float* rec_out, float* shadow_out, float* child_out, int* key_out,
    int* tests_out, int block, void* stream) {
  if (n_rec < 3 || n_rec > kMaxRec) return static_cast<int>(cudaErrorInvalidValue);
  SpawnArgs a{make_bvh(tri, seg, sc, orders, ns, C, S, G, K1),
              rays, R, gauss, b, lights, L, rec, n_rec,
              {lo0, lo1, lo2}, {inv0, inv1, inv2}, key_mode,
              t_out, uv_out, rec_out, shadow_out, child_out, key_out,
              tests_out};
  auto kernel = uv_out ? spawn_kernel<true> : spawn_kernel<false>;
  size_t smem = 0;
  const cudaError_t err = walk_config(kernel, a.bvh, block, false, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (R == 0) return 0;
  const long long grid = (R + kBatches * block - 1) / (kBatches * block);
  kernel<<<static_cast<unsigned>(grid), block, smem,
           static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rtx_bvh_shadow_shade(
    const float* rays, long long NS, long long R, const float* normal,
    const float* color, const float* view, const float* light_color,
    const float* tri, const float* seg, const float* sc, const int* orders,
    long long ns, int C, int S, int G, int K1, float* out, int* tests_out,
    int block, void* stream) {
  ShadowArgs a{make_bvh(tri, seg, sc, orders, ns, C, S, G, K1),
               rays, NS, R, normal, color, view, light_color, out, tests_out};
  size_t smem = 0;
  const cudaError_t err =
      walk_config(shadow_shade_kernel, a.bvh, block, false, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (NS == 0) return 0;
  const long long grid = (NS + kBatches * block - 1) / (kBatches * block);
  shadow_shade_kernel<<<static_cast<unsigned>(grid), block, smem,
                        static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rtx_bvh_closest(
    const float* rays, long long R, const float* tri, const float* seg,
    const float* sc, const int* orders, long long ns, int C, int S, int G,
    int K1, float limit, const float* rec, int n_rec, float* t_out,
    float* uv_out, int* slot_out, float* rec_out, int* tests_out, int block,
    void* stream) {
  const bool shadow = uv_out == nullptr;
  if (n_rec < 0 || n_rec > kMaxRec || (n_rec > 0 && (!rec || !rec_out)) ||
      (shadow ? (slot_out || n_rec) : !slot_out))
    return static_cast<int>(cudaErrorInvalidValue);
  ClosestArgs a{make_bvh(tri, seg, sc, orders, ns, C, S, G, K1),
                rays, R, limit, rec, n_rec, t_out, uv_out, slot_out,
                rec_out, tests_out};
  auto kernel = shadow ? closest_kernel<true> : closest_kernel<false>;
  size_t smem = 0;
  const cudaError_t err = walk_config(kernel, a.bvh, block, true, &smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (R == 0) return 0;
  const long long grid = (R + window_batches(true) * block - 1) /
                         (window_batches(true) * block);
  kernel<<<static_cast<unsigned>(grid), block, smem,
           static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rtx_bvh_tests_needed(
    const float* rays, long long R, const float* tri, const float* seg,
    const float* sc, const int* orders, long long ns, int C, int S, int G,
    int K1, float limit, int* rows_out, int* lanes_out, float* t_out,
    int* slot_out, int block, void* stream) {
  if (S < 1 || C % S != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0) return 0;
  NeededArgs a{make_bvh(tri, seg, sc, orders, ns, C, S, G, K1),
               rays, R, limit, rows_out, lanes_out, t_out, slot_out};
  const long long grid = (R + block - 1) / block;
  needed_kernel<<<static_cast<unsigned>(grid), block, 0,
                  static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
