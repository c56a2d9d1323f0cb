// Hand-written CUDA kernels (sm_90a) for the packed two-level BVH of
// the PyTorch port.  They replace the three Pallas TPU kernels of
// raytracer_tpu/ops/pallas_bvh.py:
//
//   rtx_bvh_spawn         <- pallas_bvh_spawn        (pallas_bvh.py:985)
//   rtx_bvh_shadow_shade  <- pallas_bvh_shadow_shade (pallas_bvh.py:1068)
//   rtx_bvh_closest       <- pallas_bvh_closest      (pallas_bvh.py:411)
//
// All walk the packed two-level BVH of ops/bvh.py (superclusters of G
// rows, rows of C triangle lanes, S segment boxes per row) for the
// closest hit.  The first two are the fused wavefront levels and run
// their epilogue in the same thread:
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
// planes are given; its t limit is a runtime argument (static on the
// TPU).  The TPU kernel's exact_order and stream variants pick the walk
// order and the staging only; this kernel has one form for all of them.
//
// Design: one thread per ray.  Each thread walks the superclusters in
// one of six precomputed centroid orders, picked from its own dominant
// direction axis and sign (the TPU kernel picks it per 128-ray block,
// pallas_bvh.py:149-155), gates each supercluster on its slab entry
// against min(best t, limit), then each row on the min of its S segment
// entries, and runs Moller-Trumbore over the C lanes of every surviving
// row.  Walk order changes only the speed: the closest t is exact in any
// order, ties keep the first lane of a row and a row wins only on a
// strict '<' (pallas_bvh.py:248-253).
//
// What bounds it on an H100: the Moller-Trumbore arithmetic (54 f32
// operations per ray-triangle test, hundreds of tests per bounce ray on
// thai2) against the card's f32 issue rate.  The 67 TFLOP/s data-sheet
// peak counts an FMA as two flops; this build contracts nothing (see
// below), so each operation is one instruction and the ceiling is about
// 33.5 T operations/s (128 f32 lanes x 132 SMs x 1.98 GHz); the ray I/O
// (~100-300 bytes a ray) is far below the 3.35 TB/s line.  The triangle
// planes (9 x NL*C floats, 0.74 MB for thai2 at 256 lanes) stay in L2
// and are read with __ldg.  This first version spends nothing on the
// bound beyond the two-level culling: a warp's threads diverge between
// rows, and every lane of a row is reloaded per thread.  Warp-cooperative
// rows, shared-memory staging of triangle rows and cp.async are later
// work.
//
// Built with --fmad=false (no contraction of a*b+c), so each operation
// rounds on its own, as in the plain PyTorch versions in
// ops/cuda_bvh.py: the two agree bit for bit on nearly every ray.
//
// Every entry point launches on the caller's stream, allocates nothing
// and returns cudaGetLastError() (0 on success).

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
  int rows;        // rows that ran Moller-Trumbore (work counter)
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
// A per-ray walk has no block-mates, so it takes the parallel case
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

// Slab entry distance of a box [min xyz, max xyz, pad, pad]; BIG_T when
// the ray misses it or the box lies behind (pallas_bvh.py:166-175).
// `parallel`: the ray has a component below 1e-30 and each axis takes
// slab_axis; the walk decides it once per ray, so rays without such a
// component (all of a render's) run the plain six-product test.
__device__ __forceinline__ float slab_entry(const float* __restrict__ box,
                                            const Ray& r, float ix, float iy,
                                            float iz, bool parallel) {
  const float4 lo = __ldg(reinterpret_cast<const float4*>(box));
  const float4 hi = __ldg(reinterpret_cast<const float4*>(box) + 1);
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

// Moller-Trumbore of one ray against the C lanes of packed row `row`
// (pallas_bvh.py:224-253): inv_det multiplies, one sign test for
// acceptance, strict '<' so the first lane keeps a tie.
__device__ __forceinline__ void mt_row(const Bvh& b, long long row,
                                       const Ray& r, Hit& h) {
  const float* __restrict__ T = b.tri;
  const long long ns = b.ns;
  const long long base = row * b.C;
  for (int j = 0; j < b.C; ++j) {
    const long long s = base + j;
    const float v0x = __ldg(T + s), v0y = __ldg(T + ns + s),
                v0z = __ldg(T + 2 * ns + s);
    const float e1x = __ldg(T + 3 * ns + s), e1y = __ldg(T + 4 * ns + s),
                e1z = __ldg(T + 5 * ns + s);
    const float e2x = __ldg(T + 6 * ns + s), e2y = __ldg(T + 7 * ns + s),
                e2z = __ldg(T + 8 * ns + s);
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
      h.u = uu;
      h.v = vv;
      h.slot = s;
    }
  }
}

// Closest hit below `limit` (exact below it; beyond it the walk may cull,
// as the TPU kernel's static t-limit, pallas_bvh.py:425-427).
__device__ Hit traverse(const Bvh& b, const Ray& r, float limit) {
  Hit h{kBigT, 0.0f, 0.0f, -1, 0};
  const float ix = safe_inv(r.dx), iy = safe_inv(r.dy), iz = safe_inv(r.dz);
  const float ax = fabsf(r.dx), ay = fabsf(r.dy), az = fabsf(r.dz);
  const bool par = ax < kDirTiny || ay < kDirTiny || az < kDirTiny;
  int axis = ay > ax ? 1 : 0;
  axis = az > fmaxf(ax, ay) ? 2 : axis;
  const float sgn = axis == 0 ? r.dx : (axis == 1 ? r.dy : r.dz);
  const int* __restrict__ order = b.orders + (axis * 2 + (sgn < 0.0f)) * b.K1;
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
      mt_row(b, row, r, h);
    }
  }
  return h;
}

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
  int* rows_out;       // (R,) or null: rows that ran Moller-Trumbore
};

__global__ void spawn_kernel(SpawnArgs a) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (i >= a.R) return;
  const long long R = a.R;
  const Ray r{a.rays[i], a.rays[R + i], a.rays[2 * R + i],
              a.rays[3 * R + i], a.rays[4 * R + i], a.rays[5 * R + i]};
  const bool alive = fabsf(r.ox) < kAliveLimit;
  Hit h{kBigT, 0.0f, 0.0f, -1, 0};
  if (alive) h = traverse(a.bvh, r, kBigT);
  if (a.rows_out) a.rows_out[i] = h.rows;

  a.t_out[i] = h.t;
  if (a.uv_out) {
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

struct ShadowArgs {
  Bvh bvh;
  const float* __restrict__ rays;    // (6, NS) shadow rays, light-major
  long long NS, R;                   // NS = L * R
  const float* __restrict__ normal;  // (3, R) parent-level planes
  const float* __restrict__ color;   // (3, R)
  const float* __restrict__ view;    // (3, R) parent ray directions
  const float* __restrict__ light_color;  // (L, 3)
  float* out;                        // (3, NS) radiance per light chunk
  int* rows_out;                     // (NS,) or null
};

__global__ void shadow_shade_kernel(ShadowArgs a) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (i >= a.NS) return;
  const long long NS = a.NS, R = a.R;
  const Ray r{a.rays[i], a.rays[NS + i], a.rays[2 * NS + i],
              a.rays[3 * NS + i], a.rays[4 * NS + i], a.rays[5 * NS + i]};
  const bool alive = fabsf(r.ox) < kAliveLimit;   // hit & facing, from spawn
  Hit h{kBigT, 0.0f, 0.0f, -1, 0};
  if (alive) h = traverse(a.bvh, r, kShadowTMax);
  if (a.rows_out) a.rows_out[i] = h.rows;
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

struct ClosestArgs {
  Bvh bvh;
  const float* __restrict__ rays;    // (6, R) origin xyz, direction xyz
  long long R;
  float limit;                       // exact below it (pallas t_limit)
  const float* __restrict__ rec;     // (n_rec, ns) record planes or null
  int n_rec;
  float* t_out;     // (R,) BIG_T on a miss
  float* uv_out;    // (2, R) or null (shadow mode)
  int* slot_out;    // (R,) packed slot, -1 on a miss; or null (shadow mode)
  float* rec_out;   // (n_rec, R) winning record, 0 on a miss
  int* rows_out;    // (R,) or null: rows that ran Moller-Trumbore
};

// Generic closest hit (pallas_bvh.py:361-405, _bvh_kernel): the same walk
// as the fused kernels, the winning record taken as the spawn epilogue
// takes it.
__global__ void closest_kernel(ClosestArgs a) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (i >= a.R) return;
  const long long R = a.R;
  const Ray r{a.rays[i], a.rays[R + i], a.rays[2 * R + i],
              a.rays[3 * R + i], a.rays[4 * R + i], a.rays[5 * R + i]};
  Hit h{kBigT, 0.0f, 0.0f, -1, 0};
  if (fabsf(r.ox) < kAliveLimit) h = traverse(a.bvh, r, a.limit);
  if (a.rows_out) a.rows_out[i] = h.rows;
  a.t_out[i] = h.t;
  if (a.uv_out) {
    a.uv_out[i] = h.u;
    a.uv_out[R + i] = h.v;
  }
  if (a.slot_out) a.slot_out[i] = static_cast<int>(h.slot);
  for (int k = 0; k < a.n_rec; ++k)
    a.rec_out[k * R + i] =
        h.slot >= 0 ? __ldg(a.rec + k * a.bvh.ns + h.slot) : 0.0f;
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
    int* rows_out, int block, void* stream) {
  if (n_rec < 3 || n_rec > kMaxRec) return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0) return 0;
  SpawnArgs a{make_bvh(tri, seg, sc, orders, ns, C, S, G, K1),
              rays, R, gauss, b, lights, L, rec, n_rec,
              {lo0, lo1, lo2}, {inv0, inv1, inv2}, key_mode,
              t_out, uv_out, rec_out, shadow_out, child_out, key_out,
              rows_out};
  const long long grid = (R + block - 1) / block;
  spawn_kernel<<<static_cast<unsigned>(grid), block, 0,
                 static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rtx_bvh_shadow_shade(
    const float* rays, long long NS, long long R, const float* normal,
    const float* color, const float* view, const float* light_color,
    const float* tri, const float* seg, const float* sc, const int* orders,
    long long ns, int C, int S, int G, int K1, float* out, int* rows_out,
    int block, void* stream) {
  if (NS == 0) return 0;
  ShadowArgs a{make_bvh(tri, seg, sc, orders, ns, C, S, G, K1),
               rays, NS, R, normal, color, view, light_color, out, rows_out};
  const long long grid = (NS + block - 1) / block;
  shadow_shade_kernel<<<static_cast<unsigned>(grid), block, 0,
                        static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int rtx_bvh_closest(
    const float* rays, long long R, const float* tri, const float* seg,
    const float* sc, const int* orders, long long ns, int C, int S, int G,
    int K1, float limit, const float* rec, int n_rec, float* t_out,
    float* uv_out, int* slot_out, float* rec_out, int* rows_out, int block,
    void* stream) {
  if (n_rec < 0 || n_rec > kMaxRec || (n_rec > 0 && (!rec || !rec_out)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (R == 0) return 0;
  ClosestArgs a{make_bvh(tri, seg, sc, orders, ns, C, S, G, K1),
                rays, R, limit, rec, n_rec, t_out, uv_out, slot_out,
                rec_out, rows_out};
  const long long grid = (R + block - 1) / block;
  closest_kernel<<<static_cast<unsigned>(grid), block, 0,
                   static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
