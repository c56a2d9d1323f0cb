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
// Design: one thread per ray.  The thread walks the clusters in one of
// six precomputed centroid orders, picked from its own dominant
// direction axis and sign (the TPU kernel picks it per 128-ray block
// from the block's summed direction, pallas_intersect.py:341-345), gates
// each cluster on its slab entry against min(best t, limit), and runs
// Moller-Trumbore over the C lanes of every cluster that passes.  The
// first lane keeps a tie within a cluster and a cluster wins only on a
// strict '<' (pallas_intersect.py:274-286).  Walk order changes only the
// speed: the closest t below the limit is exact in any order (the TPU
// kernel's block-wide gate lets through a superset of this per-ray
// gate); only an exact-t tie across clusters may pick another triangle.
//
// Semantics kept from the TPU kernel that differ from the BVH walk:
// - directions are inverted raw (1/d, pallas_intersect.py:198), so a
//   zero component gives +-inf, and an origin on that box plane gives
//   0 * inf = NaN.  jnp.minimum/maximum propagate NaN and every
//   comparison with it is false, so that cluster is culled for that ray.
//   CUDA's fminf/fmaxf drop a NaN operand instead, so the slab test here
//   uses min_nan/max_nan, which propagate it.  The TPU kernel then still
//   runs the cluster's Moller-Trumbore pass for the whole 128-ray block
//   when another ray of the block enters it, so there the cull bites
//   only when no ray of the block does; here it bites per ray, and the
//   plain version (cluster_closest_plain) culls the same pairs;
// - acceptance is the chain u >= 0, u <= 1, v >= 0, u + v <= 1, t >= 0
//   (pallas_intersect.py:270-271), equal to the BVH kernels' one sign
//   test (tests/test_torch_intersect.py holds the two equal).
//
// What bounds it on an H100: the Moller-Trumbore arithmetic (54 f32
// operations per ray-triangle test, the C = 128 lanes of every cluster
// that passes the gate) against the card's f32 issue rate, about 33.5 T
// instructions/s with nothing contracted (see below).  Ray I/O is about
// 40 bytes a ray and the triangle planes (9 x K*C floats, 0.72 MB for
// thai2 at C = 128) stay in L2, read with __ldg.  This first version
// spends nothing on the bound beyond the cluster gate: warps diverge
// between clusters and every lane is reloaded per thread.
//
// Built with --fmad=false (no contraction of a*b+c), so each operation
// rounds on its own, as in the plain PyTorch version in
// ops/cuda_cluster.py.  The entry point launches on the caller's stream,
// allocates nothing and returns cudaGetLastError() (0 on success).

#include <cuda_runtime.h>

namespace {

constexpr float kBigT = 3.0e38f;              // core/intersect.py BIG_T
constexpr float kF32Eps = 1.1920929e-07f;     // f32::EPSILON
constexpr float kAliveLimit = 1.0e30f;        // |ox| >= this: dead ray

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

struct Hit {
  float t, u, v;
  long long slot;  // packed slot of the winning lane, -1 on a miss
  int clusters;    // clusters that ran Moller-Trumbore (work counter)
};

// jnp.minimum / jnp.maximum: a NaN operand gives NaN.
__device__ __forceinline__ float min_nan(float a, float b) {
  return (a < b || a != a) ? a : b;
}
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// Slab entry distance of a cluster box; BIG_T when the ray misses it, the
// box lies behind, or a NaN arises (pallas_intersect.py:223-234).
__device__ __forceinline__ float slab_entry(const float* __restrict__ box,
                                            const Ray& r, float ix, float iy,
                                            float iz) {
  const float4 lo = __ldg(reinterpret_cast<const float4*>(box));
  const float4 hi = __ldg(reinterpret_cast<const float4*>(box) + 1);
  const float tx1 = (lo.x - r.ox) * ix, tx2 = (lo.w - r.ox) * ix;
  const float ty1 = (lo.y - r.oy) * iy, ty2 = (hi.x - r.oy) * iy;
  const float tz1 = (lo.z - r.oz) * iz, tz2 = (hi.y - r.oz) * iz;
  const float tmin = max_nan(max_nan(min_nan(tx1, tx2), min_nan(ty1, ty2)),
                             min_nan(tz1, tz2));
  const float tmax = min_nan(min_nan(max_nan(tx1, tx2), max_nan(ty1, ty2)),
                             max_nan(tz1, tz2));
  return (tmax >= tmin && tmax > 0.0f) ? tmin : kBigT;
}

// Moller-Trumbore of one ray against the C lanes of cluster kk
// (pallas_intersect.py:256-286).
__device__ __forceinline__ void mt_cluster(const Grid& g, int kk, const Ray& r,
                                           Hit& h) {
  const float* __restrict__ T = g.tri;
  const long long ns = g.ns;
  const long long base = static_cast<long long>(kk) * g.C;
  for (int j = 0; j < g.C; ++j) {
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
    const bool ok = non_par && uu >= 0.0f && uu <= 1.0f && vv >= 0.0f &&
                    uu + vv <= 1.0f && tt >= 0.0f;
    if (ok && tt < h.t) {
      h.t = tt;
      h.u = uu;
      h.v = vv;
      h.slot = s;
    }
  }
}

struct ClosestArgs {
  Grid grid;
  const float* __restrict__ rays;  // (6, R) origin xyz, direction xyz
  long long R;
  float limit;
  float* t_out;     // (R,) BIG_T on a miss
  float* uv_out;    // (2, R), 0 on a miss
  int* slot_out;    // (R,) packed slot, -1 on a miss
  int* rows_out;    // (R,) or null: clusters that ran Moller-Trumbore
};

__global__ void cluster_closest_kernel(ClosestArgs a) {
  const long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x;
  if (i >= a.R) return;
  const long long R = a.R;
  const Ray r{a.rays[i], a.rays[R + i], a.rays[2 * R + i],
              a.rays[3 * R + i], a.rays[4 * R + i], a.rays[5 * R + i]};
  Hit h{kBigT, 0.0f, 0.0f, -1, 0};
  if (fabsf(r.ox) < kAliveLimit) {
    const Grid& g = a.grid;
    const float ix = 1.0f / r.dx, iy = 1.0f / r.dy, iz = 1.0f / r.dz;
    const float ax = fabsf(r.dx), ay = fabsf(r.dy), az = fabsf(r.dz);
    int axis = ay > ax ? 1 : 0;
    axis = az > fmaxf(ax, ay) ? 2 : axis;
    const float sgn = axis == 0 ? r.dx : (axis == 1 ? r.dy : r.dz);
    const int* __restrict__ order = g.orders + (axis * 2 + (sgn < 0.0f)) * g.K;
    for (int k = 0; k < g.K; ++k) {
      const int kk = __ldg(order + k);
      if (!(slab_entry(g.aabb + 8LL * kk, r, ix, iy, iz) <
            fminf(h.t, a.limit)))
        continue;
      ++h.clusters;
      mt_cluster(g, kk, r, h);
    }
  }
  if (a.rows_out) a.rows_out[i] = h.clusters;
  a.t_out[i] = h.t;
  a.uv_out[i] = h.u;
  a.uv_out[R + i] = h.v;
  a.slot_out[i] = static_cast<int>(h.slot);
}

}  // namespace

extern "C" int rtx_cluster_closest(
    const float* rays, long long R, const float* tri, const float* aabb,
    const int* orders, long long ns, int C, int K, float limit, float* t_out,
    float* uv_out, int* slot_out, int* rows_out, int block, void* stream) {
  if (R == 0) return 0;
  ClosestArgs a{Grid{tri, aabb, orders, ns, C, K}, rays, R, limit, t_out,
                uv_out, slot_out, rows_out};
  const long long grid = (R + block - 1) / block;
  cluster_closest_kernel<<<static_cast<unsigned>(grid), block, 0,
                           static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}
