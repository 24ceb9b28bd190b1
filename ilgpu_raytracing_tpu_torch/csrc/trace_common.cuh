// Device code shared by the trace kernels: the wide kernels K1/K2
// (wide_trace.cu), the streaming kernels K4/K5 (stream_trace.cu), the binary
// kernel K6 (binary_trace.cu) and the treelet kernels K7/K8
// (treelet_trace.cu, streamtreelet_trace.cu): the ray record, the slab test,
// the Moller-Trumbore and sphere predicates in the operation order of
// ops/intersect.py, the leaf-row test, the per-ray loop over instances
// (world-AABB entry, world->object transform, packed closest-hit record) and
// the per-lane loop over a treelet want mask.
//
// Each 8-wide kernel supplies a walker (NodeGroupWalker of node_walk.cuh
// over the reader of wide_nodes.cuh or stream_nodes.cuh), a struct with
//   template <bool ANY_HIT, bool COUNT> __device__ void walk(const Ray&,
//       int root, bool is_tri, int inst_bits, float t_limit, float& t_best,
//       int& pp, bool& occ, Work& work, int* stack) const;
//   size_t smem_bytes() const;
// that walks one 8-wide BVH from `root`. `stack` is the thread's column of
// the block's dynamic shared memory (entry e at stack[e * THREADS]), of
// smem_bytes() a block.
//
// The host proves every stack bound (the wide depth of the tables). A walk
// that would pass it fails a device-side assert, so a launch never reads a
// flag back: the next synchronizing call raises, as PyTorch's index kernels
// do.
//
// COUNT = true builds the counting variant: the same walk, which also tallies
// the boxes and primitives it tests and adds them to a launch-wide total.
// It exists to compute the kernels' operation bound (chip_smoke.py); the
// frame never launches it.
//
// Compiled with --fmad=false and without fast math: every product and sum
// rounds as in the plain PyTorch versions, so t is bit-identical to them.

#pragma once

#include <cassert>
#include <cuda_runtime.h>

namespace trace {

constexpr float T_EPS = 0.001f;
constexpr float T_INF = 1e30f;
constexpr int WIDTH = 8;
constexpr int ROW = 128;        // floats per packed leaf row
constexpr int ROW_SLOTS = 8;    // primitives per leaf row
constexpr int TRI_STRIDE = 12;  // v0(3) e1(3) e2(3) prim_id pad(2)
constexpr int SPH_STRIDE = 16;  // center(3) radius prim_id pad(11)
constexpr int KIND_SPHERE = 1;
constexpr int KIND_TRI = 2;
constexpr int BLAS_TRI_MESH = 2;
constexpr int INST_I = 4;   // kind, wide root, inst_id, is_identity
constexpr int INST_F = 18;  // w2o (12), world bounds (6)
constexpr int EMPTY = -1;
constexpr int THREADS = 128;
constexpr int MAX_DEPTH = 36;  // node-group stack entries a thread may use

// The block's dynamic shared memory as int, for a walk's stack of at most
// `entries` entries a thread. The host build (ops/cuda/host_check.py) runs
// one thread at a time and takes a static array of the most any launch
// asks for.
#ifdef __CUDACC__
#define TRACE_SHARED_STACK_OF(name, entries) extern __shared__ int name[]
#else
#define TRACE_SHARED_STACK_OF(name, entries) static int name[(entries) * THREADS]
#endif
#define TRACE_SHARED_STACK(name) TRACE_SHARED_STACK_OF(name, MAX_DEPTH)

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
};

// boxes and primitives one ray tested (counting variant only)
struct Work {
  unsigned boxes = 0;
  unsigned prims = 0;
};

__device__ __forceinline__ float inv_dir(float d) {
  return 1.0f / (d != 0.0f ? d : 1e-8f);
}

__device__ __forceinline__ bool slab6(float x0, float y0, float z0, float x1,
                                      float y1, float z1, const Ray& r,
                                      float t_b) {
  float t1 = (x0 - r.ox) * r.ix;
  float t2 = (x1 - r.ox) * r.ix;
  float lo = fminf(t1, t2);
  float hi = fmaxf(t1, t2);
  t1 = (y0 - r.oy) * r.iy;
  t2 = (y1 - r.oy) * r.iy;
  lo = fmaxf(lo, fminf(t1, t2));
  hi = fminf(hi, fmaxf(t1, t2));
  t1 = (z0 - r.oz) * r.iz;
  t2 = (z1 - r.oz) * r.iz;
  lo = fmaxf(lo, fminf(t1, t2));
  hi = fminf(hi, fmaxf(t1, t2));
  lo = fmaxf(lo, T_EPS);
  return hi >= lo && lo <= t_b;
}

__device__ __forceinline__ bool slab(const float* __restrict__ b, const Ray& r,
                                     float t_b) {
  return slab6(b[0], b[1], b[2], b[3], b[4], b[5], r, t_b);
}

// Word j (0..7) of the pair of 16-byte words (a, b), by selects: a dynamic
// index into a register array would go through local memory.
__device__ __forceinline__ int word_of(const int4& a, const int4& b, int j) {
  const int4 v = j < 4 ? a : b;
  const int k = j & 3;
  return k == 0 ? v.x : (k == 1 ? v.y : (k == 2 ? v.z : v.w));
}

// Moller-Trumbore in the operation order of ops/intersect.intersect_triangle;
// returns t with the barycentrics in bu/bv, or -1 when the determinant or
// barycentric tests reject (an all-zero padding slot has det == 0 and is
// rejected).
__device__ __forceinline__ float tri_tuv(float v0x, float v0y, float v0z,
                                         float e1x, float e1y, float e1z,
                                         float e2x, float e2y, float e2z,
                                         const Ray& r, float& bu, float& bv) {
  float px = r.dy * e2z - r.dz * e2y;
  float py = r.dz * e2x - r.dx * e2z;
  float pz = r.dx * e2y - r.dy * e2x;
  float det = e1x * px + e1y * py + e1z * pz;
  bool ok = fabsf(det) >= 1e-8f;
  float inv_det = 1.0f / (ok ? det : 1.0f);
  float tvx = r.ox - v0x, tvy = r.oy - v0y, tvz = r.oz - v0z;
  bu = (tvx * px + tvy * py + tvz * pz) * inv_det;
  ok = ok && bu >= 0.0f && bu <= 1.0f;
  float qx = tvy * e1z - tvz * e1y;
  float qy = tvz * e1x - tvx * e1z;
  float qz = tvx * e1y - tvy * e1x;
  bv = (r.dx * qx + r.dy * qy + r.dz * qz) * inv_det;
  ok = ok && bv >= 0.0f && bu + bv <= 1.0f;
  float t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
  return ok ? t : -1.0f;
}

__device__ __forceinline__ float tri_t(float v0x, float v0y, float v0z,
                                       float e1x, float e1y, float e1z,
                                       float e2x, float e2y, float e2z,
                                       const Ray& r) {
  float bu, bv;
  return tri_tuv(v0x, v0y, v0z, e1x, e1y, e1z, e2x, e2y, e2z, r, bu, bv);
}

// Sphere quadratic of ops/intersect.intersect_sphere: near root unless it is
// below T_EPS, then far; -1 when the discriminant is negative or r <= 0 (an
// all-zero padding slot has r == 0 and is rejected).
__device__ __forceinline__ float sph_t(const float* __restrict__ p, const Ray& r) {
  float rad = p[3];
  float ocx = r.ox - p[0], ocy = r.oy - p[1], ocz = r.oz - p[2];
  float a = r.dx * r.dx + r.dy * r.dy + r.dz * r.dz;
  float b = 2.0f * (ocx * r.dx + ocy * r.dy + ocz * r.dz);
  float c = ocx * ocx + ocy * ocy + ocz * ocz - rad * rad;
  float disc = b * b - 4.0f * a * c;
  float sq = sqrtf(fmaxf(disc, 0.0f));
  float inv2a = 1.0f / (2.0f * a);
  float t0 = (-b - sq) * inv2a;
  float t1 = (-b + sq) * inv2a;
  float t = t0 >= T_EPS ? t0 : t1;
  return (disc >= 0.0f && rad > 0.0f) ? t : -1.0f;
}

// Test the first `n` slots of one packed leaf row. Closest: tightens t_best
// and pp. Any-hit: returns true at the first accepting primitive. Triangles
// accept t > T_EPS, spheres t >= T_EPS (the TPU leaf predicates).
template <bool ANY_HIT, bool COUNT>
__device__ __forceinline__ bool test_row(const float* __restrict__ row, int n,
                                         bool is_tri, const Ray& r,
                                         int inst_bits, float t_limit,
                                         float& t_best, int& pp, Work& work) {
  for (int j = 0; j < n; ++j) {
    if (COUNT) ++work.prims;
    float t;
    int id;
    if (is_tri) {
      // a 48-byte slot is three aligned 16-byte loads
      const float4* q = reinterpret_cast<const float4*>(row + j * TRI_STRIDE);
      const float4 a = __ldg(q), b = __ldg(q + 1), c = __ldg(q + 2);
      t = tri_t(a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, r);
      id = static_cast<int>(c.y);
    } else {
      const float* p = row + j * SPH_STRIDE;
      t = sph_t(p, r);
      id = static_cast<int>(p[4]);
    }
    const bool above = is_tri ? (t > T_EPS) : (t >= T_EPS);
    if (ANY_HIT) {
      if (above && t < t_limit) return true;
    } else if (above && t < t_best) {
      t_best = t;
      pp = id + inst_bits;
    }
  }
  return false;
}

// Ray i of (N,3) origins and directions, with its inverse directions.
__device__ __forceinline__ Ray load_ray(const float* __restrict__ o,
                                        const float* __restrict__ d, int i) {
  Ray w;
  w.ox = o[3 * i];
  w.oy = o[3 * i + 1];
  w.oz = o[3 * i + 2];
  w.dx = d[3 * i];
  w.dy = d[3 * i + 1];
  w.dz = d[3 * i + 2];
  w.ix = inv_dir(w.dx);
  w.iy = inv_dir(w.dy);
  w.iz = inv_dir(w.dz);
  return w;
}

// The world ray in object space under the 3x4 world->object affine m (the
// unnormalized linear part: t transfers 1:1).
__device__ __forceinline__ Ray transform_ray(const float* __restrict__ m,
                                             const Ray& w) {
  Ray r;
  r.ox = m[0] * w.ox + m[1] * w.oy + m[2] * w.oz + m[3];
  r.oy = m[4] * w.ox + m[5] * w.oy + m[6] * w.oz + m[7];
  r.oz = m[8] * w.ox + m[9] * w.oy + m[10] * w.oz + m[11];
  r.dx = m[0] * w.dx + m[1] * w.dy + m[2] * w.dz;
  r.dy = m[4] * w.dx + m[5] * w.dy + m[6] * w.dz;
  r.dz = m[8] * w.dx + m[9] * w.dy + m[10] * w.dz;
  r.ix = inv_dir(r.dx);
  r.iy = inv_dir(r.dy);
  r.iz = inv_dir(r.dz);
  return r;
}

// One ray over every instance of the scene: world-AABB entry test, then the
// walker on the instance's BLAS in object space (t transfers 1:1, no
// renormalization). A lane with t_max <= 0 is inactive and enters nothing.
template <bool ANY_HIT, bool COUNT, class Walker>
__device__ void trace_ray(const Walker& wk, int i, const float* __restrict__ o,
                          const float* __restrict__ d,
                          const float* __restrict__ tmax,
                          const int* __restrict__ inst_i,
                          const float* __restrict__ inst_f, int n_inst,
                          int prim_bits, float* __restrict__ t_out,
                          int* __restrict__ pp_out, bool* __restrict__ occ_out,
                          unsigned long long* __restrict__ work_out, int* stack) {
  Work work;
  const Ray w = load_ray(o, d, i);
  const float t_limit = tmax[i];
  float t_best = fminf(T_INF, t_limit);
  int pp = -1;
  bool occ = false;
  for (int k = 0; k < n_inst && t_limit > 0.0f && !occ; ++k) {
    const int* ii = inst_i + k * INST_I;
    const float* ff = inst_f + k * INST_F;
    if (COUNT) ++work.boxes;
    if (!slab(ff + 12, w, ANY_HIT ? t_limit : t_best)) continue;
    const Ray r = ii[3] ? w : transform_ray(ff, w);
    const bool is_tri = ii[0] == BLAS_TRI_MESH;
    const int inst_bits = (ii[2] * 4 + (is_tri ? KIND_TRI : KIND_SPHERE))
                          << prim_bits;
    wk.template walk<ANY_HIT, COUNT>(r, ii[1], is_tri, inst_bits, t_limit, t_best,
                                     pp, occ, work, stack);
  }
  if (ANY_HIT) {
    occ_out[i] = occ;
  } else {
    t_out[i] = t_best;
    pp_out[i] = pp;
  }
  if (COUNT) {
    atomicAdd(work_out, static_cast<unsigned long long>(work.boxes));
    atomicAdd(work_out + 1, static_cast<unsigned long long>(work.prims));
  }
}

// One thread per ray.
template <bool ANY_HIT, bool COUNT, class Walker>
__global__ void trace_kernel(const float* __restrict__ o,
                             const float* __restrict__ d,
                             const float* __restrict__ tmax, int n, Walker wk,
                             const int* __restrict__ inst_i,
                             const float* __restrict__ inst_f, int n_inst,
                             int prim_bits, float* __restrict__ t_out,
                             int* __restrict__ pp_out,
                             bool* __restrict__ occ_out,
                             unsigned long long* __restrict__ work_out) {
  TRACE_SHARED_STACK(stack_mem);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  trace_ray<ANY_HIT, COUNT>(wk, i, o, d, tmax, inst_i, inst_f, n_inst,
                            prim_bits, t_out, pp_out, occ_out, work_out,
                            stack_mem + threadIdx.x);
}

// Launch on `stream`: the counting variant when work_out (2 zeroed u64:
// boxes, primitives) is given, the kernel itself otherwise. Returns
// cudaGetLastError().
template <bool ANY_HIT, class Walker>
int launch_trace(const float* o, const float* d, const float* tmax, int n,
                 const Walker& wk, const int* inst_i, const float* inst_f,
                 int n_inst, int prim_bits, float* t_out, int* pp_out,
                 bool* occ_out, unsigned long long* work_out, void* stream) {
  const int blocks = (n + THREADS - 1) / THREADS;
  const size_t smem = wk.smem_bytes();
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (blocks > 0 && work_out != nullptr) {
    trace_kernel<ANY_HIT, true, Walker><<<blocks, THREADS, smem, s>>>(
        o, d, tmax, n, wk, inst_i, inst_f, n_inst, prim_bits, t_out, pp_out,
        occ_out, work_out);
  } else if (blocks > 0) {
    trace_kernel<ANY_HIT, false, Walker><<<blocks, THREADS, smem, s>>>(
        o, d, tmax, n, wk, inst_i, inst_f, n_inst, prim_bits, t_out, pp_out,
        occ_out, nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}

// One lane of a treelet round (K7, K8): the lane's packet is
// i / lanes_per_packet, and the lane walks every treelet k whose bit is set
// in that packet's want mask, in increasing k, from t_root[k] with treelet
// k's instance encoding t_inst[k] (inst_id * 4 + kind) and, unless every
// instance is the identity, its world->object affine t_w2o[12k..]. t_best
// runs across the treelets from the lane's t_max; pp stays -1 unless a hit
// below t_max is found.
template <bool COUNT, class Walker>
__global__ void treelet_kernel(const float* __restrict__ o,
                               const float* __restrict__ d,
                               const float* __restrict__ tmax, int n,
                               Walker wk, const int* __restrict__ mask,
                               int lanes_per_packet,
                               const int* __restrict__ t_root,
                               const int* __restrict__ t_inst,
                               const float* __restrict__ t_w2o,
                               int n_treelets, int all_identity, int prim_bits,
                               float* __restrict__ t_out,
                               int* __restrict__ pp_out,
                               unsigned long long* __restrict__ work_out) {
  TRACE_SHARED_STACK(stack_mem);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Work work;
  const Ray w = load_ray(o, d, i);
  const float t_limit = tmax[i];
  float t_best = fminf(T_INF, t_limit);
  int pp = -1;
  bool occ = false;
  const unsigned want =
      t_limit > 0.0f ? static_cast<unsigned>(mask[i / lanes_per_packet]) : 0u;
  for (int k = 0; k < n_treelets; ++k) {
    if (!((want >> k) & 1u) || t_root[k] < 0) continue;
    const int inst_enc = t_inst[k];
    const Ray r = all_identity ? w : transform_ray(t_w2o + 12 * k, w);
    wk.template walk<false, COUNT>(r, t_root[k], (inst_enc & 3) == KIND_TRI,
                                   inst_enc << prim_bits, t_limit, t_best, pp, occ,
                                   work, stack_mem + threadIdx.x);
  }
  t_out[i] = t_best;
  pp_out[i] = pp;
  if (COUNT) {
    atomicAdd(work_out, static_cast<unsigned long long>(work.boxes));
    atomicAdd(work_out + 1, static_cast<unsigned long long>(work.prims));
  }
}

// Launch a treelet round on `stream` (the counting variant when work_out is
// given). Returns cudaGetLastError().
template <class Walker>
int launch_treelets(const float* o, const float* d, const float* tmax, int n,
                    const Walker& wk, const int* mask, int lanes_per_packet,
                    const int* t_root, const int* t_inst, const float* t_w2o,
                    int n_treelets, int all_identity, int prim_bits,
                    float* t_out, int* pp_out, unsigned long long* work_out,
                    void* stream) {
  const int blocks = (n + THREADS - 1) / THREADS;
  const size_t smem = wk.smem_bytes();
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (blocks > 0 && work_out != nullptr) {
    treelet_kernel<true, Walker><<<blocks, THREADS, smem, s>>>(
        o, d, tmax, n, wk, mask, lanes_per_packet, t_root, t_inst, t_w2o,
        n_treelets, all_identity, prim_bits, t_out, pp_out, work_out);
  } else if (blocks > 0) {
    treelet_kernel<false, Walker><<<blocks, THREADS, smem, s>>>(
        o, d, tmax, n, wk, mask, lanes_per_packet, t_root, t_inst, t_w2o,
        n_treelets, all_identity, prim_bits, t_out, pp_out, nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace trace
