// K1 + K2: closest-hit and any-hit walks of the 8-wide BVH, one thread per ray.
//
// Replaces the TPU kernels of ilgpu_raytracing_tpu/ops/pallas/wide_kernel.py:
//   K1 _make_closest_kernel (launched by _run_trace, pallas_call at :952)
//   K2 _make_shadow_kernel  (launched by _run_shadow, pallas_call at :1073)
// and computes what they compute: per ray, over every instance of the scene,
// world-AABB entry test, world->object transform (t transfers 1:1, no
// renormalization), an 8-wide BVH walk with octant-ordered children, and the
// exact leaf accept predicates of _leaf_tri_test_pp / _leaf_sph_test_pp
// (closest) and _leaf_tri_anyhit / _leaf_sph_anyhit (any-hit). The closest
// record is packed as prim | (inst*4 + kind) << 20, miss = -1.
//
// What bounds it on an H100: memory latency of dependent loads. A walk is a
// chain of node fetch -> slab tests -> child pick -> next node, and rays of a
// warp diverge through the tree, so most of a warp's loads go to different
// 48-float node records and 128-float leaf rows. The scene tables of the
// bench scene (614 wide nodes and about 2k leaf rows of 512 bytes, about
// 1 MB) sit in the 50 MB L2, so the walk pays L2 latency per step, not HBM
// bandwidth.
//
// What this design does about it, and what it leaves for later: the TPU
// kernel's packet shape (4096-lane tiles sharing one scalar stack, FRONT-node
// frontiers, subtile want masks, the packet's first-lane octant) answers TPU
// constraints and is not carried over. Each thread keeps its own stack in
// local memory and orders children by its OWN direction octant through
// wide_perm, testing hit leaves near-first as soon as their box is hit so
// t_best tightens early and prunes the far subtrees. Warp-coherent traversal,
// compressed nodes and persistent threads are later work.
//
// The per-thread stack is bounded on the host (7 * wide depth + 1 entries,
// passed as stack_cap); a push beyond it sets *overflow and the Python wrapper
// raises. Nodes are never dropped silently.
//
// Built with nvcc for sm_90a, without --use_fast_math: IEEE division and
// sqrt, as the slab and Moller-Trumbore math needs (approximate reciprocals
// produced distance-banded ring artifacts on the TPU).

#include <cuda_runtime.h>

namespace {

constexpr float T_EPS = 0.001f;
constexpr float T_INF = 1e30f;
constexpr int WIDTH = 8;
constexpr int MAX_STACK = 256;
constexpr int ROW = 128;        // floats per packed leaf row
constexpr int TRI_STRIDE = 12;  // v0(3) e1(3) e2(3) prim_id pad(2)
constexpr int SPH_STRIDE = 16;  // center(3) radius prim_id pad(11)
constexpr int PP_PRIM_BITS = 20;
constexpr int KIND_SPHERE = 1;
constexpr int KIND_TRI = 2;
constexpr int BLAS_TRI_MESH = 2;
constexpr int INST_I = 4;   // kind, wide root, inst_id, is_identity
constexpr int INST_F = 18;  // w2o (12), world bounds (6)
constexpr int EMPTY = -1;

struct Ray {
  float ox, oy, oz, dx, dy, dz, ix, iy, iz;
};

struct Tables {
  const float* __restrict__ wb;    // (W*48) child bounds, 8 x (bmin3 bmax3)
  const int* __restrict__ wc;      // (W*8) >=0 inner, -1 empty, <=-2 leaf
  const int* __restrict__ wp;      // (W*8) per-octant child order, 4 bits/rank
  const float* __restrict__ tri;   // (Lt*128) packed triangle leaf rows
  const float* __restrict__ sph;   // (Ls*128) packed sphere leaf rows
  int leaf_width;
  int stack_cap;
};

__device__ __forceinline__ float inv_dir(float d) {
  return 1.0f / (d != 0.0f ? d : 1e-8f);
}

__device__ __forceinline__ bool slab(const float* __restrict__ b, const Ray& r,
                                     float t_b) {
  float t1 = (b[0] - r.ox) * r.ix;
  float t2 = (b[3] - r.ox) * r.ix;
  float lo = fminf(t1, t2);
  float hi = fmaxf(t1, t2);
  t1 = (b[1] - r.oy) * r.iy;
  t2 = (b[4] - r.oy) * r.iy;
  lo = fmaxf(lo, fminf(t1, t2));
  hi = fminf(hi, fmaxf(t1, t2));
  t1 = (b[2] - r.oz) * r.iz;
  t2 = (b[5] - r.oz) * r.iz;
  lo = fmaxf(lo, fminf(t1, t2));
  hi = fminf(hi, fmaxf(t1, t2));
  lo = fmaxf(lo, T_EPS);
  return hi >= lo && lo <= t_b;
}

// Moller-Trumbore in the operation order of ops/intersect.intersect_triangle;
// returns t, or -1 when the determinant or barycentric tests reject.
__device__ __forceinline__ float tri_t(const float* __restrict__ p, const Ray& r) {
  float v0x = p[0], v0y = p[1], v0z = p[2];
  float e1x = p[3], e1y = p[4], e1z = p[5];
  float e2x = p[6], e2y = p[7], e2z = p[8];
  float px = r.dy * e2z - r.dz * e2y;
  float py = r.dz * e2x - r.dx * e2z;
  float pz = r.dx * e2y - r.dy * e2x;
  float det = e1x * px + e1y * py + e1z * pz;
  bool ok = fabsf(det) >= 1e-8f;
  float inv_det = 1.0f / (ok ? det : 1.0f);
  float tvx = r.ox - v0x, tvy = r.oy - v0y, tvz = r.oz - v0z;
  float bu = (tvx * px + tvy * py + tvz * pz) * inv_det;
  ok = ok && bu >= 0.0f && bu <= 1.0f;
  float qx = tvy * e1z - tvz * e1y;
  float qy = tvz * e1x - tvx * e1z;
  float qz = tvx * e1y - tvy * e1x;
  float bv = (r.dx * qx + r.dy * qy + r.dz * qz) * inv_det;
  ok = ok && bv >= 0.0f && bu + bv <= 1.0f;
  float t = (e2x * qx + e2y * qy + e2z * qz) * inv_det;
  return ok ? t : -1.0f;
}

// Sphere quadratic of ops/intersect.intersect_sphere: near root unless it is
// below T_EPS, then far; -1 when the discriminant is negative or r <= 0.
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

// Walk one instance's wide BVH. Closest: tightens t_best / pp. Any-hit:
// returns at the first accepting primitive with occ = true. Returns false on
// stack overflow.
template <bool ANY_HIT>
__device__ bool walk(const Tables& tb, const Ray& r, int root, bool is_tri,
                     int inst_bits, float t_limit, float& t_best, int& pp,
                     bool& occ) {
  int stack[MAX_STACK];
  int sp = 0;
  stack[sp++] = root;
  const int octant = (r.dx > 0.0f ? 4 : 0) + (r.dy > 0.0f ? 2 : 0) +
                     (r.dz > 0.0f ? 1 : 0);
  const float* __restrict__ rows = is_tri ? tb.tri : tb.sph;
  const int stride = is_tri ? TRI_STRIDE : SPH_STRIDE;
  while (sp > 0) {
    const int wid = stack[--sp];
    const unsigned perm = static_cast<unsigned>(tb.wp[wid * WIDTH + octant]);
    unsigned inner = 0;
#pragma unroll
    for (int rank = 0; rank < WIDTH; ++rank) {
      const int c8 = (perm >> (rank * 4)) & 7;
      const int child = tb.wc[wid * WIDTH + c8];
      if (child == EMPTY) continue;
      if (!slab(tb.wb + wid * 48 + c8 * 6, r, ANY_HIT ? t_limit : t_best)) continue;
      if (child >= 0) {
        inner |= 1u << rank;
        continue;
      }
      const int enc = -child - 2;
      const int count = enc & 15;
      const float* __restrict__ row = rows + static_cast<size_t>(enc >> 4) * ROW;
      for (int j = 0; j < tb.leaf_width && j < count; ++j) {
        const float* __restrict__ p = row + j * stride;
        const float t = is_tri ? tri_t(p, r) : sph_t(p, r);
        // triangles accept t > T_EPS, spheres t >= T_EPS (the TPU predicates)
        const bool above = is_tri ? (t > T_EPS) : (t >= T_EPS);
        if (ANY_HIT) {
          if (above && t < t_limit) {
            occ = true;
            return true;
          }
        } else if (above && t < t_best) {
          t_best = t;
          pp = static_cast<int>(p[is_tri ? 9 : 4]) + inst_bits;
        }
      }
    }
    // far-first pushes leave the nearest inner child on top
#pragma unroll
    for (int rank = WIDTH - 1; rank >= 0; --rank) {
      if (!((inner >> rank) & 1u)) continue;
      if (sp >= tb.stack_cap) return false;
      stack[sp++] = tb.wc[wid * WIDTH + ((perm >> (rank * 4)) & 7)];
    }
  }
  return true;
}

template <bool ANY_HIT>
__global__ void wide_kernel(const float* __restrict__ o, const float* __restrict__ d,
                            const float* __restrict__ tmax, int n, Tables tb,
                            const int* __restrict__ inst_i,
                            const float* __restrict__ inst_f, int n_inst,
                            float* __restrict__ t_out, int* __restrict__ pp_out,
                            bool* __restrict__ occ_out, int* __restrict__ overflow) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
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
  const float t_limit = tmax[i];
  float t_best = fminf(T_INF, t_limit);
  int pp = -1;
  bool occ = false;
  // a lane with t_max <= 0 is inactive: it enters no instance
  for (int k = 0; k < n_inst && t_limit > 0.0f && !occ; ++k) {
    const int* ii = inst_i + k * INST_I;
    const float* ff = inst_f + k * INST_F;
    if (!slab(ff + 12, w, ANY_HIT ? t_limit : t_best)) continue;
    Ray r = w;
    if (!ii[3]) {
      const float* m = ff;
      r.ox = m[0] * w.ox + m[1] * w.oy + m[2] * w.oz + m[3];
      r.oy = m[4] * w.ox + m[5] * w.oy + m[6] * w.oz + m[7];
      r.oz = m[8] * w.ox + m[9] * w.oy + m[10] * w.oz + m[11];
      r.dx = m[0] * w.dx + m[1] * w.dy + m[2] * w.dz;
      r.dy = m[4] * w.dx + m[5] * w.dy + m[6] * w.dz;
      r.dz = m[8] * w.dx + m[9] * w.dy + m[10] * w.dz;
      r.ix = inv_dir(r.dx);
      r.iy = inv_dir(r.dy);
      r.iz = inv_dir(r.dz);
    }
    const bool is_tri = ii[0] == BLAS_TRI_MESH;
    const int inst_bits = (ii[2] * 4 + (is_tri ? KIND_TRI : KIND_SPHERE))
                          << PP_PRIM_BITS;
    if (!walk<ANY_HIT>(tb, r, ii[1], is_tri, inst_bits, t_limit, t_best, pp, occ)) {
      atomicExch(overflow, 1);
      break;
    }
  }
  if (ANY_HIT) {
    occ_out[i] = occ;
  } else {
    t_out[i] = t_best;
    pp_out[i] = pp;
  }
}

constexpr int THREADS = 128;

}  // namespace

extern "C" {

const char* wide_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int wide_max_stack() { return MAX_STACK; }

// K1: closest hit. t_out/pp_out (n,), overflow (1,) zeroed by the caller.
int wide_trace_closest(const float* o, const float* d, const float* tmax, int n,
                       const float* wb, const int* wc, const int* wp,
                       const float* tri_rows, const float* sph_rows,
                       const int* inst_i, const float* inst_f, int n_inst,
                       int leaf_width, int stack_cap, float* t_out, int* pp_out,
                       int* overflow, void* stream) {
  Tables tb{wb, wc, wp, tri_rows, sph_rows, leaf_width, stack_cap};
  const int blocks = (n + THREADS - 1) / THREADS;
  if (blocks > 0) {
    wide_kernel<false><<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        o, d, tmax, n, tb, inst_i, inst_f, n_inst, t_out, pp_out, nullptr,
        overflow);
  }
  return static_cast<int>(cudaGetLastError());
}

// K2: any-hit occlusion within (T_EPS, tmax). occ_out (n,) bool.
int wide_trace_shadow(const float* o, const float* d, const float* tmax, int n,
                      const float* wb, const int* wc, const int* wp,
                      const float* tri_rows, const float* sph_rows,
                      const int* inst_i, const float* inst_f, int n_inst,
                      int leaf_width, int stack_cap, bool* occ_out, int* overflow,
                      void* stream) {
  Tables tb{wb, wc, wp, tri_rows, sph_rows, leaf_width, stack_cap};
  const int blocks = (n + THREADS - 1) / THREADS;
  if (blocks > 0) {
    wide_kernel<true><<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
        o, d, tmax, n, tb, inst_i, inst_f, n_inst, nullptr, nullptr, occ_out,
        overflow);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
