// K6: closest-hit and any-hit walks of the binary skip-index BVH, one thread
// per ray.
//
// Replaces the TPU kernel of ilgpu_raytracing_tpu/ops/pallas/traverse_kernel.py:
//   K6 _make_kernel (launched by _run_trace, pallas_call at :487)
// and computes what it computes: per ray, over every instance in the order of
// the scene's meta list, the world-AABB entry test on the world ray, the
// world->object transform unless the instance is the identity, the stackless
// skip-index walk (a hit inner node goes to `left`, a leaf or a miss goes to
// `skip`), and at a hit leaf the first `count` slots of its packed row tested
// with the leaf predicates of _leaf_tri_test / _leaf_sph_test, accepting only
// t < t_best. An instance whose walk lowered t_best becomes the hit's
// instance. Outputs are t, prim, inst, and the barycentrics bu/bv of the
// last triangle accepted (a later sphere hit keeps them, as on the TPU).
//
// The TPU's any-hit entry (shadow_occlusion_pallas) runs the closest kernel
// under a finite t_max and reads prim >= 0. The any-hit instantiation here
// stops at the first accepted primitive instead: a primitive with
// T_EPS < t < t_max exists exactly when the closest walk finds one, so the
// mask is the same.
//
// What bounds it on an H100: the latency of dependent loads. The skip-index
// walk visits every node on the way to each leaf one at a time (two nodes
// per binary level, against one 8-wide node per three levels in K1), each a
// 24-byte box and a 16-byte record; rays of a warp diverge through the tree.
// The bench scene's tables (about 31k nodes and 2k leaf rows, about 2 MB)
// sit in the 50 MB L2.
//
// What this design does about it: nothing beyond K1's choice of one ray per
// thread. The walk needs no stack (the skip pointers replace it), so a
// thread keeps only its ray and its best hit in registers. Leaf rows are
// compacted on the host from the TPU's 128-lane rows to 96 floats (8
// triangles of 12) and 128 floats (8 spheres of 16); a triangle slot is three
// 16-byte loads. The TPU packet shape (4096-lane tiles behind one scalar
// pointer) is not carried over.
//
// Built with nvcc for sm_90a with --fmad=false and without fast math, so t,
// bu and bv round as in the plain PyTorch version (ops/cuda/binary.py).

#include "trace_common.cuh"

namespace {

using trace::Ray;
using trace::THREADS;
using trace::Work;

constexpr int TRI_ROW = 96;   // floats per compacted triangle leaf row
constexpr int SPH_ROW = 128;  // floats per sphere leaf row
constexpr int NODE_I = 4;     // left, first_row, count, skip

struct BinaryTables {
  const float* __restrict__ nodes;  // (Nn*6) bmin3 bmax3
  const int* __restrict__ node_i;   // (Nn*4) left, first_row, count, skip
  const float* __restrict__ tri;    // (Lt*96) 8 triangles of 12 floats
  const float* __restrict__ sph;    // (Ls*128) 8 spheres of 16 floats
  int leaf_width;
};

// One instance's skip-index walk from `root`. Closest: tightens t_best,
// prim, bu, bv. Any-hit: returns true at the first accepted primitive.
template <bool ANY_HIT, bool COUNT>
__device__ bool walk(const BinaryTables& bt, const Ray& r, int root, bool is_tri,
                     float t_limit, float& t_best, int& prim, float& bu,
                     float& bv, Work& work) {
  int cur = root;
  while (cur >= 0) {
    const int* f = bt.node_i + cur * NODE_I;
    if (COUNT) ++work.boxes;
    const bool hit = trace::slab(bt.nodes + cur * 6, r, ANY_HIT ? t_limit : t_best);
    const int count = f[2];
    if (hit && count > 0) {
      const int n = min(count, bt.leaf_width);
      for (int j = 0; j < n; ++j) {
        if (COUNT) ++work.prims;
        float t, u = 0.0f, v = 0.0f;
        int id;
        if (is_tri) {
          const float4* q = reinterpret_cast<const float4*>(
              bt.tri + static_cast<size_t>(f[1]) * TRI_ROW + j * trace::TRI_STRIDE);
          const float4 a = __ldg(q), b = __ldg(q + 1), c = __ldg(q + 2);
          t = trace::tri_tuv(a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, r, u, v);
          id = static_cast<int>(c.y);
        } else {
          const float* p =
              bt.sph + static_cast<size_t>(f[1]) * SPH_ROW + j * trace::SPH_STRIDE;
          t = trace::sph_t(p, r);
          id = static_cast<int>(p[4]);
        }
        const bool above = is_tri ? (t > trace::T_EPS) : (t >= trace::T_EPS);
        if (ANY_HIT) {
          if (above && t < t_limit) return true;
        } else if (above && t < t_best) {
          t_best = t;
          prim = id;
          if (is_tri) {
            bu = u;
            bv = v;
          }
        }
      }
    }
    cur = (hit && count == 0) ? f[0] : f[3];
  }
  return false;
}

template <bool ANY_HIT, bool COUNT>
__global__ void binary_kernel(const float* __restrict__ o,
                              const float* __restrict__ d,
                              const float* __restrict__ tmax, int n,
                              BinaryTables bt, const int* __restrict__ inst_i,
                              const float* __restrict__ inst_f, int n_inst,
                              float* __restrict__ t_out, int* __restrict__ prim_out,
                              int* __restrict__ inst_out, float* __restrict__ bu_out,
                              float* __restrict__ bv_out, bool* __restrict__ occ_out,
                              unsigned long long* __restrict__ work_out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  Work work;
  const Ray w = trace::load_ray(o, d, i);
  const float t_limit = tmax[i];
  float t_best = fminf(trace::T_INF, t_limit);
  int prim = -1, inst = -1;
  float bu = 0.0f, bv = 0.0f;
  bool occ = false;
  for (int k = 0; k < n_inst && t_limit > 0.0f && !occ; ++k) {
    const int* ii = inst_i + k * trace::INST_I;
    const float* ff = inst_f + k * trace::INST_F;
    if (COUNT) ++work.boxes;
    if (!trace::slab(ff + 12, w, ANY_HIT ? t_limit : t_best)) continue;
    const Ray r = ii[3] ? w : trace::transform_ray(ff, w);
    const float before = t_best;
    occ = walk<ANY_HIT, COUNT>(bt, r, ii[1], ii[0] == trace::BLAS_TRI_MESH, t_limit,
                               t_best, prim, bu, bv, work);
    if (t_best < before) inst = ii[2];
  }
  if (ANY_HIT) {
    occ_out[i] = occ;
  } else {
    t_out[i] = t_best;
    prim_out[i] = prim;
    inst_out[i] = inst;
    bu_out[i] = bu;
    bv_out[i] = bv;
  }
  if (COUNT) {
    atomicAdd(work_out, static_cast<unsigned long long>(work.boxes));
    atomicAdd(work_out + 1, static_cast<unsigned long long>(work.prims));
  }
}

template <bool ANY_HIT>
int launch(const float* o, const float* d, const float* tmax, int n,
           const BinaryTables& bt, const int* inst_i, const float* inst_f,
           int n_inst, float* t_out, int* prim_out, int* inst_out, float* bu_out,
           float* bv_out, bool* occ_out, unsigned long long* work_out,
           void* stream) {
  const int blocks = (n + THREADS - 1) / THREADS;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (blocks > 0 && work_out != nullptr) {
    binary_kernel<ANY_HIT, true><<<blocks, THREADS, 0, s>>>(
        o, d, tmax, n, bt, inst_i, inst_f, n_inst, t_out, prim_out, inst_out,
        bu_out, bv_out, occ_out, work_out);
  } else if (blocks > 0) {
    binary_kernel<ANY_HIT, false><<<blocks, THREADS, 0, s>>>(
        o, d, tmax, n, bt, inst_i, inst_f, n_inst, t_out, prim_out, inst_out,
        bu_out, bv_out, occ_out, nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* binary_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// K6 closest hit: t/prim/inst/bu/bv (n,); work (2,) zeroed, or null for the
// kernel itself (with it, the counting variant adds boxes and primitives).
int binary_trace_closest(const float* o, const float* d, const float* tmax, int n,
                         const float* nodes, const int* node_i,
                         const float* tri_rows, const float* sph_rows,
                         const int* inst_i, const float* inst_f, int n_inst,
                         int leaf_width, float* t_out, int* prim_out,
                         int* inst_out, float* bu_out, float* bv_out,
                         unsigned long long* work, void* stream) {
  const BinaryTables bt{nodes, node_i, tri_rows, sph_rows, leaf_width};
  return launch<false>(o, d, tmax, n, bt, inst_i, inst_f, n_inst, t_out, prim_out,
                       inst_out, bu_out, bv_out, nullptr, work, stream);
}

// K6 any-hit: occlusion within (T_EPS, tmax), stopping at the first hit.
int binary_trace_shadow(const float* o, const float* d, const float* tmax, int n,
                        const float* nodes, const int* node_i,
                        const float* tri_rows, const float* sph_rows,
                        const int* inst_i, const float* inst_f, int n_inst,
                        int leaf_width, bool* occ_out, unsigned long long* work,
                        void* stream) {
  const BinaryTables bt{nodes, node_i, tri_rows, sph_rows, leaf_width};
  return launch<true>(o, d, tmax, n, bt, inst_i, inst_f, n_inst, nullptr, nullptr,
                      nullptr, nullptr, nullptr, occ_out, work, stream);
}

}  // extern "C"
