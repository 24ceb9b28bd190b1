// K6: closest-hit and any-hit walks of the binary BVH, one thread per ray.
//
// Replaces the TPU kernel of ilgpu_raytracing_tpu/ops/pallas/traverse_kernel.py:
//   K6 _make_kernel (launched by _run_trace, pallas_call at :487)
// and computes what it computes: per ray, over every instance in the order of
// the scene's meta list, the world-AABB entry test on the world ray, the
// world->object transform unless the instance is the identity, the walk of
// the instance's binary BVH in the order of the TPU's stackless skip-index
// walk (a hit inner node goes to `left`, a leaf or a miss goes to `skip`),
// and at a hit leaf the first `count` slots of its packed row tested with
// the leaf predicates of _leaf_tri_test / _leaf_sph_test, accepting only
// t < t_best. An instance whose walk lowered t_best becomes the hit's
// instance. Outputs are t, prim, inst, and the barycentrics bu/bv of the
// last triangle accepted (a later sphere hit keeps them, as on the TPU).
//
// The TPU's any-hit entry (shadow_occlusion_pallas) runs the closest kernel
// under a finite t_max and reads prim >= 0. The any-hit walk here stops at
// the first accepted primitive instead: a primitive with T_EPS < t < t_max
// exists exactly when the closest walk finds one, so the mask is the same.
//
// What bounds it on an H100: the latency of dependent loads. A walk is a
// chain of node fetch -> box tests -> next node, two binary levels for each
// 8-wide level of K1, and the rays of a warp diverge through the tree. The
// bench scene's tables (about 1.4 MB) sit in the 50 MB L2, so each step pays
// an L2 round trip, not HBM bandwidth.
//
// What this design does about it (Aila & Laine, HPG 2009):
// - one 64-byte child-pair record per inner node, built on the host
//   (ops/cuda/binary.pair_records): both children's boxes and child words,
//   read with four 16-byte loads. A visit tests both children, so a
//   round trip buys two box tests, and no separate record is read after
//   the box;
// - a stack of pending second children in the block's dynamic shared
//   memory (entry e of a thread at stack[e * THREADS]), one entry a level
//   of the deepest root-to-leaf path, which the host proves; a deeper walk
//   fails a device-side assert and nothing is read back. The stack holds
//   up to 454 levels: the 227 KB of shared memory a block of sm_90 may
//   opt in to, over 128 threads of 4-byte entries; the launch opts in
//   when a tree needs more than the default 48 KB (96 levels);
// - one 32-byte root record per instance (the root's box and child word),
//   so the walk reads no table but the records, the leaf rows and the
//   instance tables;
// - a lane visits inner nodes until its next node is a leaf, then the lanes
//   of a warp test leaves together (the while-while loop) where the
//   skip walk tested each leaf inside its node loop and idled the lanes
//   that met none.
//
// Exactness of the closest walk. A tie in t goes to the primitive tested
// first (t < t_best), so the walk keeps the skip walk's order: the left
// subtree before the right, always. A visit tests both children against
// its t_best, descends into the first if it was hit and pushes the second
// if it was hit too; a popped second child is tested again against the
// t_best that the left subtree's leaves tightened, which is the test the
// skip walk makes when it arrives there. So the walk tests the same boxes
// and the same leaves in the same order, and t, prim, inst, bu, bv equal
// the skip walk's (ops/cuda/binary._walk_plain) bit for bit. The any-hit
// walk pays for no order: an OR over primitives has none, and with nothing
// to tighten a pushed child needs no second test, so its stack holds child
// words. It visits in slot order, which measured faster than nearer entry
// first.
//
// The counting variant counts the skip walk's work: each box once, when
// the skip walk would test it (the instance box, the root box, a child's
// box at its parent's visit), and each primitive tested. A closest walk
// reaches every child of a hit node, so it counts both children at the
// visit. An any-hit walk ends at its first hit and reaches a second child
// only after the first child's subtree, so its counting variant pushes
// the record of every node whose first child was hit and counts the
// second child's box when it pops it.
//
// Leaf rows are compacted on the host from the TPU's 128-lane rows to 96
// floats (8 triangles of 12) and 128 floats (8 spheres of 16); a triangle
// slot is three 16-byte loads. The TPU packet shape (4096-lane tiles behind
// one scalar pointer) is not carried over. A pointer chase has no tile for
// TMA or wgmma to move or multiply.
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
constexpr int SHARED_DEFAULT = 48 * 1024;  // dynamic shared bytes without opting in
constexpr int SHARED_OPTIN = 227 * 1024;   // the most a block of sm_90 may opt in to
// stack entries a thread may use: 454
constexpr int BINARY_MAX_DEPTH = SHARED_OPTIN / (THREADS * static_cast<int>(sizeof(int)));

// A child or root as two 16-byte words: (lo.x, lo.y, lo.z, hi.x) and
// (hi.y, hi.z, child word, 0). A child word is a record index (>= 0) or a
// leaf ~(first_row << 3 | count - 1).
struct BinaryTables {
  const int4* __restrict__ pairs;  // (Ni*4) child-pair records: child c at 2c, 2c + 1
  const int4* __restrict__ roots;  // (n_inst*2) each instance's root
  const float* __restrict__ tri;   // (Lt*96) 8 triangles of 12 floats
  const float* __restrict__ sph;   // (Ls*128) 8 spheres of 16 floats
  int leaf_width;
  int depth_cap;  // the host's bound on the stack entries a walk needs
};

// The slab test of one child's box, given the two words that hold it.
__device__ __forceinline__ bool child_hit(const int4& a, const int4& b, const Ray& r,
                                          float t_b) {
  return trace::slab6(__int_as_float(a.x), __int_as_float(a.y), __int_as_float(a.z),
                      __int_as_float(a.w), __int_as_float(b.x), __int_as_float(b.y), r,
                      t_b);
}

// The slots of leaf `word`. Closest: tightens t_best, prim, bu, bv.
// Any-hit: returns true at the first primitive accepted below t_limit.
template <bool ANY_HIT, bool COUNT>
__device__ __forceinline__ bool test_leaf(const BinaryTables& bt, int word, bool is_tri,
                                          const Ray& r, float t_limit, float& t_best,
                                          int& prim, float& bu, float& bv, Work& work) {
  const int x = ~word;
  const int n = min((x & 7) + 1, bt.leaf_width);
  const size_t row = static_cast<size_t>(x >> 3);
  for (int j = 0; j < n; ++j) {
    if (COUNT) ++work.prims;
    float t, u = 0.0f, v = 0.0f;
    int id;
    if (is_tri) {
      const float4* q =
          reinterpret_cast<const float4*>(bt.tri + row * TRI_ROW + j * trace::TRI_STRIDE);
      const float4 a = __ldg(q), b = __ldg(q + 1), c = __ldg(q + 2);
      t = trace::tri_tuv(a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w, c.x, r, u, v);
      id = static_cast<int>(c.y);
    } else {
      const float* p = bt.sph + row * SPH_ROW + j * trace::SPH_STRIDE;
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
  return false;
}

// The walk of one instance's BVH from its root's child word (the root's box
// already hit). Closest: tightens t_best, prim, bu, bv. Any-hit: returns
// true at the first accepted primitive. `stack` is this thread's column of
// the block's stack: the record index of each node whose second child is
// pending (re-tested on its pop), or for the any-hit kernel the child word.
template <bool ANY_HIT, bool COUNT>
__device__ bool walk(const BinaryTables& bt, const Ray& r, int root, bool is_tri,
                     float t_limit, float& t_best, int& prim, float& bu, float& bv,
                     int* stack, Work& work) {
  constexpr bool BY_RECORD = !ANY_HIT || COUNT;
  int node = root >= 0 ? root : -1;  // the inner node to visit next; -1 none
  int leaf = root < 0 ? root : 0;    // the leaf to test next; 0 none
  int sp = 0;
  for (;;) {
    // visit inner nodes until this lane has a leaf to test or none is left
    while (leaf == 0) {
      const float t_b = ANY_HIT ? t_limit : t_best;
      int word;
      if (node >= 0) {
        const int4* q = bt.pairs + 4 * node;
        const int4 a0 = __ldg(q), b0 = __ldg(q + 1), a1 = __ldg(q + 2),
                   b1 = __ldg(q + 3);
        const bool h0 = child_hit(a0, b0, r, t_b);
        const bool h1 = child_hit(a1, b1, r, t_b);
        // the any-hit count takes the second child's box when it pops it
        const bool defer = ANY_HIT && COUNT && h0;
        if (COUNT) work.boxes += defer ? 1 : 2;
        if (h0 && (h1 || defer)) {
          if (sp >= bt.depth_cap) {  // the host's bound (the depth) was wrong
            assert(false && "binary walk: node stack overflow");
            return false;
          }
          stack[sp++ * THREADS] = BY_RECORD ? node : b1.z;
        }
        if (!h0 && !h1) {
          node = -1;
          continue;
        }
        word = h0 ? b0.z : b1.z;
      } else {  // the second child of the deepest pending node
        if (sp == 0) return false;
        word = stack[--sp * THREADS];
        if (BY_RECORD) {
          const int4* q = bt.pairs + 4 * word + 2;
          const int4 a1 = __ldg(q), b1 = __ldg(q + 1);
          if (ANY_HIT && COUNT) ++work.boxes;  // the deferred count
          if (!child_hit(a1, b1, r, t_b)) continue;  // closest: tightened since the push
          word = b1.z;
        }
      }
      if (word >= 0) {
        node = word;
      } else {
        node = -1;
        leaf = word;
      }
    }
    if (test_leaf<ANY_HIT, COUNT>(bt, leaf, is_tri, r, t_limit, t_best, prim, bu, bv,
                                  work)) {
      return true;
    }
    leaf = 0;
  }
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
  TRACE_SHARED_STACK_OF(stack_mem, BINARY_MAX_DEPTH);
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  int* stack = stack_mem + threadIdx.x;
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
    const int4 a = __ldg(bt.roots + 2 * k), b = __ldg(bt.roots + 2 * k + 1);
    if (COUNT) ++work.boxes;
    if (!child_hit(a, b, r, ANY_HIT ? t_limit : t_best)) continue;
    const float before = t_best;
    occ = walk<ANY_HIT, COUNT>(bt, r, b.z, ii[0] == trace::BLAS_TRI_MESH, t_limit,
                               t_best, prim, bu, bv, stack, work);
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
           const BinaryTables& bt, const int* inst_i, const float* inst_f, int n_inst,
           float* t_out, int* prim_out, int* inst_out, float* bu_out, float* bv_out,
           bool* occ_out, unsigned long long* work_out, void* stream) {
  const int blocks = (n + THREADS - 1) / THREADS;
  const int smem =
      static_cast<int>(sizeof(int)) * THREADS * (bt.depth_cap > 0 ? bt.depth_cap : 1);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (blocks > 0 && work_out != nullptr) {
    if (smem > SHARED_DEFAULT) {
      const cudaError_t err = cudaFuncSetAttribute(
          binary_kernel<ANY_HIT, true>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    binary_kernel<ANY_HIT, true><<<blocks, THREADS, smem, s>>>(
        o, d, tmax, n, bt, inst_i, inst_f, n_inst, t_out, prim_out, inst_out, bu_out,
        bv_out, occ_out, work_out);
  } else if (blocks > 0) {
    if (smem > SHARED_DEFAULT) {
      const cudaError_t err = cudaFuncSetAttribute(
          binary_kernel<ANY_HIT, false>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
    }
    binary_kernel<ANY_HIT, false><<<blocks, THREADS, smem, s>>>(
        o, d, tmax, n, bt, inst_i, inst_f, n_inst, t_out, prim_out, inst_out, bu_out,
        bv_out, occ_out, nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

const char* binary_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The most stack entries a thread of K6 may use.
int binary_max_depth() { return BINARY_MAX_DEPTH; }

// K6 closest hit. pairs (Ni, 16) and roots (n_inst, 8) int32, 16-byte
// aligned (ops/cuda/binary.pair_records); depth_cap the depth the host
// proved; t/prim/inst/bu/bv (n,); work (2,) zeroed, or null for the kernel
// itself (with it, the counting variant adds boxes and primitives).
int binary_trace_closest(const float* o, const float* d, const float* tmax, int n,
                         const int* pairs, const int* roots, const float* tri_rows,
                         const float* sph_rows, const int* inst_i, const float* inst_f,
                         int n_inst, int leaf_width, int depth_cap, float* t_out,
                         int* prim_out, int* inst_out, float* bu_out, float* bv_out,
                         unsigned long long* work, void* stream) {
  const BinaryTables bt{reinterpret_cast<const int4*>(pairs),
                        reinterpret_cast<const int4*>(roots), tri_rows, sph_rows,
                        leaf_width, depth_cap};
  return launch<false>(o, d, tmax, n, bt, inst_i, inst_f, n_inst, t_out, prim_out,
                       inst_out, bu_out, bv_out, nullptr, work, stream);
}

// K6 any-hit: occlusion within (T_EPS, tmax), stopping at the first hit.
int binary_trace_shadow(const float* o, const float* d, const float* tmax, int n,
                        const int* pairs, const int* roots, const float* tri_rows,
                        const float* sph_rows, const int* inst_i, const float* inst_f,
                        int n_inst, int leaf_width, int depth_cap, bool* occ_out,
                        unsigned long long* work, void* stream) {
  const BinaryTables bt{reinterpret_cast<const int4*>(pairs),
                        reinterpret_cast<const int4*>(roots), tri_rows, sph_rows,
                        leaf_width, depth_cap};
  return launch<true>(o, d, tmax, n, bt, inst_i, inst_f, n_inst, nullptr, nullptr,
                      nullptr, nullptr, nullptr, occ_out, work, stream);
}

}  // extern "C"
