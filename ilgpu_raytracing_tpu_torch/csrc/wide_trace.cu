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
// node records and 128-float leaf rows. The scene tables of the bench scene
// (614 wide nodes and about 2k leaf rows of 512 bytes, about 1 MB) sit in
// the 50 MB L2, so the walk pays L2 latency per step, not HBM bandwidth.
//
// What this design does about it: the TPU kernel's packet shape (4096-lane
// tiles sharing one scalar stack, FRONT-node frontiers, subtile want masks,
// the packet's first-lane octant) answers TPU constraints and is not carried
// over. Each thread walks its own ray with the walks of node_walk.cuh,
// shared with K4/K5/K8, over one 256-byte record a node (wide_nodes.cuh:
// the exact float32 child boxes slot-major by axis, the child words and the
// per-octant order words), read with 16-byte loads. Node groups sit on a
// stack in the block's shared memory bounded by the wide depth the host
// proves (a deeper walk fails a device-side assert; nothing is read back).
// K1 visits nodes until the lane holds hit leaves, then tests one leaf,
// near-first in its own octant's order, so t_best tightens early and the
// lanes of a warp test leaves together; it keeps the plain walk's test
// order, so t and pp equal it bit for bit. K2 needs no order: it visits
// children in slot order, reads no order word, and ends a ray at its first
// accepting primitive.
//
// The ray record, slab and leaf predicates and the loop over instances live in
// trace_common.cuh, shared with the other trace kernels.
//
// Built with nvcc for sm_90a, without --use_fast_math: IEEE division and
// sqrt, as the slab and Moller-Trumbore math needs (approximate reciprocals
// produced distance-banded ring artifacts on the TPU).

#include "wide_nodes.cuh"

namespace {

constexpr int PP_PRIM_BITS = 20;

}  // namespace

using Walker = trace::NodeGroupWalker<trace::WideNodes>;

extern "C" {

const char* wide_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The most node-group stack entries a thread of K1 or K2 may use.
int wide_max_depth() { return trace::MAX_DEPTH; }

// K1: closest hit. nodes (W, 64) int32, 16-byte aligned
// (ops/cuda/wide.pack_wide_nodes); depth_cap the wide depth; t_out/pp_out
// (n,); work (2,) zeroed, or null (see launch_trace).
int wide_trace_closest(const float* o, const float* d, const float* tmax, int n,
                       const int* nodes, const float* tri_rows, const float* sph_rows,
                       const int* inst_i, const float* inst_f, int n_inst,
                       int leaf_width, int depth_cap, float* t_out, int* pp_out,
                       unsigned long long* work, void* stream) {
  const Walker wk{{reinterpret_cast<const int4*>(nodes), tri_rows, sph_rows, leaf_width},
                  depth_cap};
  return trace::launch_trace<false>(o, d, tmax, n, wk, inst_i, inst_f, n_inst,
                                    PP_PRIM_BITS, t_out, pp_out, nullptr, work,
                                    stream);
}

// K2: any-hit occlusion within (T_EPS, tmax). occ_out (n,) bool.
int wide_trace_shadow(const float* o, const float* d, const float* tmax, int n,
                      const int* nodes, const float* tri_rows, const float* sph_rows,
                      const int* inst_i, const float* inst_f, int n_inst,
                      int leaf_width, int depth_cap, bool* occ_out,
                      unsigned long long* work, void* stream) {
  const Walker wk{{reinterpret_cast<const int4*>(nodes), tri_rows, sph_rows, leaf_width},
                  depth_cap};
  return trace::launch_trace<true>(o, d, tmax, n, wk, inst_i, inst_f, n_inst,
                                   PP_PRIM_BITS, nullptr, nullptr, occ_out, work,
                                   stream);
}

}  // extern "C"
