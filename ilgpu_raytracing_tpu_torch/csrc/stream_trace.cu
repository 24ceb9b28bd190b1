// K4 + K5: closest-hit and any-hit walks of the quantized 8-wide BVH of a
// large scene (150k to 4M triangles).
//
// Replaces the TPU kernels of ilgpu_raytracing_tpu/ops/pallas/stream_kernel.py:
//   K4 _make_closest_kernel (launched by _run_trace, pallas_call at :906)
//   K5 _make_shadow_kernel  (launched by _run_shadow, pallas_call at :996)
// and computes what they compute: per ray, over every instance, world-AABB
// entry, world->object transform, an 8-wide BVH walk whose child boxes are
// u8-quantized against a per-node frame (lo + float(q) * scale, dequantized
// in exactly that order, unfused), and coarse leaves of up to 16 consecutive
// 8-slot rows, tested with the leaf predicates of K1/K2. The closest record
// is packed as prim | (inst*4 + kind) << 23, miss = -1.
//
// Exactness: the host (ops/cuda/stream.py _quantize_bounds) rounds every
// quantized box outward in this very arithmetic, with a 2-ulp margin. Built
// with --fmad=false, the walk visits a superset of the exact-box visits, so
// t and the hit and occlusion masks equal the plain skip-index walk's.
//
// What bounds it on an H100: leaf fetches from HBM. The 1,048,576-triangle
// terrain packs into about 131k leaf rows of 512 bytes (about 67 MB), more
// than the 50 MB L2, so unlike K1 on the bench scene the leaf rows of a
// divergent warp come from device memory; the node tables (about 100 B per
// wide node, a few hundred kB) stay in L2. A leaf visit costs up to 16 rows
// x 8 Moller-Trumbore tests, so the kernel also spends many float
// operations per byte.
//
// What this design does about it: the TPU kernel's packet shape (2048-lane
// tiles behind one scalar SMEM stack, FRONT-node frontiers, subtile want
// masks, a double-buffered 8 KB DMA per leaf) answers TPU constraints and is
// not carried over. K4 walks each ray on its own thread with the closest-hit
// walk of node_walk.cuh (shared with K8, K1 and K7) over the quantized
// records of stream_nodes.cuh: one packed 128-byte record
// and one order word per node, node groups on a stack in shared memory
// bounded by the wide depth, children in the ray's own octant order, and
// lanes that visit nodes until each holds hit leaves and then test one leaf
// together, near-first, so t_best tightens early and prunes what follows. A
// triangle slot is 48 bytes, read as three 16-byte loads. The sort key of
// the bounce batches (destination treelet, ops/sort.py) groups rays that
// fetch the same leaves. Warp-cooperative leaf staging in shared memory
// (the DMA idea redone for Hopper) is later work.
//
// K5 runs the any-hit walk of node_walk.cuh (shared with K2) in a kernel of
// its own (stream_anyhit.cuh): occlusion needs no order, so it visits
// children in slot order and reads no order word.
//
// Each walk's stack bound is proven on the host (the wide depth); a walk
// past it fails a device-side assert instead of setting a flag the wrapper
// would have to read back.

#include "stream_anyhit.cuh"

namespace {

constexpr int SPP_PRIM_BITS = 23;

}  // namespace

extern "C" {

const char* stream_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

// The most node-group stack entries a thread of K4 or K5 may use.
int stream_max_depth() { return trace::MAX_DEPTH; }

// K4: closest hit. nodes (W, 32) int32, 16-byte aligned
// (ops/cuda/stream.pack_anyhit_nodes); perm (W*8) the per-octant child
// order; depth_cap the wide depth; t_out/pp_out (n,); work (2,) zeroed, or
// null (see launch_trace).
int stream_trace_closest(const float* o, const float* d, const float* tmax, int n,
                         const int* nodes, const int* perm, const float* tri_rows,
                         const float* sph_rows, const int* inst_i,
                         const float* inst_f, int n_inst, int depth_cap,
                         float* t_out, int* pp_out, unsigned long long* work,
                         void* stream) {
  const trace::NodeGroupWalker<trace::QuantNodes> wk{
      {reinterpret_cast<const int4*>(nodes), perm, tri_rows, sph_rows}, depth_cap};
  return trace::launch_trace<false>(o, d, tmax, n, wk, inst_i, inst_f, n_inst,
                                    SPP_PRIM_BITS, t_out, pp_out, nullptr, work,
                                    stream);
}

// K5: any-hit occlusion within (T_EPS, tmax). nodes and depth_cap as K4's;
// occ_out (n,) bool; work (2,) and warp_max (ceil(n / 32),) zeroed for the
// counting variant, or both null.
int stream_trace_anyhit(const float* o, const float* d, const float* tmax, int n,
                        const int* nodes, const float* tri_rows,
                        const float* sph_rows, const int* inst_i,
                        const float* inst_f, int n_inst, int depth_cap,
                        bool* occ_out, unsigned long long* work, unsigned* warp_max,
                        void* stream) {
  const trace::AnyHitWalker wk{
      {reinterpret_cast<const int4*>(nodes), nullptr, tri_rows, sph_rows}, depth_cap};
  return trace::launch_anyhit(o, d, tmax, n, wk, inst_i, inst_f, n_inst, occ_out,
                              work, warp_max, stream);
}

}  // extern "C"
