// K8: one treelet round over the quantized 8-wide BVH of a large scene, one
// thread per sorted lane.
//
// Replaces the TPU kernel of
// ilgpu_raytracing_tpu/ops/pallas/streamtreelet_kernel.py:
//   K8 _make_treelet_stream_kernel (launched by run_treelet_stream_trace,
//      pallas_call at :360)
// and computes what it computes: K7's round (packet i / lanes_per_packet,
// its i32 want mask, the set treelets walked in increasing index from their
// roots, running t_best from the lane's t_max, pp = -1 where nothing below
// t_max was hit) over the streaming tables: u8-quantized child boxes,
// multi-row leaves, the 23-bit prim record pp = prim | (inst*4 + kind) << 23.
// As on the TPU, only identity instance transforms are taken (the host prep
// refuses others), so the world ray is the object ray.
//
// Each treelet walk is the closest-hit walk of K4 (node_walk.cuh over the
// QuantNodes reader of stream_nodes.cuh) over the cut's extended tables; the loop over the mask
// is treelet_kernel in trace_common.cuh, shared with K7. Both walks keep the
// plain walk's test order, so the rounds equal K4 bit for bit.
//
// What bounds it on an H100: as K4, leaf fetches from HBM (the 1M-triangle
// terrain's 69 MB of leaf rows exceed the 50 MB L2) and the Moller-Trumbore
// tests of up to 128 triangles a leaf. The TPU kernel's double-buffered DMA
// of leaf rows is not carried over; each thread reads its own leaf rows as
// 16-byte loads, and the lanes of a warp test leaves together. Leaf staging
// shared by a warp is later work.

#include "stream_nodes.cuh"

namespace {

constexpr int SPP_PRIM_BITS = 23;

}  // namespace

extern "C" {

const char* streamtreelet_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int streamtreelet_max_depth() { return trace::MAX_DEPTH; }

// One K8 round; arguments as treelet_trace, over the node records and
// order words of the extended streaming tables (as K4's), with depth_cap
// the extended tables' wide depth.
int streamtreelet_trace(const float* o, const float* d, const float* tmax, int n,
                        const int* nodes, const int* perm, const float* tri_rows,
                        const float* sph_rows, int depth_cap, const int* mask,
                        int lanes_per_packet, const int* t_root,
                        const int* t_inst, int n_treelets, float* t_out,
                        int* pp_out, unsigned long long* work, void* stream) {
  const trace::NodeGroupWalker<trace::QuantNodes> wk{
      {reinterpret_cast<const int4*>(nodes), perm, tri_rows, sph_rows}, depth_cap};
  return trace::launch_treelets(o, d, tmax, n, wk, mask, lanes_per_packet, t_root,
                                t_inst, nullptr, n_treelets, 1, SPP_PRIM_BITS,
                                t_out, pp_out, work, stream);
}

}  // extern "C"
