// K7: one treelet round over the 8-wide BVH, one thread per sorted lane.
//
// Replaces the TPU kernel of ilgpu_raytracing_tpu/ops/pallas/treelet_kernel.py:
//   K7 _make_treelet_kernel (launched by run_treelet_trace, pallas_call at :595)
// and computes what it computes: lane i belongs to packet i / lanes_per_packet
// (tile_rows * 128 consecutive sorted lanes, a parameter of the result: the
// caller ORs its lanes' picks into that packet's i32 want mask), and walks
// every treelet whose bit is set in the mask, in increasing treelet index
// (the cut's Morton order), from the treelet's root with its instance
// encoding and world->object affine, carrying the lane's running t_best from
// its t_max. It writes (t, pp) with pp = -1 where no hit below t_max was
// found, pp = prim | (inst*4 + kind) << 20 otherwise.
//
// Each treelet walk is the closest-hit walk of K1 (node_walk.cuh over the
// WideNodes reader of wide_nodes.cuh), started from a treelet root instead of
// an instance root, on a node-group stack in shared memory bounded by the
// extended tables' wide depth; the loop over the mask is treelet_kernel in
// trace_common.cuh, shared with K8. Both walks keep the plain walk's test
// order, so a round equals K1 and round_plain bit for bit.
//
// What bounds it on an H100: as K1, the latency of dependent node and leaf
// loads along each lane's walk; a lane walks several treelets of one
// instance, each from its root, so it re-tests the synthetic wrapper nodes
// that group a treelet's subtrees. The bench scene's tables sit in L2.
//
// What this design does about it: the TPU kernel's want mask reformed
// 4096-lane packets around tree locality because a packet walks the union
// of its lanes' visits; a thread here walks only its own, and the mask only
// says which treelets to enter. Nothing else is done: the round is as fast
// as the walks it contains (speed is later work).

#include "wide_nodes.cuh"

namespace {

constexpr int PP_PRIM_BITS = 20;

}  // namespace

extern "C" {

const char* treelet_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int treelet_max_depth() { return trace::MAX_DEPTH; }

// One K7 round. nodes (W, 64) int32 records of the extended tables, as K1's;
// depth_cap their wide depth; mask (packets,) i32; t_root/t_inst (T+1,),
// t_w2o ((T+1)*12,); t_out/pp_out (n,); work (2,) zeroed or null.
int treelet_trace(const float* o, const float* d, const float* tmax, int n,
                  const int* nodes, const float* tri_rows, const float* sph_rows,
                  int leaf_width, int depth_cap, const int* mask, int lanes_per_packet,
                  const int* t_root, const int* t_inst, const float* t_w2o,
                  int n_treelets, int all_identity, float* t_out, int* pp_out,
                  unsigned long long* work, void* stream) {
  const trace::NodeGroupWalker<trace::WideNodes> wk{
      {reinterpret_cast<const int4*>(nodes), tri_rows, sph_rows, leaf_width}, depth_cap};
  return trace::launch_treelets(o, d, tmax, n, wk, mask, lanes_per_packet, t_root,
                                t_inst, t_w2o, n_treelets, all_identity,
                                PP_PRIM_BITS, t_out, pp_out, work, stream);
}

}  // extern "C"
