// The closest-hit walk of the quantized 8-wide BVH, shared by K4
// (stream_trace.cu, through trace_kernel) and K8 (streamtreelet_trace.cu,
// through treelet_kernel), built for the H100 on what K5's walk
// (stream_anyhit.cuh) showed:
// - a node is one 128-byte record (stream_nodes.cuh) plus one 4-byte word
//   of its per-octant child order, wide_perm[node * 8 + octant];
// - the stack holds node groups (Ylitie, Karras & Laine, HPG 2017): one
//   entry per level, node << 8 | mask of the RANKS (in the ray's octant
//   order) of the inner children still to visit; a pop re-reads the node's
//   order word. A thread needs at most (wide depth - 1) entries, held in
//   the block's dynamic shared memory (depth x 128 threads x 4 bytes),
//   where the walk it replaces kept 256 in a 1 KB local array. The host
//   proves the depth; a deeper walk fails a device-side assert;
// - a lane visits nodes until it holds hit leaves, then tests one leaf, so
//   the lanes of a warp test leaves together (the while-while loop of Aila
//   & Laine, HPG 2009) where a walk that tests each node's leaves inside
//   its child loop idles the lanes that met none;
// - a pending leaf and a popped inner child are tested again against the
//   t_best that earlier leaves tightened, and skipped when they no longer
//   pass. The counting variant counts each child box once, at its node's
//   visit, as the walk it replaces did: a re-test is this design's own
//   cost, not work the function needs.
//
// Exactness. A tie in t goes to the primitive tested first (t < t_best), so
// the walk keeps the order of the plain walk (ops/cuda/treelet.plain_walk):
// children in the rank order of the ray's octant, every hit leaf of a node
// before its inner children, each inner child's subtree before the next,
// the rows and slots of a leaf in row order. Slab tests against a staler
// t_best only add visits, and a box skipped against a tighter one holds no
// primitive below t_best, so t and pp equal the plain walk's bit for bit.
#pragma once

#include "stream_nodes.cuh"

namespace trace {

struct ClosestWalker {
  const int4* __restrict__ nodes;  // (W, 8) node records (stream_nodes.cuh)
  const int* __restrict__ perm;    // (W*8) per-octant child order, 4 bits/rank
  const float* __restrict__ tri;   // (Lt*128) triangle rows, 8 slots each
  const float* __restrict__ sph;   // (Ls*128) sphere rows, 8 slots each
  int depth_cap;                   // the host's bound on the wide depth

  size_t smem_bytes() const {
    return sizeof(int) * THREADS * (depth_cap > 0 ? depth_cap : 1);
  }

  // Tightens t_best / pp over the BLAS under `root` (closest hit only).
  template <bool ANY_HIT, bool COUNT>
  __device__ void walk(const Ray& r, int root, bool is_tri, int inst_bits,
                       float /* t_limit */, float& t_best, int& pp, bool& /* occ */,
                       Work& work, int* stack) const {
    static_assert(!ANY_HIT, "K5 has its own any-hit walk (stream_anyhit.cuh)");
    const float* __restrict__ rows = is_tri ? tri : sph;
    const int* __restrict__ words = reinterpret_cast<const int*>(nodes);
    const int octant = (r.dx > 0.0f ? 4 : 0) + (r.dy > 0.0f ? 2 : 0) +
                       (r.dz > 0.0f ? 1 : 0);
    int sp = 0;
    int node = root;      // the next node to visit; -1 when none is left
    int lnode = 0;        // the node whose hit leaf children are pending
    unsigned lorder = 0;  // its order word
    unsigned leaves = 0;  // those children, a bit per rank
    for (;;) {
      // visit nodes until this lane has leaves to test or has none left
      while (node >= 0 && leaves == 0) {
        const int4* __restrict__ rec = nodes + static_cast<size_t>(node) * NODE_INT4;
        const Frame f = frame_of(__ldg(rec), __ldg(rec + 1));
        const int4 c0 = __ldg(rec + 6), c1 = __ldg(rec + 7);
        const unsigned order = static_cast<unsigned>(
            __ldg(perm + static_cast<size_t>(node) * WIDTH + octant));
        unsigned inner = 0;
#pragma unroll
        for (int rank = 0; rank < WIDTH; ++rank) {
          const int c = (order >> (rank * 4)) & 7;
          const int child = word_of(c0, c1, c);
          if (child == EMPTY) continue;
          if (COUNT) ++work.boxes;
          if (!qbox_hit(f, __ldg(rec + 2 + (c >> 1)), c, r, t_best)) continue;
          if (child >= 0) {
            inner |= 1u << rank;
          } else {
            leaves |= 1u << rank;
          }
        }
        if (leaves != 0) {
          lnode = node;
          lorder = order;
        }
        if (inner != 0) {  // descend into the nearest hit inner child
          const int rank = __ffs(static_cast<int>(inner)) - 1;
          inner &= inner - 1u;
          if (inner != 0) {
            if (sp >= depth_cap) {  // the host's bound (the wide depth) was wrong
              assert(false && "stream closest walk: node-group stack overflow");
              return;
            }
            stack[sp++ * THREADS] = (node << 8) | static_cast<int>(inner);
          }
          node = word_of(c0, c1, (order >> (rank * 4)) & 7);
          continue;
        }
        // the next inner child of the deepest pending group
        node = -1;
        while (sp > 0) {
          const int e = stack[--sp * THREADS];
          unsigned mask = static_cast<unsigned>(e) & 255u;
          const int rank = __ffs(static_cast<int>(mask)) - 1;
          mask &= mask - 1u;
          if (mask != 0) stack[sp++ * THREADS] = (e & ~255) | static_cast<int>(mask);
          const int parent = e >> 8;
          const int c = (static_cast<unsigned>(__ldg(
                             perm + static_cast<size_t>(parent) * WIDTH + octant)) >>
                         (rank * 4)) & 7;
          const int4* __restrict__ prec = nodes + static_cast<size_t>(parent) * NODE_INT4;
          if (!qbox_hit(frame_of(__ldg(prec), __ldg(prec + 1)),
                        __ldg(prec + 2 + (c >> 1)), c, r, t_best)) {
            continue;
          }
          node = __ldg(words + static_cast<size_t>(parent) * (NODE_INT4 * 4) +
                       CHILD_WORD + c);
          break;
        }
      }
      if (leaves == 0) return;  // no node and no leaf left
      // test the nearest pending leaf, then visit again
      const int rank = __ffs(static_cast<int>(leaves)) - 1;
      leaves &= leaves - 1u;
      const int c = (lorder >> (rank * 4)) & 7;
      const int4* __restrict__ lrec = nodes + static_cast<size_t>(lnode) * NODE_INT4;
      if (!qbox_hit(frame_of(__ldg(lrec), __ldg(lrec + 1)),
                    __ldg(lrec + 2 + (c >> 1)), c, r, t_best)) {
        continue;
      }
      const int enc =
          -__ldg(words + static_cast<size_t>(lnode) * (NODE_INT4 * 4) + CHILD_WORD + c) -
          2;
      const float* __restrict__ row = rows + static_cast<size_t>(enc / ENC_BASE) * ROW;
      for (int k = enc % ENC_BASE; k > 0; --k, row += ROW) {
        test_row<false, COUNT>(row, ROW_SLOTS, is_tri, r, inst_bits, t_best, t_best,
                               pp, work);
      }
    }
  }
};

}  // namespace trace
