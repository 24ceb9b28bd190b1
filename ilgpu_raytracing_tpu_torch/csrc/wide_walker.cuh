// The 8-wide BVH walk of K1/K2 (wide_trace.cu) and K7 (treelet_trace.cu):
// one ray's depth-first walk with its own stack, children in the order of
// the ray's own direction octant (wide_perm), hit leaves tested as soon as
// their box is hit.
#pragma once

#include "trace_common.cuh"

namespace trace {

// Tables of the wide BVH; walk() is one DFS from a root: an instance's in
// trace_ray, a treelet's in treelet_kernel.
struct WideWalker {
  const float* __restrict__ wb;    // (W*48) child bounds, 8 x (bmin3 bmax3)
  const int* __restrict__ wc;      // (W*8) >=0 inner, -1 empty, <=-2 leaf
  const int* __restrict__ wp;      // (W*8) per-octant child order, 4 bits/rank
  const float* __restrict__ tri;   // (Lt*128) packed triangle leaf rows
  const float* __restrict__ sph;   // (Ls*128) packed sphere leaf rows
  int leaf_width;
  int stack_cap;

  size_t smem_bytes() const { return 0; }  // the stack is a local array

  // Closest: tightens t_best / pp. Any-hit: returns at the first accepting
  // primitive with occ = true. A push past stack_cap fails an assert.
  template <bool ANY_HIT, bool COUNT>
  __device__ void walk(const Ray& r, int root, bool is_tri, int inst_bits,
                       float t_limit, float& t_best, int& pp, bool& occ,
                       Work& work, int* /* shared stack, unused */) const {
    int stack[MAX_STACK];
    int sp = 0;
    stack[sp++] = root;
    const int octant = (r.dx > 0.0f ? 4 : 0) + (r.dy > 0.0f ? 2 : 0) +
                       (r.dz > 0.0f ? 1 : 0);
    const float* __restrict__ rows = is_tri ? tri : sph;
    while (sp > 0) {
      const int wid = stack[--sp];
      const unsigned perm = static_cast<unsigned>(wp[wid * WIDTH + octant]);
      unsigned inner = 0;
#pragma unroll
      for (int rank = 0; rank < WIDTH; ++rank) {
        const int c8 = (perm >> (rank * 4)) & 7;
        const int child = wc[wid * WIDTH + c8];
        if (child == EMPTY) continue;
        if (COUNT) ++work.boxes;
        if (!slab(wb + wid * 48 + c8 * 6, r, ANY_HIT ? t_limit : t_best)) continue;
        if (child >= 0) {
          inner |= 1u << rank;
          continue;
        }
        // leaf encoding -(row * 16 + count) - 2
        const int enc = -child - 2;
        const int count = min(enc & 15, leaf_width);
        const float* __restrict__ row = rows + static_cast<size_t>(enc >> 4) * ROW;
        if (test_row<ANY_HIT, COUNT>(row, count, is_tri, r, inst_bits, t_limit,
                                     t_best, pp, work)) {
          occ = true;
          return;
        }
      }
      // One check for all of the node's pushes, outside the unrolled loop:
      // an assert inside it (eight call sites) made K1 and K2 over twice as
      // slow on an H100.
      if (sp + __popc(inner) > stack_cap) {  // the host's bound (7 * wide depth + 1) was wrong
        assert(false && "wide walk: per-thread stack overflow");
        return;
      }
      // far-first pushes leave the nearest inner child on top
#pragma unroll
      for (int rank = WIDTH - 1; rank >= 0; --rank) {
        if (!((inner >> rank) & 1u)) continue;
        stack[sp++] = wc[wid * WIDTH + ((perm >> (rank * 4)) & 7)];
      }
    }
  }
};

}  // namespace trace
