// The exact-box 8-wide BVH of K1/K2 (wide_trace.cu) and K7
// (treelet_trace.cu) as the walks of node_walk.cuh read it (WideNodes): one
// 256-byte record per node (ops/cuda/wide.pack_wide_nodes), two cache
// lines, read with 16-byte loads at a visit:
//   words  0..47  the child boxes, float32 bits, slot-major by axis: xlo of
//                 slots 0..7, then ylo, zlo, xhi, yhi, zhi
//   words 48..55  the child slots: >= 0 an inner node, -1 empty, <= -2 a leaf
//                 -(row * 16 + count) - 2 of one 8-slot row
//   words 56..63  the per-octant child order, 4 bits a rank
// The boxes are the wide tables' own float32 values, unquantized, so a slab
// test rounds exactly as the plain walk's.
#pragma once

#include "node_walk.cuh"

namespace trace {

constexpr int WIDE_INT4 = 16;    // 16-byte words per node record
constexpr int WIDE_CHILD = 48;   // int word of child slot 0 in a record
constexpr int WIDE_ORDER = 56;   // int word of octant 0's order in a record

__device__ __forceinline__ float lane_of(const float4& v, int k) {
  return k == 0 ? v.x : (k == 1 ? v.y : (k == 2 ? v.z : v.w));
}

// The reader of node_walk.cuh over the exact-box records.
struct WideNodes {
  const int4* __restrict__ nodes;  // (W, 16) node records
  const float* __restrict__ tri;   // (Lt*128) triangle rows, 8 slots each
  const float* __restrict__ sph;   // (Ls*128) sphere rows, 8 slots each
  int leaf_width;                  // most slots any leaf row holds

  // Every non-empty child's box against t_b, in slot order: one visit
  // reads the record's twelve 16-byte box words and two child words, and
  // the unrolled loop picks each slot's six floats from registers.
  template <bool COUNT>
  __device__ __forceinline__ void visit_slots(int node, const Ray& r, float t_b,
                                              int4& c0, int4& c1, unsigned& inner,
                                              unsigned& leaves, Work& work) const {
    const int4* __restrict__ rec = nodes + static_cast<size_t>(node) * WIDE_INT4;
    const float4* __restrict__ fb = reinterpret_cast<const float4*>(rec);
    c0 = __ldg(rec + WIDE_CHILD / 4);
    c1 = __ldg(rec + WIDE_CHILD / 4 + 1);
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // slots 4h .. 4h + 3
      const float4 x0 = __ldg(fb + h), y0 = __ldg(fb + 2 + h), z0 = __ldg(fb + 4 + h);
      const float4 x1 = __ldg(fb + 6 + h), y1 = __ldg(fb + 8 + h), z1 = __ldg(fb + 10 + h);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int c = 4 * h + k;
        const int child = word_of(c0, c1, c);
        if (child == EMPTY) continue;
        if (COUNT) ++work.boxes;
        if (!slab6(lane_of(x0, k), lane_of(y0, k), lane_of(z0, k), lane_of(x1, k),
                   lane_of(y1, k), lane_of(z1, k), r, t_b)) {
          continue;
        }
        if (child >= 0) {
          inner |= 1u << c;
        } else {
          leaves |= 1u << c;
        }
      }
    }
  }

  // visit_slots, then the hit masks moved from slots to the ranks of the
  // ray's octant order. Every child is tested against the same t_b, so the
  // order of the tests does not matter.
  template <bool COUNT>
  __device__ __forceinline__ void visit_ranked(int node, int octant, const Ray& r,
                                               float t_b, unsigned& ord, int4& c0,
                                               int4& c1, unsigned& inner,
                                               unsigned& leaves, Work& work) const {
    ord = order(node, octant);
    unsigned in_slots = 0, leaf_slots = 0;
    visit_slots<COUNT>(node, r, t_b, c0, c1, in_slots, leaf_slots, work);
#pragma unroll
    for (int rank = 0; rank < WIDTH; ++rank) {
      const int c = (ord >> (rank * 4)) & 7;
      inner |= ((in_slots >> c) & 1u) << rank;
      leaves |= ((leaf_slots >> c) & 1u) << rank;
    }
  }

  __device__ __forceinline__ unsigned order(int node, int octant) const {
    return static_cast<unsigned>(__ldg(reinterpret_cast<const int*>(nodes) +
                                       static_cast<size_t>(node) * (WIDE_INT4 * 4) +
                                       WIDE_ORDER + octant));
  }

  // Child slot c's box against t_b: six 4-byte loads from the record.
  __device__ __forceinline__ bool box_hit(int node, int c, const Ray& r, float t_b) const {
    const float* __restrict__ b = reinterpret_cast<const float*>(nodes) +
                                  static_cast<size_t>(node) * (WIDE_INT4 * 4) + c;
    return slab6(__ldg(b), __ldg(b + 8), __ldg(b + 16), __ldg(b + 24), __ldg(b + 32),
                 __ldg(b + 40), r, t_b);
  }

  __device__ __forceinline__ int child(int node, int c) const {
    return __ldg(reinterpret_cast<const int*>(nodes) +
                 static_cast<size_t>(node) * (WIDE_INT4 * 4) + WIDE_CHILD + c);
  }

  // A leaf -(row * 16 + count) - 2: the first min(count, leaf_width) slots
  // of one row.
  template <bool ANY_HIT, bool COUNT>
  __device__ __forceinline__ bool test_leaf(int child, const float* __restrict__ rows,
                                            bool is_tri, const Ray& r, int inst_bits,
                                            float t_limit, float& t_best, int& pp,
                                            Work& work) const {
    const int enc = -child - 2;
    return test_row<ANY_HIT, COUNT>(rows + static_cast<size_t>(enc >> 4) * ROW,
                                    min(enc & 15, leaf_width), is_tri, r, inst_bits,
                                    t_limit, t_best, pp, work);
  }
};

}  // namespace trace
