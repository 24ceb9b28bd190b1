// The quantized 8-wide BVH of the streaming kernels K4/K5 (stream_trace.cu)
// and K8 (streamtreelet_trace.cu) as the walks of node_walk.cuh read it
// (QuantNodes): one 128-byte record per node
// (ops/cuda/stream.pack_anyhit_nodes), read with 16-byte loads from one
// cache line, plus, for the closest walk, one 4-byte word of the node's
// per-octant child order, wide_perm[node * 8 + octant]:
//   words  0..5   the node's frame, lo.xyz and scale.xyz (float bits), 6..7 0
//   words  8..23  two words per child slot, the u8 box qlo.xyz | qhi.x and
//                 qhi.y | qhi.z
//   words 24..31  the child slots: >= 0 an inner node, -1 empty, <= -2 a leaf
//                 -(first_row * ENC_BASE + n_rows) - 2 of up to 16 8-slot rows
// A child box is dequantized as lo + float(q) * scale, unfused and in that
// order (--fmad=false): the arithmetic the host's outward rounding
// (_quantize_bounds) is proven for, so a walk visits a superset of the
// exact-box visits.
#pragma once

#include "node_walk.cuh"

namespace trace {

constexpr int ENC_BASE = 32;   // leaf encoding -(first_row * 32 + n_rows) - 2
constexpr int NODE_INT4 = 8;   // 16-byte words per node record
constexpr int CHILD_WORD = 24;  // int word of child slot 0 in a record

struct Frame {
  float lox, loy, loz, sx, sy, sz;
};

__device__ __forceinline__ Frame frame_of(const int4& f0, const int4& f1) {
  return Frame{__int_as_float(f0.x), __int_as_float(f0.y), __int_as_float(f0.z),
               __int_as_float(f0.w), __int_as_float(f1.x), __int_as_float(f1.y)};
}

// The slab test of child slot c's box against t_b; q is the record's
// 16-byte word 2 + c / 2, which holds the boxes of slots c & ~1 and c | 1.
__device__ __forceinline__ bool qbox_hit(const Frame& f, const int4& q, int c,
                                         const Ray& r, float t_b) {
  const unsigned w0 = static_cast<unsigned>((c & 1) ? q.z : q.x);
  const unsigned w1 = static_cast<unsigned>((c & 1) ? q.w : q.y);
  const float x0 = f.lox + static_cast<float>(w0 & 255u) * f.sx;
  const float y0 = f.loy + static_cast<float>((w0 >> 8) & 255u) * f.sy;
  const float z0 = f.loz + static_cast<float>((w0 >> 16) & 255u) * f.sz;
  const float x1 = f.lox + static_cast<float>((w0 >> 24) & 255u) * f.sx;
  const float y1 = f.loy + static_cast<float>(w1 & 255u) * f.sy;
  const float z1 = f.loz + static_cast<float>((w1 >> 8) & 255u) * f.sz;
  return slab6(x0, y0, z0, x1, y1, z1, r, t_b);
}

// The reader of node_walk.cuh over the quantized records.
struct QuantNodes {
  const int4* __restrict__ nodes;  // (W, 8) node records
  const int* __restrict__ perm;    // (W*8) per-octant child order (closest only)
  const float* __restrict__ tri;   // (Lt*128) triangle rows, 8 slots each
  const float* __restrict__ sph;   // (Ls*128) sphere rows, 8 slots each

  template <bool COUNT>
  __device__ __forceinline__ void visit_ranked(int node, int octant, const Ray& r,
                                               float t_b, unsigned& ord, int4& c0,
                                               int4& c1, unsigned& inner,
                                               unsigned& leaves, Work& work) const {
    const int4* __restrict__ rec = nodes + static_cast<size_t>(node) * NODE_INT4;
    const Frame f = frame_of(__ldg(rec), __ldg(rec + 1));
    c0 = __ldg(rec + 6);
    c1 = __ldg(rec + 7);
    ord = order(node, octant);
#pragma unroll
    for (int rank = 0; rank < WIDTH; ++rank) {
      const int c = (ord >> (rank * 4)) & 7;
      const int child = word_of(c0, c1, c);
      if (child == EMPTY) continue;
      if (COUNT) ++work.boxes;
      if (!qbox_hit(f, __ldg(rec + 2 + (c >> 1)), c, r, t_b)) continue;
      if (child >= 0) {
        inner |= 1u << rank;
      } else {
        leaves |= 1u << rank;
      }
    }
  }

  template <bool COUNT>
  __device__ __forceinline__ void visit_slots(int node, const Ray& r, float t_b,
                                              int4& c0, int4& c1, unsigned& inner,
                                              unsigned& leaves, Work& work) const {
    const int4* __restrict__ rec = nodes + static_cast<size_t>(node) * NODE_INT4;
    const Frame f = frame_of(__ldg(rec), __ldg(rec + 1));
    c0 = __ldg(rec + 6);
    c1 = __ldg(rec + 7);
#pragma unroll
    for (int c = 0; c < WIDTH; ++c) {
      const int child = word_of(c0, c1, c);
      if (child == EMPTY) continue;
      if (COUNT) ++work.boxes;
      if (!qbox_hit(f, __ldg(rec + 2 + (c >> 1)), c, r, t_b)) continue;
      if (child >= 0) {
        inner |= 1u << c;
      } else {
        leaves |= 1u << c;
      }
    }
  }

  __device__ __forceinline__ unsigned order(int node, int octant) const {
    return static_cast<unsigned>(__ldg(perm + static_cast<size_t>(node) * WIDTH + octant));
  }

  __device__ __forceinline__ bool box_hit(int node, int c, const Ray& r, float t_b) const {
    const int4* __restrict__ rec = nodes + static_cast<size_t>(node) * NODE_INT4;
    return qbox_hit(frame_of(__ldg(rec), __ldg(rec + 1)), __ldg(rec + 2 + (c >> 1)), c,
                    r, t_b);
  }

  __device__ __forceinline__ int child(int node, int c) const {
    return __ldg(reinterpret_cast<const int*>(nodes) +
                 static_cast<size_t>(node) * (NODE_INT4 * 4) + CHILD_WORD + c);
  }

  // A leaf -(first_row * ENC_BASE + n_rows) - 2: its rows in order, every
  // slot (padding slots are all zero and never accept).
  template <bool ANY_HIT, bool COUNT>
  __device__ __forceinline__ bool test_leaf(int child, const float* __restrict__ rows,
                                            bool is_tri, const Ray& r, int inst_bits,
                                            float t_limit, float& t_best, int& pp,
                                            Work& work) const {
    const int enc = -child - 2;
    const float* __restrict__ row = rows + static_cast<size_t>(enc / ENC_BASE) * ROW;
    for (int k = enc % ENC_BASE; k > 0; --k, row += ROW) {
      if (test_row<ANY_HIT, COUNT>(row, ROW_SLOTS, is_tri, r, inst_bits, t_limit, t_best,
                                   pp, work)) {
        return true;
      }
    }
    return false;
  }
};

}  // namespace trace
