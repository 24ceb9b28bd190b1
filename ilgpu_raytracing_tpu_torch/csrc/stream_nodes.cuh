// The quantized 8-wide BVH of the streaming kernels K4/K5 (stream_trace.cu)
// and K8 (streamtreelet_trace.cu) as their walks read it: one 128-byte
// record per node (ops/cuda/stream.pack_anyhit_nodes), read with 16-byte
// loads from one cache line:
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

#include "trace_common.cuh"

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

// Word j (0..7) of the pair of 16-byte words (a, b), by selects: a dynamic
// index into a register array would go through local memory.
__device__ __forceinline__ int word_of(const int4& a, const int4& b, int j) {
  const int4 v = j < 4 ? a : b;
  const int k = j & 3;
  return k == 0 ? v.x : (k == 1 ? v.y : (k == 2 ? v.z : v.w));
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

}  // namespace trace
