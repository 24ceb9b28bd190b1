// The quantized 8-wide BVH walk of K4/K5 (stream_trace.cu) and K8
// (streamtreelet_trace.cu): the walk of wide_walker.cuh over u8 child boxes
// dequantized as lo + float(q) * scale (unfused), with leaves of up to 16
// consecutive 8-slot rows.
#pragma once

#include "trace_common.cuh"

namespace trace {

constexpr int ENC_BASE = 32;  // leaf encoding -(first_row * 32 + n_rows) - 2

// Tables of the quantized wide BVH; walk() as in WideWalker.
struct StreamWalker {
  const float* __restrict__ wf;   // (W*6) per node lo.xyz, (ext/255).xyz
  const int* __restrict__ wq;     // (W*16) per child 2 words of packed u8s
  const int* __restrict__ wc;     // (W*8) >=0 inner, -1 empty, <=-2 leaf
  const int* __restrict__ wp;     // (W*8) per-octant child order, 4 bits/rank
  const float* __restrict__ tri;  // (Lt*128) triangle rows, 8 slots each
  const float* __restrict__ sph;  // (Ls*128) sphere rows, 8 slots each
  int stack_cap;

  template <bool ANY_HIT, bool COUNT>
  __device__ bool walk(const Ray& r, int root, bool is_tri, int inst_bits,
                       float t_limit, float& t_best, int& pp, bool& occ,
                       Work& work) const {
    int stack[MAX_STACK];
    int sp = 0;
    stack[sp++] = root;
    const int octant = (r.dx > 0.0f ? 4 : 0) + (r.dy > 0.0f ? 2 : 0) +
                       (r.dz > 0.0f ? 1 : 0);
    const float* __restrict__ rows = is_tri ? tri : sph;
    while (sp > 0) {
      const int wid = stack[--sp];
      const float* __restrict__ f = wf + wid * 6;
      const float flox = f[0], floy = f[1], floz = f[2];
      const float fsx = f[3], fsy = f[4], fsz = f[5];
      const unsigned perm = static_cast<unsigned>(wp[wid * WIDTH + octant]);
      unsigned inner = 0;
#pragma unroll
      for (int rank = 0; rank < WIDTH; ++rank) {
        const int c8 = (perm >> (rank * 4)) & 7;
        const int child = wc[wid * WIDTH + c8];
        if (child == EMPTY) continue;
        if (COUNT) ++work.boxes;
        // dequantize lo + float(q) * scale, unfused (--fmad=false)
        const unsigned w0 = static_cast<unsigned>(wq[wid * 16 + c8 * 2]);
        const unsigned w1 = static_cast<unsigned>(wq[wid * 16 + c8 * 2 + 1]);
        const float x0 = flox + static_cast<float>(w0 & 255u) * fsx;
        const float y0 = floy + static_cast<float>((w0 >> 8) & 255u) * fsy;
        const float z0 = floz + static_cast<float>((w0 >> 16) & 255u) * fsz;
        const float x1 = flox + static_cast<float>((w0 >> 24) & 255u) * fsx;
        const float y1 = floy + static_cast<float>(w1 & 255u) * fsy;
        const float z1 = floz + static_cast<float>((w1 >> 8) & 255u) * fsz;
        if (!slab6(x0, y0, z0, x1, y1, z1, r, ANY_HIT ? t_limit : t_best)) continue;
        if (child >= 0) {
          inner |= 1u << rank;
          continue;
        }
        const int enc = -child - 2;
        const int n_rows = enc % ENC_BASE;
        const float* __restrict__ row =
            rows + static_cast<size_t>(enc / ENC_BASE) * ROW;
        for (int k = 0; k < n_rows; ++k) {
          if (test_row<ANY_HIT, COUNT>(row + static_cast<size_t>(k) * ROW,
                                       ROW_SLOTS, is_tri, r, inst_bits, t_limit,
                                       t_best, pp, work)) {
            occ = true;
            return true;
          }
        }
      }
      // far-first pushes leave the nearest inner child on top
#pragma unroll
      for (int rank = WIDTH - 1; rank >= 0; --rank) {
        if (!((inner >> rank) & 1u)) continue;
        if (sp >= stack_cap) return false;
        stack[sp++] = wc[wid * WIDTH + ((perm >> (rank * 4)) & 7)];
      }
    }
    return true;
  }
};

}  // namespace trace
