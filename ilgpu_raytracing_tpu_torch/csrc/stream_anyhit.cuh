// K5's own any-hit walk of the quantized 8-wide BVH (stream_trace.cu),
// built for occlusion alone. An any-hit result is the OR, over every
// primitive, of "t lies in (T_EPS, t_max)"; the OR does not depend on the
// order of the walk, so this walk pays for no order:
// - children are visited in slot order: no per-octant order table, no
//   near-first sort of the pushes;
// - the stack holds node groups (Ylitie, Karras & Laine, HPG 2017): one
//   entry per level, node << 8 | mask of the inner children still to visit,
//   so a thread needs at most (wide depth - 1) entries, held in shared
//   memory (depth x 128 threads x 4 bytes per block, 6 KB on the 1M-
//   triangle terrain) instead of a 1,024-byte local array; the host proves
//   the depth, and a deeper walk fails a device-side assert;
// - a node is one 128-byte record (stream_nodes.cuh), read with 16-byte
//   loads from one cache line;
// - a lane visits nodes until it has a hit leaf to test, then tests one
//   leaf, so the lanes of a warp test leaves together (the while-while loop
//   of Aila & Laine, HPG 2009, without a warp vote) where a walk that tests
//   each node's leaves as it meets them idles the lanes that met none.
// What bounds it: the leaf rows (69 MB on the 1M-triangle terrain, more
// than the 50 MB L2) fetched by divergent lanes, at about 89 primitive
// and 75 box tests per live bounce ray.
// Child boxes are dequantized as lo + float(q) * scale, unfused and in that
// order (the arithmetic the host's outward rounding is proven for), and
// leaves are tested with the shared leaf predicates, so occlusion equals
// the plain walk's and K4's hit mask at the same t_max.
#pragma once

#include "stream_nodes.cuh"

namespace trace {

// Blocks of THREADS an SM must hold (__launch_bounds__): caps a thread at
// 65,536 / (128 x 10) = 51 registers. On an H100, 10 and 8 (56 registers)
// timed within each other's run-to-run spread on the bounce lanes of the
// 1M-triangle terrain (PERF.md).
constexpr int ANYHIT_MIN_BLOCKS = 10;

struct AnyHitWalker {
  const int4* __restrict__ nodes;  // (W, 8): lo.xyz scale.xyz 0 0 | 16 box words | 8 children
  const float* __restrict__ tri;   // (Lt*128) triangle rows, 8 slots each
  const float* __restrict__ sph;   // (Ls*128) sphere rows, 8 slots each
  int depth_cap;                   // the host's bound on the wide depth
};

// True when some primitive of the BLAS under `root` accepts t in (T_EPS,
// t_limit). `stack` is this thread's column of the block's shared stack
// (entry e at stack[e * THREADS]); a walk that would need more than
// depth_cap entries fails an assert.
template <bool COUNT>
__device__ bool anyhit_walk(const AnyHitWalker& wk, const Ray& r, int root,
                            bool is_tri, float t_limit, int* stack, Work& work) {
  const float* __restrict__ rows = is_tri ? wk.tri : wk.sph;
  const int* __restrict__ words = reinterpret_cast<const int*>(wk.nodes);
  float t_unused = t_limit;
  int pp_unused = -1;
  int sp = 0;
  int node = root;      // the next node to visit; -1 when none is left
  int lnode = 0;        // the node whose hit leaf children are pending
  unsigned leaves = 0;  // those children, a bit per slot
  for (;;) {
    // visit nodes until this lane has leaves to test or has none left
    while (node >= 0 && leaves == 0) {
      const int4* __restrict__ rec = wk.nodes + static_cast<size_t>(node) * NODE_INT4;
      const Frame f = frame_of(__ldg(rec), __ldg(rec + 1));
      const int4 c0 = __ldg(rec + 6), c1 = __ldg(rec + 7);
      unsigned inner = 0;
#pragma unroll
      for (int c = 0; c < WIDTH; ++c) {
        const int child = word_of(c0, c1, c);
        if (child == EMPTY) continue;
        if (COUNT) ++work.boxes;
        if (!qbox_hit(f, __ldg(rec + 2 + (c >> 1)), c, r, t_limit)) continue;
        if (child >= 0) {
          inner |= 1u << c;
        } else {
          leaves |= 1u << c;
        }
      }
      if (leaves != 0) lnode = node;
      if (inner != 0) {  // descend into the first hit inner child
        const int c = __ffs(static_cast<int>(inner)) - 1;
        inner &= inner - 1u;
        if (inner != 0) {
          if (sp >= wk.depth_cap) {  // the host's bound (the wide depth) was wrong
            assert(false && "stream any-hit walk: node-group stack overflow");
            return false;
          }
          stack[sp++ * THREADS] = (node << 8) | static_cast<int>(inner);
        }
        node = word_of(c0, c1, c);
      } else if (sp > 0) {  // the next inner child of the deepest pending group
        const int e = stack[--sp * THREADS];
        unsigned mask = static_cast<unsigned>(e) & 255u;
        const int c = __ffs(static_cast<int>(mask)) - 1;
        mask &= mask - 1u;
        if (mask != 0) stack[sp++ * THREADS] = (e & ~255) | static_cast<int>(mask);
        node = __ldg(words + static_cast<size_t>(e >> 8) * (NODE_INT4 * 4) + CHILD_WORD + c);
      } else {
        node = -1;
      }
    }
    if (leaves == 0) return false;  // no node and no leaf left
    // test one pending leaf, the first in slot order, then visit again
    const int c = __ffs(static_cast<int>(leaves)) - 1;
    leaves &= leaves - 1u;
    const int enc =
        -__ldg(words + static_cast<size_t>(lnode) * (NODE_INT4 * 4) + CHILD_WORD + c) - 2;
    const float* __restrict__ row = rows + static_cast<size_t>(enc / ENC_BASE) * ROW;
    for (int k = enc % ENC_BASE; k > 0; --k, row += ROW) {
      if (test_row<true, COUNT>(row, ROW_SLOTS, is_tri, r, 0, t_limit, t_unused,
                                pp_unused, work)) {
        return true;
      }
    }
  }
}

// K5: one ray per thread, in the rays' (sorted) order. Per ray: every
// instance's world-AABB entry, world->object transform, then the walk; a
// lane with t_max <= 0 is inactive. COUNT adds the boxes and primitives
// tested to work_out[0..1] and the lane's boxes + primitives to the max
// slot of its warp, warp_max[i / 32] (the SIMD-efficiency count).
template <bool COUNT>
__global__ void __launch_bounds__(THREADS, ANYHIT_MIN_BLOCKS)
anyhit_kernel(const float* __restrict__ o, const float* __restrict__ d,
              const float* __restrict__ tmax, int n, AnyHitWalker wk,
              const int* __restrict__ inst_i, const float* __restrict__ inst_f,
              int n_inst, bool* __restrict__ occ_out,
              unsigned long long* __restrict__ work_out,
              unsigned* __restrict__ warp_max) {
  TRACE_SHARED_STACK(stack_mem);  // depth_cap x THREADS entries
  const int i = static_cast<int>(blockIdx.x * THREADS + threadIdx.x);
  if (i >= n) return;
  int* stack = stack_mem + threadIdx.x;
  const Ray w = load_ray(o, d, i);
  const float t_limit = tmax[i];
  Work work;
  bool occ = false;
  for (int k = 0; k < n_inst && t_limit > 0.0f && !occ; ++k) {
    const int* ii = inst_i + k * INST_I;
    const float* ff = inst_f + k * INST_F;
    if (COUNT) ++work.boxes;
    if (!slab(ff + 12, w, t_limit)) continue;
    const Ray r = ii[3] ? w : transform_ray(ff, w);
    occ = anyhit_walk<COUNT>(wk, r, ii[1], ii[0] == BLAS_TRI_MESH, t_limit, stack,
                             work);
  }
  occ_out[i] = occ;
  if (COUNT) {
    atomicAdd(work_out, static_cast<unsigned long long>(work.boxes));
    atomicAdd(work_out + 1, static_cast<unsigned long long>(work.prims));
    atomicMax(warp_max + (i >> 5), work.boxes + work.prims);
  }
}

// Launch K5 on `stream` (the counting variant when work_out is given).
// Returns cudaGetLastError().
inline int launch_anyhit(const float* o, const float* d, const float* tmax, int n,
                         const AnyHitWalker& wk, const int* inst_i,
                         const float* inst_f, int n_inst, bool* occ_out,
                         unsigned long long* work_out, unsigned* warp_max,
                         void* stream) {
  const int blocks = (n + THREADS - 1) / THREADS;
  const size_t smem = sizeof(int) * THREADS * (wk.depth_cap > 0 ? wk.depth_cap : 1);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (blocks > 0 && work_out != nullptr) {
    anyhit_kernel<true><<<blocks, THREADS, smem, s>>>(
        o, d, tmax, n, wk, inst_i, inst_f, n_inst, occ_out, work_out, warp_max);
  } else if (blocks > 0) {
    anyhit_kernel<false><<<blocks, THREADS, smem, s>>>(
        o, d, tmax, n, wk, inst_i, inst_f, n_inst, occ_out, nullptr, nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace trace
