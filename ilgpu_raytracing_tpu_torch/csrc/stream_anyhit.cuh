// K5's kernel (stream_trace.cu): the any-hit walk of node_walk.cuh over the
// quantized records of stream_nodes.cuh, one ray per thread, built for
// occlusion alone: children in slot order with no order word, node
// groups on a stack in shared memory (depth x 128 threads x 4 bytes per
// block, 6 KB on the 1M-triangle terrain) bounded by the host's wide depth,
// and lanes that visit nodes until they hold a hit leaf, then test one leaf
// together.
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
  QuantNodes nd;   // records and leaf rows (no order words)
  int depth_cap;   // the host's bound on the wide depth
};

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
    occ = anyhit_walk<COUNT>(wk.nd, r, ii[1], ii[0] == BLAS_TRI_MESH, t_limit,
                             wk.depth_cap, stack, work);
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
