// K3: stable counting-sort destination of every lane for a small int key.
//
// Replaces the TPU kernel ilgpu_raytracing_tpu/ops/pallas/sortpos_kernel.py
// (_pos_kernel, launched by counting_pos, pallas_call at :135) and is equal,
// bit for bit, to the one-hot formulation of ops/sort.py:59-69: pos[i] =
// (lanes of smaller keys) + (earlier lanes with the same key).
//
// What bounds it on an H100: HBM traffic and launch latency. At 1.8M lanes
// the key and pos arrays are 7.2 MB each; the work per lane is a handful of
// integer ops, so the kernel is a few passes over memory plus the latency of
// three dependent launches.
//
// Design. The TPU kernel relied on its grid running in order to carry a
// running per-bin prefix between blocks; Hopper blocks run in no order, so
// the carry becomes an explicit scan:
//   pass 1  per-block histograms in shared memory (atomics are fine here:
//           counts do not depend on order), written bin-major: counts[bin][blk];
//   scan    one block turns the (bin, block) table into exclusive starts, so
//           start[bin][blk] = lanes of smaller bins + earlier blocks' lanes of
//           this bin;
//   pass 2  a deterministic rank inside the block: __match_any_sync groups
//           equal keys of a warp, __popc(peers & lanemask_lt) ranks a lane
//           among them, and per-warp per-bin counts in shared memory are
//           prefix-summed in warp order. No atomics, so ties keep lane order.
// A key outside [0, bins) sets *bad and the Python wrapper raises.

#include <cuda_runtime.h>

namespace {

constexpr int BLOCK = 1024;  // lanes per block = threads per block
constexpr int WARPS = BLOCK / 32;

__global__ void hist_kernel(const int* __restrict__ key, int n, int bins, int nb,
                            int* __restrict__ counts, int* __restrict__ bad) {
  extern __shared__ int h[];
  for (int b = threadIdx.x; b < bins; b += BLOCK) h[b] = 0;
  __syncthreads();
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  if (i < n) {
    const int k = key[i];
    if (k >= 0 && k < bins) {
      atomicAdd(&h[k], 1);
    } else {
      atomicExch(bad, 1);
    }
  }
  __syncthreads();
  for (int b = threadIdx.x; b < bins; b += BLOCK) counts[b * nb + blockIdx.x] = h[b];
}

// Exclusive scan of data[0, total) in place, one block of BLOCK threads:
// each thread sums a contiguous chunk, the chunk sums are scanned in shared
// memory, then each thread rewrites its chunk with running starts.
__global__ void scan_kernel(int* __restrict__ data, int total) {
  __shared__ int sums[BLOCK];
  const int per = (total + BLOCK - 1) / BLOCK;
  const int tid = static_cast<int>(threadIdx.x);
  const int start = min(tid * per, total);
  const int end = min(start + per, total);
  int s = 0;
  for (int k = start; k < end; ++k) s += data[k];
  sums[tid] = s;
  __syncthreads();
  for (int off = 1; off < BLOCK; off <<= 1) {
    const int v = tid >= off ? sums[tid - off] : 0;
    __syncthreads();
    sums[tid] += v;
    __syncthreads();
  }
  int run = tid > 0 ? sums[tid - 1] : 0;
  for (int k = start; k < end; ++k) {
    const int v = data[k];
    data[k] = run;
    run += v;
  }
}

__global__ void rank_kernel(const int* __restrict__ key, int n, int bins, int nb,
                            const int* __restrict__ starts, int* __restrict__ pos) {
  extern __shared__ int wcount[];  // [WARPS][bins]
  for (int k = threadIdx.x; k < WARPS * bins; k += BLOCK) wcount[k] = 0;
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * BLOCK + threadIdx.x;
  int k = i < n ? key[i] : -1;
  if (k >= bins) k = -1;  // out of range: flagged by hist_kernel
  const unsigned peers = __match_any_sync(0xffffffffu, k);
  const int rank = __popc(peers & ((1u << lane) - 1u));
  if (k >= 0 && rank == 0) wcount[warp * bins + k] = __popc(peers);
  __syncthreads();
  for (int b = threadIdx.x; b < bins; b += BLOCK) {
    int run = 0;
    for (int w = 0; w < WARPS; ++w) {
      const int v = wcount[w * bins + b];
      wcount[w * bins + b] = run;
      run += v;
    }
  }
  __syncthreads();
  if (k >= 0) pos[i] = starts[k * nb + blockIdx.x] + wcount[warp * bins + k] + rank;
}

}  // namespace

extern "C" {

const char* sortpos_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int sortpos_block() { return BLOCK; }

// Shared memory of the rank pass is WARPS * bins ints; callers keep bins
// within the 48 KB default (bins <= 384).
int sortpos_counting_pos(const int* key, int n, int bins, int* counts, int* pos,
                         int* bad, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int nb = (n + BLOCK - 1) / BLOCK;
  if (nb > 0) {
    hist_kernel<<<nb, BLOCK, bins * sizeof(int), s>>>(key, n, bins, nb, counts, bad);
    scan_kernel<<<1, BLOCK, 0, s>>>(counts, bins * nb);
    rank_kernel<<<nb, BLOCK, WARPS * bins * sizeof(int), s>>>(key, n, bins, nb,
                                                              counts, pos);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
