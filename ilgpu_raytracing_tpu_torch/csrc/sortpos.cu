// K3: stable counting-sort destination of every lane for a small int key.
//
// Replaces the TPU kernel ilgpu_raytracing_tpu/ops/pallas/sortpos_kernel.py
// (_pos_kernel, launched by counting_pos, pallas_call at :135) and is equal,
// bit for bit, to the one-hot formulation of ops/sort.py:59-69: pos[i] =
// (lanes of smaller keys) + (earlier lanes with the same key).
//
// What bounds it on an H100: launch latency. At 1.8M lanes the key and pos
// arrays are 7.2 MB each (4.3 us at 3.35 TB/s); the work per lane is a
// handful of integer ops.
//
// Design. The TPU kernel relied on its grid running in order to carry a
// running per-bin prefix between blocks; Hopper blocks run in no order, so
// the carry becomes an explicit scan over tiles of TILE keys. Three
// launches, each spread over the whole card:
//   hist  one block per tile counts its keys per bin in shared memory (the
//         leader of each group of equal keys in a warp adds the group's
//         size) and writes the counts bin-major: counts[bin][tile];
//   scan  one block per bin turns its row of tile counts into exclusive
//         starts (a block-wide shuffle scan) and writes the bin's total;
//   rank  one block per tile scans the bin totals into bin starts, then
//         ranks its keys in lane order: warp w owns keys [w * 256, w * 256 +
//         256) of the tile, read as 8 rounds of 32 consecutive keys;
//         __match_any_sync groups equal keys of a round, __popc(peers &
//         lanemask_lt) ranks a lane among them, and a per-warp per-bin
//         running count in shared memory carries the rank across rounds.
//         The per-warp counts are prefix-summed in warp order. No atomics,
//         so ties keep lane order and the result is deterministic.
// A single-pass sweep with a decoupled look-back per bin (Merrill & Garland
// 2016) was the other candidate and is not used: every tile of a 1.8M-key
// sort is resident at once, so all tiles publish their aggregates together
// and the look-back of the last tiles walks about half the chain of
// predecessors, one dependent L2 round trip per step (hundreds of steps),
// where the per-bin scan costs one short launch. No pass runs on a single
// block or grows with bins x tiles in one block.
// A key outside [0, bins) fails a device-side assert in the histogram pass
// (the next synchronizing call raises, as PyTorch's index kernels do) and
// writes no position.

#include <cassert>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 512;  // hist and rank blocks
constexpr int WARPS = THREADS / 32;
constexpr int ROUNDS = 8;     // rounds of 32 keys per warp
constexpr int TILE = THREADS * ROUNDS;
constexpr int MAX_BINS = 384;
constexpr int SCAN_THREADS = 256;
constexpr unsigned FULL = 0xffffffffu;
static_assert(MAX_BINS <= THREADS, "the rank pass scans the bin totals in one pass");

__device__ __forceinline__ unsigned lanemask_lt() {
  return (1u << (threadIdx.x & 31)) - 1u;
}

// Inclusive scan of x over the block's warps; returns the exclusive prefix
// of the calling thread and sets *total (every thread) to the block's sum.
// wsum holds one int per warp. Every thread of the block must call it.
template <int NT>
__device__ __forceinline__ int block_exclusive_scan(int x, int* wsum, int* total) {
  constexpr int NW = NT / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int v = x;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(FULL, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) wsum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int s = lane < NW ? wsum[lane] : 0;
#pragma unroll
    for (int off = 1; off < NW; off <<= 1) {
      const int y = __shfl_up_sync(FULL, s, off);
      if (lane >= off) s += y;
    }
    if (lane < NW) wsum[lane] = s;
  }
  __syncthreads();
  *total = wsum[NW - 1];
  const int excl = (warp > 0 ? wsum[warp - 1] : 0) + x - v;
  __syncthreads();  // wsum may be reused by the caller's next scan
  return excl;
}

// Index of this thread's first key: warp w of tile t owns keys
// [t * TILE + w * 256, + 256), read as ROUNDS rounds of 32 consecutive keys.
__device__ __forceinline__ int first_key() {
  return blockIdx.x * TILE + (threadIdx.x >> 5) * (32 * ROUNDS) + (threadIdx.x & 31);
}

__global__ void __launch_bounds__(THREADS)
hist_kernel(const int* __restrict__ key, int n, int bins, int tiles,
            int* __restrict__ counts) {
  __shared__ int h[MAX_BINS];
  for (int b = threadIdx.x; b < bins; b += THREADS) h[b] = 0;
  const int base = first_key();
  int k[ROUNDS];
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
    const int i = base + r * 32;
    k[r] = i < n ? key[i] : 0;
  }
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
    assert(k[r] >= 0 && k[r] < bins);  // counting_pos: key outside [0, bins)
    if (base + r * 32 >= n || k[r] < 0 || k[r] >= bins) k[r] = -1;
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
    const unsigned peers = __match_any_sync(FULL, k[r]);
    if (k[r] >= 0 && (peers & lanemask_lt()) == 0) atomicAdd(&h[k[r]], __popc(peers));
  }
  __syncthreads();
  for (int b = threadIdx.x; b < bins; b += THREADS) counts[b * tiles + blockIdx.x] = h[b];
}

// counts[bin][0, tiles) -> exclusive starts in place; totals[bin] = sum.
__global__ void __launch_bounds__(SCAN_THREADS)
scan_kernel(int* __restrict__ counts, int tiles, int* __restrict__ totals) {
  __shared__ int wsum[SCAN_THREADS / 32];
  int* __restrict__ row = counts + blockIdx.x * tiles;
  int carry = 0;
  for (int c0 = 0; c0 < tiles; c0 += SCAN_THREADS) {
    const int j = c0 + threadIdx.x;
    int chunk;
    const int excl = block_exclusive_scan<SCAN_THREADS>(j < tiles ? row[j] : 0, wsum,
                                                        &chunk);
    if (j < tiles) row[j] = carry + excl;
    carry += chunk;
  }
  if (threadIdx.x == 0) totals[blockIdx.x] = carry;
}

__global__ void __launch_bounds__(THREADS)
rank_kernel(const int* __restrict__ key, int n, int bins, int tiles,
            const int* __restrict__ starts, const int* __restrict__ totals,
            int* __restrict__ pos) {
  __shared__ int wcount[WARPS * MAX_BINS];  // per warp, per bin
  __shared__ int start[MAX_BINS];           // bin start + earlier tiles' lanes
  __shared__ int wsum[WARPS];
  const int warp = threadIdx.x >> 5;
  for (int j = threadIdx.x; j < WARPS * bins; j += THREADS) wcount[j] = 0;
  {
    const int b = threadIdx.x;  // bins <= MAX_BINS <= THREADS
    int sum;
    const int excl = block_exclusive_scan<THREADS>(b < bins ? totals[b] : 0, wsum, &sum);
    if (b < bins) start[b] = excl + starts[b * tiles + blockIdx.x];
  }
  const int base = first_key();
  int k[ROUNDS];
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
    const int i = base + r * 32;
    k[r] = i < n ? key[i] : -1;
    if (k[r] >= bins) k[r] = -1;  // out of range: the histogram pass asserts
  }
  __syncthreads();

  int local[ROUNDS];
  int* mine = wcount + warp * bins;
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
    const unsigned peers = __match_any_sync(FULL, k[r]);
    const int rank = __popc(peers & lanemask_lt());
    const int before = k[r] >= 0 ? mine[k[r]] : 0;
    __syncwarp();
    if (k[r] >= 0 && rank == 0) mine[k[r]] = before + __popc(peers);
    __syncwarp();
    local[r] = before + rank;
  }
  __syncthreads();
  for (int b = threadIdx.x; b < bins; b += THREADS) {
    int run = start[b];
    for (int w = 0; w < WARPS; ++w) {
      const int v = wcount[w * bins + b];
      wcount[w * bins + b] = run;
      run += v;
    }
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) {
    if (k[r] >= 0) pos[base + r * 32] = mine[k[r]] + local[r];
  }
}

}  // namespace

extern "C" {

const char* sortpos_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

int sortpos_tile() { return TILE; }

int sortpos_max_bins() { return MAX_BINS; }

// scratch: bins * tiles + bins ints, tiles = ceil(n / TILE); bins in
// [1, MAX_BINS]. Three launches on `stream`, no host synchronization.
int sortpos_counting_pos(const int* key, int n, int bins, int* scratch, int* pos,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int tiles = (n + TILE - 1) / TILE;
  if (tiles > 0) {
    int* totals = scratch + bins * tiles;
    hist_kernel<<<tiles, THREADS, 0, s>>>(key, n, bins, tiles, scratch);
    scan_kernel<<<bins, SCAN_THREADS, 0, s>>>(scratch, tiles, totals);
    rank_kernel<<<tiles, THREADS, 0, s>>>(key, n, bins, tiles, scratch, totals, pos);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
