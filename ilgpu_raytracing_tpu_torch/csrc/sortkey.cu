// The bounce-ray sort key in one launch (ops/sort._ray_perm on the card;
// ops/cuda/sortkey.py binds it). One thread owns one ray and writes the
// int32 key that K3 (csrc/sortpos.cu) sorts by, in one of three variants:
//   TREELET  octant * T + the first of the T world boxes (32 on a
//            streaming scene) that the ray's slab entry reaches; a live
//            ray that misses every box gets 8T, a dead lane 8T + 1;
//   MORTON   octant * 16 + the 4-bit Morton code of the quantized origin;
//            a dead lane 128;
//   OCTANT   the direction octant; a dead lane 8.
//
// The plain version (ops/sort.ray_key_plain) builds the treelet key from
// an (N, T) float table of slab entries, 12 broadcast passes and 12
// min/max passes over it, then argmin and amin: about 15 GB of traffic a
// call on the 1,802,240 lanes of a 1080p terrain bounce. Here the boxes
// are read through the read-only cache (one address a warp: a broadcast)
// and the running minimum stays in registers: a lane reads its origin,
// direction and flag (25 B) and writes its key (4 B).
//
// Every operation follows the plain version's order and rounding, so the
// key equals PyTorch's bit for bit (compiled with --fmad=false, without
// fast math): inv = 1 / (d != 0 ? d : 1e-8) by IEEE division; t1 = (lo -
// o) * inv and t2 = (hi - o) * inv rounded apart; entry and exit folded
// over x, y, z from 1e-4 and +inf as torch.minimum / torch.maximum fold
// them, NaN included (see `slab`); the entry is +inf unless exit >= entry;
// the box is the first one holding the least entry (torch.argmin's tie
// rule), and the ray is covered when that entry is finite. The Morton
// variant clamps with torch.clamp's NaN rule and truncates to int32 as
// PyTorch's cast does.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace sortkey {

constexpr int THREADS = 256;
constexpr int OCTANT = 0;
constexpr int MORTON = 1;
constexpr int TREELET = 2;

// Python's double constants as PyTorch rounds them against a float32 tensor
constexpr float T_FLOOR = (float)1e-4;
constexpr float D_ZERO = (float)1e-8;

__device__ __forceinline__ int octant(float dx, float dy, float dz) {
  return (int(dx > 0.0f) << 2) | (int(dy > 0.0f) << 1) | int(dz > 0.0f);
}

// ops/sort._morton4's cell of one axis: clamp(((o - bmin) * inv_ext) * 4,
// 0, 3) with a NaN kept (torch.clamp), truncated to int32
__device__ __forceinline__ int cell(float o, float bmin, float inv_ext) {
  const float q = ((o - bmin) * inv_ext) * 4.0f;
  return (int)(q != q ? q : (q < 0.0f ? 0.0f : (q > 3.0f ? 3.0f : q)));
}

// One axis of ops/sort._slab_entry's fold. torch.minimum / torch.maximum
// carry a NaN t into the entry, which then fails `exit >= entry`: the box
// is a miss. So `nan` records a NaN t, and without one fminf / fmaxf fold
// the same values in one instruction each.
__device__ __forceinline__ void slab(float b_lo, float b_hi, float o, float inv, float& lo,
                                     float& hi, bool& nan) {
  const float t1 = (b_lo - o) * inv;
  const float t2 = (b_hi - o) * inv;
  nan |= (t1 != t1) | (t2 != t2);
  lo = fmaxf(lo, fminf(t1, t2));
  hi = fminf(hi, fmaxf(t1, t2));
}

template <int MODE>
__global__ void __launch_bounds__(THREADS)
    key_kernel(const float* __restrict__ o, const float* __restrict__ d,
               const bool* __restrict__ active, const float* __restrict__ boxes,
               int n_boxes, const float* __restrict__ bmin,
               const float* __restrict__ inv_ext, int* __restrict__ key, int n) {
  const long long i = (long long)blockIdx.x * THREADS + threadIdx.x;
  if (i >= n) return;
  const float dx = d[3 * i], dy = d[3 * i + 1], dz = d[3 * i + 2];
  const int oct = octant(dx, dy, dz);
  const bool live = active[i];
  if (MODE == OCTANT) {
    key[i] = live ? oct : 8;
    return;
  }
  const float ox = o[3 * i], oy = o[3 * i + 1], oz = o[3 * i + 2];
  if (MODE == MORTON) {
    if (!live) {
      key[i] = 128;
      return;
    }
    const int x = cell(ox, __ldg(bmin), __ldg(inv_ext));
    const int y = cell(oy, __ldg(bmin + 1), __ldg(inv_ext + 1));
    const int z = cell(oz, __ldg(bmin + 2), __ldg(inv_ext + 2));
    key[i] = oct * 16 + (((x & 2) << 2) | ((y & 2) << 1) | (z & 2) | (x & 1));
    return;
  }
  if (!live) {
    key[i] = 8 * n_boxes + 1;
    return;
  }
  const float ix = 1.0f / (dx != 0.0f ? dx : D_ZERO);
  const float iy = 1.0f / (dy != 0.0f ? dy : D_ZERO);
  const float iz = 1.0f / (dz != 0.0f ? dz : D_ZERO);
  float best = INFINITY;
  int tid = 0;
  for (int b = 0; b < n_boxes; ++b) {
    const float* box = boxes + 6 * b;
    float lo = T_FLOOR, hi = INFINITY;
    bool nan = false;
    slab(__ldg(box), __ldg(box + 3), ox, ix, lo, hi, nan);
    slab(__ldg(box + 1), __ldg(box + 4), oy, iy, lo, hi, nan);
    slab(__ldg(box + 2), __ldg(box + 5), oz, iz, lo, hi, nan);
    const float entry = !nan && hi >= lo ? lo : INFINITY;
    if (entry < best) {  // strict: the first box of the least entry
      best = entry;
      tid = b;
    }
  }
  // entries are >= 1e-4 or +inf, so finite means below +inf
  key[i] = best < INFINITY ? oct * n_boxes + tid : 8 * n_boxes;
}

template <int MODE>
cudaError_t launch(const float* o, const float* d, const bool* active, const float* boxes,
                   int n_boxes, const float* bmin, const float* inv_ext, int* key, int n,
                   cudaStream_t s) {
  const int blocks = (int)(((long long)n + THREADS - 1) / THREADS);
  key_kernel<MODE><<<blocks, THREADS, 0, s>>>(o, d, active, boxes, n_boxes, bmin, inv_ext,
                                              key, n);
  return cudaGetLastError();
}

}  // namespace sortkey

extern "C" {

// mode: 0 octant, 1 Morton (bmin, inv_ext: 3 floats each), 2 treelet
// (boxes: n_boxes rows of lo xyz, hi xyz); o and d are n rows of 3 floats.
int sortkey_key(const float* o, const float* d, const bool* active, const float* boxes,
                int n_boxes, const float* bmin, const float* inv_ext, int* key, int n,
                int mode, void* stream) {
  if (n <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (mode == sortkey::TREELET)
    return sortkey::launch<sortkey::TREELET>(o, d, active, boxes, n_boxes, bmin, inv_ext,
                                             key, n, s);
  if (mode == sortkey::MORTON)
    return sortkey::launch<sortkey::MORTON>(o, d, active, boxes, n_boxes, bmin, inv_ext,
                                            key, n, s);
  return sortkey::launch<sortkey::OCTANT>(o, d, active, boxes, n_boxes, bmin, inv_ext,
                                          key, n, s);
}

const char* sortkey_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}
