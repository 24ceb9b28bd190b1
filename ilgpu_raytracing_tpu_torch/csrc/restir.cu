// ReSTIR DI in one launch: candidates, temporal and spatial reuse and
// selection for every lane of a bounce (ops/restir.restir_direct on the
// card; ops/cuda/restir.py binds it).
//
// It replaces no kernel of the JAX package: there ReSTIR is XLA-fused glue.
// Run eagerly in PyTorch, the same body issues 1,243 (candidates only) to
// 3,564 (with reuse) operations a call, the spatial reuse alone rebuilding
// 19-channel images 64 times. Here one thread owns one lane and computes,
// in the order of the plain version:
//   1. `local` cosine-hemisphere sky candidates and one sun candidate,
//      streamed through the masked reservoir update;
//   2. the temporal import: the lane's point reprojected into the previous
//      camera, the row there re-scored after the compatibility test;
//   3. eight spatial imports: the canonical pixel's hashed rotation and
//      radius pick its neighbours, whose rows the thread reads in place from
//      the previous reservoirs and the G-buffer (a neighbour off the image
//      is an invalid row);
//   4. selection: Z-counting (or the reference's weighting) and the
//      selected sample's shading quantities.
// Every lane draws the same random numbers as the plain version, masked
// lanes included, so the RNG streams stay bit-identical.
//
// Bound: a lane reads 33 bytes (47 with reuse) and writes 70; with reuse
// each pixel's G-buffer row and previous reservoir row (60 bytes) is read
// by the nine lanes that import it, all within two pixels, so from L1/L2
// after the first. On an H100 the 1,802,240 lanes of a 1080p bench bounce
// take 0.45 ms with reuse and 0.17 without, 5.6x and 3.0x their byte bound:
// the candidates' sin/cos, square roots and IEEE divisions, kept exact for
// the comparison with PyTorch, set the time, not memory.
//
// Compiled with --fmad=false and without fast math, and every expression
// is written in the plain version's operation order (sums left to right,
// clamps that keep NaN), so on the card each output equals PyTorch's eager
// result bit for bit. The host build (ops/cuda/host_check.py) divides for
// rsqrt, as PyTorch's CPU kernels do.

#include <cassert>
#include <cstdint>
#include <cuda_runtime.h>

namespace restir {

constexpr int THREADS = 128;
constexpr int LIGHT_ENV = 1;
constexpr int LIGHT_SUN = 2;
constexpr int BLOCK_LOG2 = 6;
constexpr int BLOCK = 1 << BLOCK_LOG2;
constexpr int NEIGHBORS = 8;

// Python's double constants as PyTorch rounds them against a float32 tensor
constexpr float EPS_MIN = (float)1e-6;
constexpr float INV_PI = (float)0.31830988618379067154;
constexpr float TWO_PI = (float)(2.0 * 3.141592653589793);
constexpr float NORM_EPS = (float)1e-20;
constexpr float INV_2_24 = (float)(1.0 / 16777216.0);

// The call's arguments, copied by value into the kernel's parameters; the
// field order is ops/cuda/restir._Args's.
struct Args {
  // inputs, one row a lane
  const int64_t* state;  // uint32 values
  const bool* active;
  const bool* en_t;
  const bool* en_s;
  const float* pos;
  const float* nrm;
  const float* alb;
  const int* pixel_idx;
  const float* cam_origin;  // 3 floats on the device
  // full-image G-buffer and previous reservoirs (reuse only)
  const float* gb_pos;
  const float* gb_nrm;
  const int* gb_obj;
  const float* prev_wi;
  const float* prev_w;
  const float* prev_w_sum;
  const int* prev_m;
  const int* prev_light_id;
  const float* prev_W;
  // outputs
  int64_t* state_out;
  float* L;
  float* wi;
  float* pdf;
  float* w;
  float* w_sum;
  int* m;
  int* light_id;
  float* W;
  bool* ok;
  float* contrib;
  bool* is_sun;
  // sizes and switches
  int n;            // lanes
  int width, height;
  int n_res;        // rows of the G-buffer and previous reservoirs
  int reps;         // sample views stacked over the pixels
  int pixel_major;  // a pixel's views adjacent (else stacked tiles)
  int local_candidates;
  unsigned frame;
  // previous camera, sun and sky
  float prev_origin[3], prev_right[3], prev_up[3], prev_forward[3];
  float prev_fov_y, prev_aspect;
  float sun_dir[3], sun_radiance[3], sky_top[3], sky_bottom[3];
  float mix_local;  // selection pdf factor of a local candidate
  float pdf_delta;  // max(EPS_MIN, mix of the sun candidate)
};

struct f3 {
  float x, y, z;
};

__device__ __forceinline__ f3 load3(const float* p, int i) {
  return {p[3 * i], p[3 * i + 1], p[3 * i + 2]};
}

__device__ __forceinline__ void store3(float* p, int i, f3 v) {
  p[3 * i] = v.x;
  p[3 * i + 1] = v.y;
  p[3 * i + 2] = v.z;
}

__device__ __forceinline__ f3 arr3(const float* a) { return {a[0], a[1], a[2]}; }

__device__ __forceinline__ f3 sub3(f3 a, f3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }

__device__ __forceinline__ float dot3(f3 a, f3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }

__device__ __forceinline__ f3 cross3(f3 a, f3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

// torch.clamp(x, min=lo): NaN stays NaN
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x != x ? x : fmaxf(x, lo);
}

__device__ __forceinline__ float rsqrt_(float x) {
#ifdef __CUDACC__
  return rsqrtf(x);
#else
  return 1.0f / sqrtf(x);
#endif
}

// utils/vec.normalize
__device__ __forceinline__ f3 normalize3(f3 v) {
  const float inv = rsqrt_(clamp_min(dot3(v, v), NORM_EPS));
  return {v.x * inv, v.y * inv, v.z * inv};
}

__device__ __forceinline__ float length3(f3 v) { return sqrtf(dot3(v, v)); }

// utils/vec.luminance of (albedo * li) * k
__device__ __forceinline__ float lum_of(f3 alb, f3 li, float k) {
  return (float)0.2126 * ((alb.x * li.x) * k) + (float)0.7152 * ((alb.y * li.y) * k) +
         (float)0.0722 * ((alb.z * li.z) * k);
}

// ops/sky.sky_radiance
__device__ __forceinline__ f3 sky(f3 d, const Args& a) {
  const float t = 0.5f * (d.y + 1.0f);
  const float s = 1.0f - t;
  return {a.sky_bottom[0] * s + a.sky_top[0] * t, a.sky_bottom[1] * s + a.sky_top[1] * t,
          a.sky_bottom[2] * s + a.sky_top[2] * t};
}

// ops/sampling.cos_hemisphere_pdf
__device__ __forceinline__ float cos_pdf(f3 n, f3 wi) {
  return clamp_min(dot3(n, wi), 0.0f) * INV_PI;
}

// utils/rng
__device__ __forceinline__ unsigned hash32(unsigned x) {
  x ^= x >> 17;
  x *= 0xED5AD4BBu;
  x ^= x >> 11;
  x *= 0xAC4C1B51u;
  x ^= x >> 15;
  x *= 0x31848BABu;
  x ^= x >> 14;
  return x;
}

__device__ __forceinline__ float next_float(unsigned& s) {
  unsigned x = s;
  x ^= x << 13;
  x ^= x >> 17;
  x ^= x << 5;
  s = x != 0u ? x : 1u;
  return (float)(s & 0x00FFFFFFu) * INV_2_24;
}

// ops/layout
__device__ __forceinline__ bool blocked(const Args& a) {
  return a.width % BLOCK == 0 && a.height % BLOCK == 0 && a.width > 0 && a.height > 0;
}

__device__ __forceinline__ void xy_from_position(int p, const Args& a, int& x, int& y) {
  if (!blocked(a)) {
    x = p % a.width;
    y = p / a.width;
    return;
  }
  const int blocks_x = a.width >> BLOCK_LOG2;
  const int b = p >> (2 * BLOCK_LOG2);
  const int l = p & (BLOCK * BLOCK - 1);
  x = ((b % blocks_x) << BLOCK_LOG2) | (l & (BLOCK - 1));
  y = ((b / blocks_x) << BLOCK_LOG2) | (l >> BLOCK_LOG2);
}

__device__ __forceinline__ int position_from_xy(int x, int y, const Args& a) {
  if (!blocked(a)) return y * a.width + x;
  const int blocks_x = a.width >> BLOCK_LOG2;
  const int b = (y >> BLOCK_LOG2) * blocks_x + (x >> BLOCK_LOG2);
  const int l = ((y & (BLOCK - 1)) << BLOCK_LOG2) | (x & (BLOCK - 1));
  return (b << (2 * BLOCK_LOG2)) | l;
}

struct Reservoir {
  f3 L{0.0f, 0.0f, 0.0f}, wi{0.0f, 0.0f, 0.0f};
  float pdf = 0.0f, w = 0.0f, w_sum = 0.0f;
  int m = 0, light_id = 0;
};

// Offset k of the 8-neighbourhood base pattern (ops/restir._NEIGHBOR_BASE):
// (-1,0) (1,0) (0,-1) (0,1) (-1,-1) (1,-1) (-1,1) (1,1)
__device__ __forceinline__ void neighbor_base(int k, int& cx, int& cy) {
  cx = k < 4 ? (k == 0 ? -1 : k == 1 ? 1 : 0) : ((k & 1) ? 1 : -1);
  cy = k < 4 ? (k == 2 ? -1 : k == 3 ? 1 : 0) : (k < 6 ? -1 : 1);
}

// ops/restir.reservoir_update: one draw whether or not `mask` holds
__device__ __forceinline__ void update(Reservoir& r, unsigned& state, f3 wi, float pdf_sel,
                                       f3 li, float score, float s_hat, int light_id,
                                       bool mask) {
  const float add = mask ? score : 0.0f;
  const float new_sum = r.w_sum + add;
  const float accept_p = new_sum > 0.0f ? add / clamp_min(new_sum, EPS_MIN) : 0.0f;
  const float u = next_float(state);
  if (mask && u < accept_p) {
    r.L = li;
    r.wi = wi;
    r.pdf = pdf_sel;
    r.w = s_hat;
    r.light_id = light_id;
  }
  if (mask) {
    r.w_sum = new_sum;
    r.m += 1;
  }
}

// The lane's own pixel, as the compatibility test sees it
struct Own {
  float obj;  // obj_id as the packed float row carries it
  float z;    // distance to the camera
};

// ops/restir._import_rows for the row at `r` (when `valid`): the
// compatibility test, the row's re-score and the merge. Returns whether the
// import entered the stream; `n_b` gets the row's normal.
template <bool REF>
__device__ __forceinline__ bool import_row(Reservoir& res, unsigned& state, int r, bool valid,
                                           const Own& own, f3 cam, f3 n, f3 alb, f3& n_b,
                                           const Args& a) {
  f3 wi{0.0f, 0.0f, 0.0f}, li{0.0f, 0.0f, 0.0f};
  float pdf_here = 0.0f, eff = 0.0f, s_hat = 0.0f;
  int lid = LIGHT_ENV;
  n_b = {0.0f, 0.0f, 0.0f};
  if (valid) {
    n_b = normalize3(load3(a.gb_nrm, r));
    const float z_b = length3(sub3(load3(a.gb_pos, r), cam));
    const float ndot = dot3(n, n_b);
    const float rel = fabsf(own.z - z_b) / clamp_min(own.z, (float)1e-3);
    const float obj_b = (float)a.gb_obj[r];
    valid = own.obj == obj_b || (ndot >= (float)0.85 && rel < (float)0.05);
  }
  if (valid) {
    const int m_b = (int)(float)a.prev_m[r];
    const float w_b = a.prev_w[r];
    const float w_sum_b = a.prev_w_sum[r];
    valid = m_b > 0 && w_b > 0.0f && w_sum_b > 0.0f;
    const float W_b = REF ? 0.0f : a.prev_W[r];
    if (!REF) valid = valid && W_b > 0.0f;
    if (valid) {
      wi = load3(a.prev_wi, r);
      const bool is_sun = (int)(float)a.prev_light_id[r] == LIGHT_SUN;
      li = is_sun ? arr3(a.sun_radiance) : sky(wi, a);
      const float nl = clamp_min(dot3(n, wi), 0.0f);
      pdf_here = is_sun ? a.pdf_delta : clamp_min(cos_pdf(n, wi) * a.mix_local, EPS_MIN);
      if (REF) {
        const float w_src =
            w_sum_b / ((float)(m_b > 1 ? m_b : 1) * clamp_min(w_b, EPS_MIN));
        eff = lum_of(alb, li, (nl / pdf_here) * INV_PI) * w_src;
        s_hat = eff;
      } else {
        s_hat = lum_of(alb, li, nl * INV_PI);
        eff = s_hat * W_b;
      }
      lid = is_sun ? LIGHT_SUN : LIGHT_ENV;
    }
  }
  update(res, state, wi, pdf_here, li, eff, s_hat, lid, valid);
  return valid;
}

// ops/restir.reproject_to_prev_pixel
__device__ __forceinline__ int reproject(f3 pos, const Args& a) {
  const f3 p = sub3(pos, arr3(a.prev_origin));
  const float x = dot3(p, arr3(a.prev_right));
  const float y = dot3(p, arr3(a.prev_up));
  const float z = dot3(p, arr3(a.prev_forward));
  const bool ok = z > (float)1e-4;
  const float z_safe = ok ? z : 1.0f;
  const float tan_half = tanf(0.5f * a.prev_fov_y);
  const float ndc_x = x / (z_safe * tan_half * a.prev_aspect);
  const float ndc_y = y / (z_safe * tan_half);
  const int px = (int)floorf(0.5f * (ndc_x + 1.0f) * (float)a.width);
  const int py = (int)floorf(0.5f * (ndc_y + 1.0f) * (float)a.height);
  const bool inside = px >= 0 && px < a.width && py >= 0 && py < a.height;
  return ok && inside ? position_from_xy(px, py, a) : -1;
}

template <bool REF, bool REUSE>
__global__ void __launch_bounds__(THREADS) restir_kernel(const Args a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  unsigned state = (unsigned)a.state[i];
  const bool active = a.active[i];
  const f3 n = load3(a.nrm, i);
  const f3 alb = load3(a.alb, i);
  Reservoir res;

  // (1) local sky candidates (ops/sampling.sample_hemisphere_cosine)
  for (int c = 0; c < a.local_candidates; ++c) {
    const float r1 = next_float(state);
    const float r2 = next_float(state);
    const float phi = TWO_PI * r1;
    const float cos_theta = sqrtf(1.0f - r2);
    const float sin_theta = sqrtf(r2);
    const float x = cosf(phi) * sin_theta;
    const float y = sinf(phi) * sin_theta;
    const float z = cos_theta;
    const f3 up = fabsf(n.y) < (float)0.999 ? f3{0.0f, 1.0f, 0.0f} : f3{1.0f, 0.0f, 0.0f};
    const f3 t = normalize3(cross3(up, n));
    const f3 b = cross3(n, t);
    const f3 wi = normalize3({t.x * x + b.x * y + n.x * z, t.y * x + b.y * y + n.y * z,
                              t.z * x + b.z * y + n.z * z});
    const float nl = clamp_min(dot3(n, wi), 0.0f);
    const float pdf_local = clamp_min(cos_pdf(n, wi), EPS_MIN);
    const float pdf_sel = clamp_min(pdf_local * a.mix_local, EPS_MIN);
    const f3 li = sky(wi, a);
    const float s_hat = lum_of(alb, li, nl * INV_PI);
    const float s = s_hat / pdf_sel;
    update(res, state, wi, pdf_sel, li, s, REF ? s : s_hat, LIGHT_ENV, active);
  }

  // (2) the sun's delta candidate
  {
    const f3 wi = normalize3(arr3(a.sun_dir));
    const f3 li = arr3(a.sun_radiance);
    const float nl = clamp_min(dot3(n, wi), 0.0f);
    const float s_hat = lum_of(alb, li, nl * INV_PI);
    const float s = s_hat / a.pdf_delta;
    update(res, state, wi, a.pdf_delta, li, s, REF ? s : s_hat, LIGHT_SUN, active);
  }

  // per import: entered the stream, and the source's normal (Z-counting)
  bool vld[1 + NEIGHBORS];
  f3 n_src[1 + NEIGHBORS];
  if (REUSE) {
    const f3 cam = arr3(a.cam_origin);
    // the lane's canonical pixel: its row of the first sample view
    const int row = a.pixel_major ? i - i % a.reps : i % (a.n / a.reps);
    const int p_own = a.pixel_idx[row];
    assert(p_own >= 0 && p_own < a.n_res);
    const Own own{(float)a.gb_obj[p_own], length3(sub3(load3(a.gb_pos, p_own), cam))};

    // (3) temporal reuse via camera reprojection
    const int prev_idx = reproject(load3(a.pos, i), a);
    const bool act_t = active && a.en_t[i];
    vld[0] = import_row<REF>(res, state, prev_idx, act_t && prev_idx >= 0 && prev_idx < a.n_res,
                             own, cam, n, alb, n_src[0], a);

    // (4) spatial reuse: the canonical pixel's hashed rotation and radius
    int x, y;
    xy_from_position(p_own, a, x, y);
    const unsigned fh = hash32(a.frame ^ hash32(0xB31F5AB1u));
    const unsigned h = hash32((unsigned)(y * a.width + x) ^ fh);
    const int rot = (int)(h & 3u);
    const int rad = 1 + (int)((h >> 2) & 1u);
    const bool act_s = active && a.en_s[i];
#pragma unroll
    for (int k = 0; k < NEIGHBORS; ++k) {
      int cx, cy;
      neighbor_base(k, cx, cy);
      const int rcx = rot == 0 ? cx : rot == 1 ? -cy : rot == 2 ? -cx : cy;
      const int rcy = rot == 0 ? cy : rot == 1 ? cx : rot == 2 ? -cy : -cx;
      const int nx = x + rcx * rad, ny = y + rcy * rad;
      const bool inb = nx >= 0 && nx < a.width && ny >= 0 && ny < a.height;
      vld[1 + k] = import_row<REF>(res, state, inb ? position_from_xy(nx, ny, a) : 0,
                                   act_s && inb, own, cam, n, alb, n_src[1 + k], a);
    }
  }

  // (5) selection shading (visibility is the caller's)
  bool ok = active && res.m > 0 && res.w_sum > 0.0f && res.w > 0.0f;
  const f3 wi = res.wi;
  const bool is_sun = res.light_id == LIGHT_SUN;
  const float nl = clamp_min(dot3(n, wi), 0.0f);
  ok = ok && nl > 0.0f;
  const f3 li = is_sun ? arr3(a.sun_radiance) : sky(wi, a);
  float z_count;
  if (REF) {
    z_count = (float)(res.m > 1 ? res.m : 1);
  } else {
    // Z-counting: discount accepted imports whose source could not have
    // produced the winner (winner below the source's horizon)
    float z_sub = 0.0f;
    if (REUSE) {
#pragma unroll
      for (int k = 0; k < 1 + NEIGHBORS; ++k)
        z_sub = z_sub + ((vld[k] && dot3(n_src[k], wi) <= 0.0f) ? 1.0f : 0.0f);
    }
    z_count = clamp_min((float)res.m - z_sub, 1.0f);
  }
  const float w_ucw = res.w_sum / z_count / clamp_min(res.w, EPS_MIN);
  float k;
  if (REF) {
    const float pdf_sel =
        is_sun ? a.pdf_delta : clamp_min(cos_pdf(n, wi) * a.mix_local, EPS_MIN);
    k = (nl / pdf_sel) * INV_PI;
  } else {
    k = nl * INV_PI;
  }
  const f3 contrib{((alb.x * li.x) * k) * w_ucw, ((alb.y * li.y) * k) * w_ucw,
                   ((alb.z * li.z) * k) * w_ucw};

  a.state_out[i] = (int64_t)state;
  store3(a.L, i, res.L);
  store3(a.wi, i, wi);
  a.pdf[i] = res.pdf;
  a.w[i] = res.w;
  a.w_sum[i] = res.w_sum;
  a.m[i] = res.m;
  a.light_id[i] = res.light_id;
  a.W[i] = ok ? w_ucw : 0.0f;
  a.ok[i] = ok;
  store3(a.contrib, i, contrib);
  a.is_sun[i] = is_sun;
}

template <bool REF, bool REUSE>
cudaError_t launch(const Args& a, cudaStream_t s) {
  const int blocks = (a.n + THREADS - 1) / THREADS;
  restir_kernel<REF, REUSE><<<blocks, THREADS, 0, s>>>(a);
  return cudaGetLastError();
}

}  // namespace restir

extern "C" {

int restir_args_bytes() { return (int)sizeof(restir::Args); }

int restir_direct(const restir::Args* args, int reference_weighting, int static_reuse,
                  void* stream) {
  if (args->n == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (reference_weighting)
    return static_reuse ? restir::launch<true, true>(*args, s)
                        : restir::launch<true, false>(*args, s);
  return static_reuse ? restir::launch<false, true>(*args, s)
                      : restir::launch<false, false>(*args, s);
}

const char* restir_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}
