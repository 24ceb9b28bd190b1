// A bounce's lane updates in two launches (ops/integrator.scatter and
// ops/integrator.resolve on the card; ops/cuda/bounce.py binds them).
//
// It replaces no kernel of the JAX package: there a bounce is XLA-fused
// glue. Run eagerly in PyTorch, the same bodies issue about 400 operations
// a bounce over every lane (the material branches, the visibility and
// scatter rays, the reservoir merge, the RNG's masked int64 arithmetic, a
// `where` a carried field), each reading and writing whole (n, 3) float
// tensors. ReSTIR (csrc/restir.cu), the traces and hit shading
// (csrc/shade.cu) sit between the two halves, so a bounce takes two
// launches; one thread owns one lane in each:
//   scatter  after ReSTIR: the mirror, glass (Snell, Schlick, the glass
//            draw) and lambert branches, the visibility ray (origin,
//            weight, the bounce-0 sun substitution, its roulette), the
//            reservoir merge, the cosine-hemisphere sample, Russian
//            roulette, the scatter ray and throughput, and on the final
//            bounce of a scene without alpha the sky ray's weight and
//            roulette;
//   resolve  after the traces: the visibility result and the escaped ray's
//            sky radiance added in the plain body's order, the carry moved
//            to the hit surface (or, on the final bounce, the sky test's
//            verdict), and the next bounce's glass draw.
// Every lane is updated, dead or alive, and draws the plain body's random
// numbers (uint32 here, int64 there): the glass draw is the state ReSTIR
// was handed, then ReSTIR's own, the shadow roulette's side draw, two
// hemisphere draws, the roulette draw and the sky roulette's side draw.
//
// Bound: memory. A lane's state is read once and written once: `scatter`
// passes 352 bytes a lane at bounce 0 (221 in, 131 out) and `resolve` 240
// (163 in, 77 out), less the side of each select a lane does not take (one
// of the two reservoirs, the hit surface or the carry). On an H100 at the
// 14,417,920 lanes of a 16-spp bounce `scatter` takes 1.66 ms and
// `resolve` 1.03 ms, against 29.9 and 3.7 ms for the plain bodies.
//
// Compiled with --fmad=false and without fast math, and every expression is
// written in the plain body's operation order (sums left to right, clamps
// and maxima that keep NaN, `1 / x` as PyTorch's reciprocal), so on the card
// each output equals PyTorch's eager result bit for bit. The host build
// (ops/cuda/host_check.py) divides for rsqrt, as PyTorch's CPU kernels do.

#include <cstdint>
#include <cuda_runtime.h>

namespace bounce {

constexpr int THREADS = 256;
constexpr int SHADING_LAMBERT = 0;
constexpr int SHADING_MIRROR = 1;
constexpr int SHADING_GLASS = 2;
constexpr unsigned SALT_SHADOW_RR = 0x53484457u;
constexpr unsigned SALT_SKY_RR = 0x534B5952u;

// Python's double constants as PyTorch rounds them against a float32 tensor
constexpr float TWO_PI = (float)(2.0 * 3.141592653589793);
constexpr float NORM_EPS = (float)1e-20;
constexpr float INV_2_24 = (float)(1.0 / 16777216.0);
constexpr float UP_Y = (float)0.999;
constexpr float LUM_R = (float)0.2126;
constexpr float LUM_G = (float)0.7152;
constexpr float LUM_B = (float)0.0722;

// The calls' arguments, copied by value into the kernels' parameters; the
// field order is ops/cuda/bounce._ScatterArgs's and _ResolveArgs's.
struct ScatterArgs {
  // the bounce's carry (ops/integrator.PathLanes), `state` as ReSTIR took it
  const float* pos;
  const float* nrm;
  const float* alb;
  const int* shade;
  const float* ior;
  const float* thr;
  const float* li;
  const bool* alive;
  const float* view;
  const int64_t* state;
  const bool* wrote;
  // the carried reservoirs
  const float* cur_L;
  const float* cur_wi;
  const float* cur_pdf;
  const float* cur_w;
  const float* cur_w_sum;
  const int* cur_m;
  const int* cur_light_id;
  const float* cur_W;
  // ReSTIR's results: its state, reservoirs and selection
  const int64_t* state_rs;
  const float* out_L;
  const float* out_wi;
  const float* out_pdf;
  const float* out_w;
  const float* out_w_sum;
  const int* out_m;
  const int* out_light_id;
  const float* out_W;
  const bool* ok;
  const float* sel_wi;
  const float* contrib;
  const bool* is_sun;
  // bounce 0: the frame's sun occlusion and direction (3 floats on the
  // device); null on later bounces
  const bool* sun_occ;
  const float* sun_dir;
  // outputs (ops/integrator.Scattered)
  float* o_li;
  float* o_shadow_o;
  float* o_contrib_w;
  bool* o_q_act;
  float* o_res_L;
  float* o_res_wi;
  float* o_res_pdf;
  float* o_res_w;
  float* o_res_w_sum;
  int* o_res_m;
  int* o_res_light_id;
  float* o_res_W;
  bool* o_wrote;
  float* o_new_dir;
  float* o_ray_o;
  float* o_thr;
  bool* o_trace_active;
  int64_t* o_state;
  float* o_sky_w;  // `sky` only
  bool* o_sky_act;
  // sizes and switches
  int n;
  int rr_on;   // the bounce is at or past rr_start_depth
  int vis_rr;  // visibility-ray roulette (shadow_rr_lum > 0)
  int sky;     // the final bounce's sky ray
  float eps_n, inv_lum, pmin, rr_lo, rr_hi;
  float sky_top[3], sky_bottom[3];
};

struct ResolveArgs {
  // scatter's results
  const float* li;
  const bool* q_act;
  const float* contrib_w;
  const int64_t* state;
  const bool* shadow_occ;  // null: the visibility rays were queued
  // the final bounce's sky test
  const float* sky_w;
  const bool* sky_act;
  const bool* sky_occ;  // null: queued
  // the closest-hit bounce
  const bool* trace_active;
  const float* thr;
  const float* new_dir;
  const float* hit_t;
  const float* surf_pos;
  const float* surf_nrm;
  const float* surf_alb;
  const int* surf_shade;
  const float* surf_ior;
  const float* pos;
  const float* nrm;
  const float* alb;
  const int* shade;
  const float* ior;
  const float* view;
  // outputs (ops/integrator.PathLanes; the carry's fields only without `sky`)
  float* o_li;
  bool* o_alive;
  int64_t* o_state;
  float* o_pos;
  float* o_nrm;
  float* o_alb;
  int* o_shade;
  float* o_ior;
  float* o_view;
  int n;
  int sky;
  float hit_max;  // ops/intersect.T_HIT_MAX as float32
  float sky_top[3], sky_bottom[3];
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

__device__ __forceinline__ f3 add3(f3 a, f3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }

__device__ __forceinline__ f3 mul3(f3 a, f3 b) { return {a.x * b.x, a.y * b.y, a.z * b.z}; }

__device__ __forceinline__ f3 scale3(f3 a, float k) { return {a.x * k, a.y * k, a.z * k}; }

__device__ __forceinline__ f3 neg3(f3 a) { return {-a.x, -a.y, -a.z}; }

__device__ __forceinline__ f3 pick3(bool c, f3 a, f3 b) { return c ? a : b; }

__device__ __forceinline__ float dot3(f3 a, f3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }

__device__ __forceinline__ f3 cross3(f3 a, f3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

__device__ __forceinline__ bool isnan_(float x) { return x != x; }

// torch.clamp(x, min=lo): NaN stays NaN
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan_(x) ? x : fmaxf(x, lo);
}

// torch.clamp(x, lo, hi): NaN stays NaN
__device__ __forceinline__ float clamp(float x, float lo, float hi) {
  return isnan_(x) ? x : fminf(fmaxf(x, lo), hi);
}

// torch.amax over (x, y, z): a NaN wins
__device__ __forceinline__ float amax3(f3 v) {
  if (isnan_(v.x)) return v.x;
  if (isnan_(v.y)) return v.y;
  if (isnan_(v.z)) return v.z;
  return fmaxf(fmaxf(v.x, v.y), v.z);
}

// `1.0 / x` on a tensor: PyTorch's reciprocal, times 1.0
__device__ __forceinline__ float rdiv1(float x) { return (1.0f / x) * 1.0f; }

__device__ __forceinline__ float rsqrt_(float x) {
#ifdef __CUDACC__
  return rsqrtf(x);
#else
  return 1.0f / sqrtf(x);
#endif
}

// utils/vec
__device__ __forceinline__ f3 normalize3(f3 v) {
  return scale3(v, rsqrt_(clamp_min(dot3(v, v), NORM_EPS)));
}

__device__ __forceinline__ f3 reflect3(f3 i, f3 n) {
  const float k = 2.0f * dot3(i, n);
  return {i.x - n.x * k, i.y - n.y * k, i.z - n.z * k};
}

// ops/sky.sky_radiance
__device__ __forceinline__ f3 sky(f3 d, const float* top, const float* bottom) {
  const float t = 0.5f * (d.y + 1.0f);
  const float s = 1.0f - t;
  return {bottom[0] * s + top[0] * t, bottom[1] * s + top[1] * t, bottom[2] * s + top[2] * t};
}

// ops/integrator._offset_origin
__device__ __forceinline__ f3 offset_origin(f3 pos, f3 n, f3 d, float eps) {
  const float k = eps * (dot3(n, d) >= 0.0f ? 1.0f : -1.0f);
  return add3(pos, scale3(n, k));
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

__device__ __forceinline__ unsigned pcg_permute(unsigned x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ float unit_float(unsigned v) {
  return (float)(v & 0x00FFFFFFu) * INV_2_24;
}

__device__ __forceinline__ unsigned next_uint(unsigned x) {
  x ^= x << 13;
  x ^= x >> 17;
  x ^= x << 5;
  return x != 0u ? x : 1u;
}

__device__ __forceinline__ float next_float(unsigned& s) {
  s = next_uint(s);
  return unit_float(s);
}

__device__ __forceinline__ float side_float(unsigned s, unsigned salt) {
  return unit_float(pcg_permute(hash32(s ^ salt)));
}

// ops/integrator._vis_rr: whether the ray is traced; `w` scaled by 1/p or 0
__device__ __forceinline__ bool vis_rr(unsigned state, f3& w, bool act, unsigned salt,
                                       const ScatterArgs& a) {
  const float c = clamp_min(w.x * LUM_R + w.y * LUM_G + w.z * LUM_B, 0.0f);
  const float p = clamp(c * a.inv_lum, a.pmin, 1.0f);
  const float u = side_float(state, salt);
  const bool keep = u < p;
  w = scale3(w, keep ? rdiv1(p) : 0.0f);
  return act && keep;
}

__global__ void __launch_bounds__(THREADS) scatter_kernel(const ScatterArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const f3 pos = load3(a.pos, i), nrm = load3(a.nrm, i), alb = load3(a.alb, i);
  const f3 thr = load3(a.thr, i), view = load3(a.view, i);
  const int shade = a.shade[i];
  const float ior = a.ior[i];
  const bool alive = a.alive[i];
  const bool is_mirror = alive && shade == SHADING_MIRROR;
  const bool is_glass = alive && shade == SHADING_GLASS;
  const bool is_lambert = alive && shade == SHADING_LAMBERT;

  // mirror
  const f3 dir_mirror = reflect3(view, nrm);

  // glass: utils/vec.refract and schlick_fresnel on the facing normal
  const bool outside = dot3(view, nrm) < 0.0f;
  const f3 n_use = outside ? nrm : neg3(nrm);
  const float g_ior = ior > 0.0f ? ior : 1.5f;
  const float eta_i = outside ? 1.0f : g_ior;
  const float eta_t = outside ? g_ior : 1.0f;
  const f3 dir_refl = reflect3(view, n_use);
  const float eta = eta_i / eta_t;
  const float cos_r = -dot3(view, n_use);
  const float k = 1.0f - eta * eta * (1.0f - cos_r * cos_r);
  const bool refr_ok = k >= 0.0f;
  const float m = eta * cos_r - sqrtf(clamp_min(k, 0.0f));
  const f3 t_refr = normalize3(add3(scale3(view, eta), scale3(n_use, m)));
  const f3 dir_refr = refr_ok ? t_refr : f3{0.0f, 0.0f, 0.0f};
  const float cos_i = fabsf(dot3(view, n_use));
  float r0 = (eta_i - eta_t) / (eta_i + eta_t);
  r0 = r0 * r0;
  const float omc = 1.0f - cos_i;
  const float omc2 = omc * omc;
  const float omc5 = omc2 * omc2 * omc;
  const float fresnel = r0 + (1.0f - r0) * omc5;
  const float xi = unit_float((unsigned)a.state[i]);  // the glass draw
  const bool choose_refl = !refr_ok || xi < fresnel;
  const f3 dir_glass = pick3(choose_refl, dir_refl, dir_refr);
  const f3 offn_glass = choose_refl ? n_use : neg3(n_use);
  const bool alb_black = alb.x == 0.0f && alb.y == 0.0f && alb.z == 0.0f;
  const f3 tint = alb_black ? f3{1.0f, 1.0f, 1.0f} : alb;
  const float eta_scale = (eta_i * eta_i) / (eta_t * eta_t);
  const f3 glass_mult = choose_refl ? f3{1.0f, 1.0f, 1.0f} : scale3(tint, eta_scale);

  // the visibility ray of ReSTIR's selection
  unsigned state = (unsigned)a.state_rs[i];
  const f3 wi = load3(a.sel_wi, i);
  const bool ok = a.ok[i];
  const f3 zero{0.0f, 0.0f, 0.0f};
  store3(a.o_shadow_o, i, offset_origin(pos, nrm, wi, a.eps_n));
  f3 contrib_w = pick3(is_lambert && ok, mul3(thr, load3(a.contrib, i)), zero);
  f3 li = load3(a.li, i);
  bool q_act = ok;
  if (a.sun_occ) {
    // where the stored wi is exactly this frame's sun, its occlusion was
    // traced once for the frame
    const f3 sd = arr3(a.sun_dir);
    const bool exact = wi.x == sd.x && wi.y == sd.y && wi.z == sd.z;
    const bool sun_sel = a.is_sun[i] && ok && exact;
    li = add3(li, pick3(sun_sel && !a.sun_occ[i], contrib_w, zero));
    q_act = ok && !sun_sel;
  }
  if (a.vis_rr) q_act = vis_rr(state, contrib_w, q_act, SALT_SHADOW_RR, a);
  store3(a.o_li, i, li);
  store3(a.o_contrib_w, i, contrib_w);
  a.o_q_act[i] = q_act;

  // the reservoir merge: ReSTIR's where the lane first writes
  const bool wrote = a.wrote[i];
  const bool wm = is_lambert && !wrote;
  store3(a.o_res_L, i, wm ? load3(a.out_L, i) : load3(a.cur_L, i));
  store3(a.o_res_wi, i, wm ? load3(a.out_wi, i) : load3(a.cur_wi, i));
  a.o_res_pdf[i] = wm ? a.out_pdf[i] : a.cur_pdf[i];
  a.o_res_w[i] = wm ? a.out_w[i] : a.cur_w[i];
  a.o_res_w_sum[i] = wm ? a.out_w_sum[i] : a.cur_w_sum[i];
  a.o_res_m[i] = wm ? a.out_m[i] : a.cur_m[i];
  a.o_res_light_id[i] = wm ? a.out_light_id[i] : a.cur_light_id[i];
  a.o_res_W[i] = wm ? a.out_W[i] : a.cur_W[i];
  a.o_wrote[i] = wrote || is_lambert;

  // the lambert sample (ops/sampling.sample_hemisphere_cosine)
  const float r1 = next_float(state);
  const float r2 = next_float(state);
  const float phi = TWO_PI * r1;
  const float cos_theta = sqrtf(1.0f - r2);
  const float sin_theta = sqrtf(r2);
  const float x = cosf(phi) * sin_theta;
  const float y = sinf(phi) * sin_theta;
  const float z = cos_theta;
  const f3 up = fabsf(nrm.y) < UP_Y ? f3{0.0f, 1.0f, 0.0f} : f3{1.0f, 0.0f, 0.0f};
  const f3 tb = normalize3(cross3(up, nrm));
  const f3 bb = cross3(nrm, tb);
  const f3 dir_diffuse = normalize3(add3(add3(scale3(tb, x), scale3(bb, y)), scale3(nrm, z)));

  // Russian roulette
  const f3 thr_lambert = mul3(thr, alb);
  const float max_c = clamp(amax3(thr_lambert), a.rr_lo, a.rr_hi);
  const float u_rr = next_float(state);
  const bool rr_on = is_lambert && a.rr_on;
  const bool rr_kill = rr_on && u_rr > max_c;
  const float rr_scale = rr_on && !rr_kill ? rdiv1(max_c) : 1.0f;

  // the branches combined
  const f3 new_dir = is_mirror ? dir_mirror : (is_glass ? dir_glass : dir_diffuse);
  const f3 offn = is_glass ? offn_glass : nrm;
  f3 thr_new = is_mirror ? mul3(thr, alb)
                         : (is_glass ? mul3(thr, glass_mult)
                                     : (is_lambert ? scale3(thr_lambert, rr_scale) : thr));
  if (rr_kill) thr_new = zero;
  const bool trace_active = alive && !rr_kill;
  store3(a.o_new_dir, i, new_dir);
  store3(a.o_ray_o, i, offset_origin(pos, offn, new_dir, a.eps_n));
  store3(a.o_thr, i, thr_new);
  a.o_trace_active[i] = trace_active;
  a.o_state[i] = (int64_t)state;
  if (a.sky) {
    f3 sky_w = pick3(trace_active, mul3(thr_new, sky(new_dir, a.sky_top, a.sky_bottom)), zero);
    bool sky_act = trace_active;
    if (a.vis_rr) sky_act = vis_rr(state, sky_w, sky_act, SALT_SKY_RR, a);
    store3(a.o_sky_w, i, sky_w);
    a.o_sky_act[i] = sky_act;
  }
}

__global__ void __launch_bounds__(THREADS) resolve_kernel(const ResolveArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const f3 zero{0.0f, 0.0f, 0.0f};
  f3 li = load3(a.li, i);
  if (a.shadow_occ) li = add3(li, pick3(a.q_act[i] && !a.shadow_occ[i], load3(a.contrib_w, i), zero));
  a.o_state[i] = (int64_t)next_uint((unsigned)a.state[i]);  // the next glass draw
  if (a.sky) {
    bool alive = false;
    if (a.sky_occ) {
      const bool act = a.sky_act[i], occ = a.sky_occ[i];
      li = add3(li, pick3(act && !occ, load3(a.sky_w, i), zero));
      alive = act && occ;
    }
    store3(a.o_li, i, li);
    a.o_alive[i] = alive;
    return;
  }
  const bool act = a.trace_active[i];
  const bool hit = a.hit_t[i] < a.hit_max;
  const f3 new_dir = load3(a.new_dir, i);
  li = add3(li, pick3(act && !hit, mul3(load3(a.thr, i), sky(new_dir, a.sky_top, a.sky_bottom)),
                      zero));
  const bool alive = act && hit;
  store3(a.o_li, i, li);
  a.o_alive[i] = alive;
  store3(a.o_pos, i, alive ? load3(a.surf_pos, i) : load3(a.pos, i));
  store3(a.o_nrm, i, alive ? load3(a.surf_nrm, i) : load3(a.nrm, i));
  store3(a.o_alb, i, alive ? load3(a.surf_alb, i) : load3(a.alb, i));
  a.o_shade[i] = alive ? a.surf_shade[i] : a.shade[i];
  a.o_ior[i] = alive ? a.surf_ior[i] : a.ior[i];
  store3(a.o_view, i, alive ? new_dir : load3(a.view, i));
}

template <class A>
cudaError_t launch(void (*kernel)(const A), const A& a, cudaStream_t s) {
  if (a.n == 0) return cudaSuccess;
  const int blocks = (a.n + THREADS - 1) / THREADS;
  kernel<<<blocks, THREADS, 0, s>>>(a);
  return cudaGetLastError();
}

}  // namespace bounce

extern "C" {

int bounce_scatter_args_bytes() { return (int)sizeof(bounce::ScatterArgs); }

int bounce_resolve_args_bytes() { return (int)sizeof(bounce::ResolveArgs); }

int bounce_scatter(const bounce::ScatterArgs* args, void* stream) {
  return bounce::launch(bounce::scatter_kernel, *args, (cudaStream_t)stream);
}

int bounce_resolve(const bounce::ResolveArgs* args, void* stream) {
  return bounce::launch(bounce::resolve_kernel, *args, (cudaStream_t)stream);
}

const char* bounce_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}
