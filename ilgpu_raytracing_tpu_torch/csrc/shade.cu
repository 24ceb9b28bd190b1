// Deferred hit shading in one launch: every lane's hit record resolved to
// its surface (ops/traverse.shade_hits on the card; ops/cuda/shade.py
// binds it).
//
// It replaces no kernel of the JAX package: there hit shading is XLA-fused
// glue. Run eagerly in PyTorch, the same body issues about 495 device
// operations a call: it rebuilds the scene's per-triangle attribute table,
// (n_tris, 19) floats, computes the sphere and the triangle branch of every
// lane and samples two textures bilinearly, scene with textures or not.
// Here one thread owns one lane and reads the scene's own tables in place,
// gathered by the clamped ids as `texture.take` clamps them:
//   1. the hit position o + d t, and on a miss the far point and the
//      miss constants;
//   2. on a sphere, the object-space normal from the instance's w2o, the
//      material's kd (the sphere's albedo where kd is zero) or its texture
//      at the sphere's (u, v);
//   3. on a triangle, the normalised e1 x e2 flipped toward the ray on a
//      two-sided material, kd or the texture at the interpolated uv;
//   4. the normal back to world space through o2w, shading model, ior
//      (1 where the table's is not positive) and the triangle id as the
//      object key.
// A lane takes only the branch its kind selects and samples a texture only
// where the id is >= 0: the plain body computes both and discards one with
// torch.where, so the results are the same.
//
// Bound: a lane reads its hit record, o and d (48 B) and writes its surface
// (48 B); the gathered rows (a triangle's edges, uvs and material, or a
// sphere's, the instance's two transforms, up to four texels) are read by
// many lanes and come from L1/L2. Latency of the dependent gathers (prim ->
// material -> texture -> texel), not bandwidth, sets the time.
//
// Compiled with --fmad=false and without fast math, and every expression
// is written in the plain version's operation order (dot products and the
// 3x4 transforms row by row, left to right; normalize as v * rsqrt(max(|v|^2,
// 1e-20)) with torch.clamp's NaN rule; truncating float -> int casts), so on
// the card each output equals PyTorch's eager result bit for bit. Two
// rounding rules differ between PyTorch's CPU and CUDA kernels, and the host
// build (ops/cuda/host_check.py) takes the CPU's: rsqrt is a division
// there, and a tensor divided by a Python scalar is an IEEE division, where
// the CUDA kernel multiplies by the scalar's float reciprocal.

#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace shade {

constexpr int THREADS = 256;
constexpr int KIND_SPHERE = 1;
constexpr int KIND_TRI = 2;

// Python's double constants as PyTorch rounds them against a float32 tensor
constexpr float T_HIT_MAX = (float)1e29;
constexpr float MISS_FAR = (float)1e6;
constexpr float NORM_EPS = (float)1e-20;
constexpr float TWO_PI = (float)(2.0 * 3.141592653589793);
constexpr float PI = (float)3.141592653589793;
constexpr float INV_TWO_PI = 1.0f / TWO_PI;  // as PyTorch's CUDA division takes it
constexpr float INV_PI = 1.0f / PI;
constexpr float INV_255 = (float)(1.0 / 255.0);

// The call's arguments, copied by value into the kernel's parameters; the
// field order is ops/cuda/shade._Args's.
struct Args {
  // the lanes: ray and hit record
  const float* o;  // (n, 3)
  const float* d;  // (n, 3)
  const float* t;
  const int* kind;
  const int* prim;
  const int* inst;
  const float* bu;
  const float* bv;
  // the scene's tables, as SceneData holds them
  const float* tri_e1;  // (n_tris, 3)
  const float* tri_e2;
  const int* tri_mat;
  const float* tri_uv0;  // (n_tris, 2)
  const float* tri_uv1;
  const float* tri_uv2;
  const float* mat_kd;  // (n_mats, 3)
  const int* mat_diffuse_tex;
  const int* mat_two_sided;
  const int* mat_shading;
  const float* mat_ior;
  const float* sph_center;  // (n_spheres, 3)
  const int* sph_mat;
  const float* sph_albedo;  // (n_spheres, 3)
  const int* sph_shading;
  const float* sph_ior;
  const float* inst_w2o;  // (n_insts, 3, 4)
  const float* inst_o2w;
  const int* tex_offset;
  const int* tex_width;
  const int* tex_height;
  const int64_t* texels;  // uint32 0xAARRGGBB values
  // outputs
  float* pos;     // (n, 3)
  float* normal;  // (n, 3)
  float* albedo;  // (n, 3)
  int* shading;
  float* ior;
  int* obj_id;
  // sizes
  int64_t n_texels;
  int n;
  int n_tris, n_spheres, n_mats, n_insts, n_tex;
};

struct f3 {
  float x, y, z;
};

__device__ __forceinline__ f3 load3(const float* p, int i) {
  p += 3 * (size_t)i;
  return {p[0], p[1], p[2]};
}

__device__ __forceinline__ void store3(float* p, int i, f3 v) {
  p += 3 * (size_t)i;
  p[0] = v.x;
  p[1] = v.y;
  p[2] = v.z;
}

__device__ __forceinline__ float dot3(f3 a, f3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }

// utils/vec.cross
__device__ __forceinline__ f3 cross3(f3 a, f3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

// torch.clamp(x, min=lo) and torch.clamp(x, lo, hi): NaN stays NaN
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x != x ? x : fmaxf(x, lo);
}

__device__ __forceinline__ float clamp_f(float x, float lo, float hi) {
  return x != x ? x : fminf(fmaxf(x, lo), hi);
}

__device__ __forceinline__ int imin(int a, int b) { return a < b ? a : b; }

__device__ __forceinline__ int imax(int a, int b) { return a > b ? a : b; }

// texture.take's clamped row of an int32 id
__device__ __forceinline__ int row(int id, int rows) { return imin(imax(id, 0), rows - 1); }

__device__ __forceinline__ float rsqrt_(float x) {
#ifdef __CUDACC__
  return rsqrtf(x);
#else
  return 1.0f / sqrtf(x);
#endif
}

// a tensor divided by a Python scalar
__device__ __forceinline__ float div_scalar(float a, float b, float inv_b) {
#ifdef __CUDACC__
  (void)b;
  return a * inv_b;
#else
  (void)inv_b;
  return a / b;
#endif
}

// utils/vec.normalize
__device__ __forceinline__ f3 normalize3(f3 v) {
  const float inv = rsqrt_(clamp_min(dot3(v, v), NORM_EPS));
  return {v.x * inv, v.y * inv, v.z * inv};
}

// utils/vec.transform_point / transform_vector: row-major 3x4 at m
__device__ __forceinline__ f3 xform_point(const float* m, f3 p) {
  return {m[0] * p.x + m[1] * p.y + m[2] * p.z + m[3],
          m[4] * p.x + m[5] * p.y + m[6] * p.z + m[7],
          m[8] * p.x + m[9] * p.y + m[10] * p.z + m[11]};
}

__device__ __forceinline__ f3 xform_vector(const float* m, f3 v) {
  return {m[0] * v.x + m[1] * v.y + m[2] * v.z, m[4] * v.x + m[5] * v.y + m[6] * v.z,
          m[8] * v.x + m[9] * v.y + m[10] * v.z};
}

// ops/texture._texel then _rgb: the clamped texel's RGB in [0, 1]
__device__ __forceinline__ f3 texel_rgb(const Args& a, int off, int w, int h, int x, int y) {
  const int sx = imin(imax(x, 0), imax(w - 1, 0));
  const int sy = imin(imax(y, 0), imax(h - 1, 0));
  // int32 arithmetic as PyTorch's, wrapping on overflow
  const int idx = (int)((unsigned)off + (unsigned)sy * (unsigned)w + (unsigned)sx);
  int64_t k = idx < 0 ? 0 : (int64_t)idx;
  k = k < a.n_texels - 1 ? k : a.n_texels - 1;
  const int64_t p = a.texels[k];
  return {(float)((p >> 16) & 255) * INV_255, (float)((p >> 8) & 255) * INV_255,
          (float)(p & 255) * INV_255};
}

// ops/texture.sample_texture_bilinear: an invalid id or an empty texture
// reads white
__device__ f3 sample_bilinear(const Args& a, int tex_id, float u, float v) {
  const int k = row(tex_id, a.n_tex);
  const int off = a.tex_offset[k];
  const int w = a.tex_width[k];
  const int h = a.tex_height[k];
  if (!(tex_id >= 0 && tex_id < a.n_tex && w > 0 && h > 0)) return {1.0f, 1.0f, 1.0f};
  const float fu = u - floorf(u);
  const float fv = 1.0f - (v - floorf(v));
  const float x = fu * (float)(w - 1);
  const float y = fv * (float)(h - 1);
  const int x0 = (int)floorf(x);
  const int y0 = (int)floorf(y);
  const int x1 = imin(w - 1, x0 + 1);
  const int y1 = imin(h - 1, y0 + 1);
  const float tx = x - (float)x0;
  const float ty = y - (float)y0;
  const f3 c00 = texel_rgb(a, off, w, h, x0, y0);
  const f3 c10 = texel_rgb(a, off, w, h, x1, y0);
  const f3 c01 = texel_rgb(a, off, w, h, x0, y1);
  const f3 c11 = texel_rgb(a, off, w, h, x1, y1);
  const float sx = 1.0f - tx;
  const float sy = 1.0f - ty;
  const f3 cx0{c00.x * sx + c10.x * tx, c00.y * sx + c10.y * tx, c00.z * sx + c10.z * tx};
  const f3 cx1{c01.x * sx + c11.x * tx, c01.y * sx + c11.y * tx, c01.z * sx + c11.z * tx};
  return {cx0.x * sy + cx1.x * ty, cx0.y * sy + cx1.y * ty, cx0.z * sy + cx1.z * ty};
}

__global__ void __launch_bounds__(THREADS) shade_kernel(const Args a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const f3 o = load3(a.o, i);
  const f3 d = load3(a.d, i);
  const float t = a.t[i];
  if (!(t < T_HIT_MAX)) {  // a miss
    store3(a.pos, i, {o.x + d.x * MISS_FAR, o.y + d.y * MISS_FAR, o.z + d.z * MISS_FAR});
    store3(a.normal, i, {0.0f, 1.0f, 0.0f});
    store3(a.albedo, i, {0.0f, 0.0f, 0.0f});
    a.shading[i] = -1;
    a.ior[i] = 1.0f;
    a.obj_id[i] = -1;
    return;
  }
  const int kind = a.kind[i];
  const int prim = imax(a.prim[i], 0);
  const int inst = row(a.inst[i], a.n_insts);
  const float* w2o = a.inst_w2o + 12 * (size_t)inst;
  const f3 pos{o.x + d.x * t, o.y + d.y * t, o.z + d.z * t};
  f3 n_obj, albedo;
  int shading;
  float ior;
  if (kind == KIND_SPHERE) {
    const int s = imin(prim, a.n_spheres - 1);
    const f3 p = xform_point(w2o, pos);
    const f3 c = load3(a.sph_center, s);
    n_obj = normalize3({p.x - c.x, p.y - c.y, p.z - c.z});
    const int m = row(a.sph_mat[s], a.n_mats);
    const int dtex = a.mat_diffuse_tex[m];
    if (dtex >= 0) {
      const float su = 0.5f + div_scalar(atan2f(n_obj.z, n_obj.x), TWO_PI, INV_TWO_PI);
      const float sv = div_scalar(acosf(clamp_f(n_obj.y, -1.0f, 1.0f)), PI, INV_PI);
      albedo = sample_bilinear(a, dtex, su, sv);
    } else {
      const f3 kd = load3(a.mat_kd, m);
      albedo = (kd.x == 0.0f && kd.y == 0.0f && kd.z == 0.0f) ? load3(a.sph_albedo, s) : kd;
    }
    shading = a.sph_shading[s];
    ior = a.sph_ior[s];
  } else {
    const int p = imin(prim, a.n_tris - 1);
    n_obj = normalize3(cross3(load3(a.tri_e1, p), load3(a.tri_e2, p)));
    const int m = row(a.tri_mat[p], a.n_mats);
    if (a.mat_two_sided[m] != 0 && dot3(n_obj, xform_vector(w2o, d)) > 0.0f)
      n_obj = {-n_obj.x, -n_obj.y, -n_obj.z};
    const int dtex = a.mat_diffuse_tex[m];
    if (dtex >= 0) {
      const float bu = a.bu[i];
      const float bv = a.bv[i];
      const float wgt = 1.0f - bu - bv;
      const float* uv0 = a.tri_uv0 + 2 * (size_t)p;
      const float* uv1 = a.tri_uv1 + 2 * (size_t)p;
      const float* uv2 = a.tri_uv2 + 2 * (size_t)p;
      const float uu = uv0[0] * wgt + uv1[0] * bu + uv2[0] * bv;
      const float vv = uv0[1] * wgt + uv1[1] * bu + uv2[1] * bv;
      albedo = sample_bilinear(a, dtex, uu, vv);
    } else {
      albedo = load3(a.mat_kd, m);
    }
    shading = a.mat_shading[m];
    ior = a.mat_ior[m];
  }
  store3(a.pos, i, pos);
  store3(a.normal, i, normalize3(xform_vector(a.inst_o2w + 12 * (size_t)inst, n_obj)));
  store3(a.albedo, i, albedo);
  a.shading[i] = shading;
  a.ior[i] = ior > 0.0f ? ior : 1.0f;
  a.obj_id[i] = kind == KIND_TRI ? a.prim[i] : -1;
}

cudaError_t launch(const Args& a, cudaStream_t s) {
  const int blocks = (a.n + THREADS - 1) / THREADS;
  shade_kernel<<<blocks, THREADS, 0, s>>>(a);
  return cudaGetLastError();
}

}  // namespace shade

extern "C" {

int shade_args_bytes() { return (int)sizeof(shade::Args); }

int shade_hits(const shade::Args* args, void* stream) {
  if (args->n == 0) return 0;
  return shade::launch(*args, (cudaStream_t)stream);
}

const char* shade_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
