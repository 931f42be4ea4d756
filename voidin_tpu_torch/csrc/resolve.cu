// Dense G-buffer resolve: every per-pixel field of the default resolve path
// in one launch.
//
// Replaces no TPU kernel: the JAX package resolves in plain jnp
// (voidin_tpu/passes/resolve.py resolve_gbuffer), which XLA fuses on the
// TPU. Eager PyTorch does not fuse it: the port's chain
// (passes/resolve.py _fetch_rows -> _decode_channels -> _channel_fields)
// ran as some hundreds of launches a frame, each reading and writing (H, W)
// to (H, W, 24) f32 fields, and cost ~13 host ms and ~12 device ms of every
// 1080p frame. This kernel is that chain for the dense (H, W) path of a
// scene without an alpha mask, with the 12-column resolve record, the
// per-pixel albedo tap and const-folded emissive and metallic-roughness
// (passes/resolve.py takes it only there; ops/resolve.py resolve_dense).
//
// What it computes, per pixel (one thread), as the chain does:
//   tid = max(tri_id, 0) (a background pixel reads record 0 and is masked
//   out at the end); the record's clip x/y/w per corner, instance and
//   idx_start; the corner-attribute row tri_attr_packed[idx_start / 3];
//   the instance's 3x3 basis and material; perspective-correct
//   barycentrics at the pixel centre (fastmath.cross: each component
//   a_j b_k - rnd(a_k b_j) in f64, rounded once); uv and normal
//   interpolated, the normal to world space through the plain basis; the
//   mip level from the image-space differences of uv to the right and
//   lower neighbours (0 at the window's last column and row), log2 of the
//   larger footprint; the trilinear albedo tap of the texel-quad pool (one
//   32 B row) with its sRGB decode; with kNormalMaps the tangent frame and
//   the normal-map tap where the material has one; the alpha cut;
//   octahedral normal and pack2x16float uv. Outputs the G-buffer words
//   (normal_uv, material, depth) and the shading pass's albedo, emissive
//   and metallic-roughness, background and cut pixels as the chain gives
//   them.
// Every step is rounded as the chain rounds it on the card: the library is
// built with -fmad=false; sums keep the chain's order ((a + b) + c);
// division and square root are IEEE; a tensor divided by a Python scalar
// is a product with its reciprocal, taken in f64 and rounded to f32, as
// torch's CUDA division by a CPU scalar computes it (x / 3 is
// x * 0.33333334f, x / 1.055 is x * f32(1 / 1.055)); clamp, minimum and
// maximum let NaN through as torch does; log2f and powf are the CUDA math
// library's, as in torch's log2 and pow kernels; float-to-integer
// conversions truncate as torch's casts do, and a shift by more than 62
// gives torch's a >> 63. So NaN and signed zeros of a degenerate triangle
// come out as the chain's, and kernel and chain agree bit for bit.
//
// What bounds it on an H100. Per pixel it must read the visibility image
// (tri_id and depth, 8 B) and write 60 B (normal_uv 8, material 4, depth
// 4, albedo 16, emissive 12, metallic-roughness 16): at 1080p 141 MB,
// 0.042 ms at 3.35 TB/s. The rows it gathers (the 48 B record, the 48 B
// attribute row, the 64 B transform, the 32 B texel quad) come from tables
// of a few MB that stay in the 50 MB L2, and its ~400 FP32 operations a
// pixel (about 40 of them IEEE divisions, square roots, a log2 and three
// powf) are ~0.01 ms of the card's FP32 rate. Design: one thread per pixel
// in 32x8 blocks, so that a warp reads a row of neighbouring pixels and
// their gathers hit the same rows; the rows as 16-byte loads; each
// block's uv tile with a one-pixel halo (its right column and lower row,
// 40 uv-only pixels) in shared memory for the mip level; every output
// written once, coalesced; no atomics and no scratch.

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kTileW = 32;
constexpr int kTileH = 8;
constexpr int kHalo = kTileW + kTileH;  // lower row + right column

__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float dv(float a, float b) {
  return __fdiv_rn(a, b);
}
// torch.clamp(x, min=lo) / torch.clamp(x, lo, hi): NaN passes through.
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}
__device__ __forceinline__ float clamp(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}
// torch.minimum / torch.maximum: a NaN operand wins, the first one first.
__device__ __forceinline__ float tmin(float a, float b) {
  return a != a ? a : (b != b ? b : fminf(a, b));
}
__device__ __forceinline__ float tmax(float a, float b) {
  return a != a ? a : (b != b ? b : fmaxf(a, b));
}
// torch.sign: 0 for NaN and for either zero.
__device__ __forceinline__ float tsign(float a) {
  return (float)((0.0f < a) - (a < 0.0f));
}
// torch's int64 >> (a shift outside [0, 63) gives a >> 63).
__device__ __forceinline__ long long shr(long long a, long long b) {
  return (b < 0 || b >= 63) ? (a >> 63) : (a >> b);
}
// torch.remainder on int64: the sign of the divisor.
__device__ __forceinline__ long long rem(long long a, long long b) {
  long long r = a % b;
  if (r != 0 && ((r < 0) != (b < 0))) r += b;
  return r;
}

// The Python scalars of the chain as torch hands them to its CUDA kernels:
// the double rounded to f32, and for a division the reciprocal taken in
// f64 and rounded to f32 (f32(1 / 1.055) is one ulp below 1 / f32(1.055)).
constexpr float kInv3 = (float)(1.0 / 3.0);
constexpr float kInv65535 = (float)(1.0 / 65535.0);
constexpr float kInv255 = (float)(1.0 / 255.0);
constexpr float kInv1292 = (float)(1.0 / 12.92);
constexpr float kInv1055 = (float)(1.0 / 1.055);

struct V3 {
  float x, y, z;
};

// fastmath.cross component: a_j b_k - rnd(a_k b_j) in f64, rounded once.
__device__ __forceinline__ float cross_c(float aj, float bk, float ak,
                                         float bj) {
  return __double2float_rn(
      __dsub_rn(__dmul_rn((double)aj, (double)bk), (double)mul(ak, bj)));
}
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {cross_c(a.y, b.z, a.z, b.y), cross_c(a.z, b.x, a.x, b.z),
          cross_c(a.x, b.y, a.y, b.x)};
}
// resolve._normalize: v / sqrt(clamp((x x + y y) + z z, min=1e-20))
__device__ __forceinline__ V3 normalize(V3 v) {
  const float s = __fsqrt_rn(clamp_min(
      add(add(mul(v.x, v.x), mul(v.y, v.y)), mul(v.z, v.z)), (float)1e-20));
  return {dv(v.x, s), dv(v.y, s), dv(v.z, s)};
}
// fastmath.mat3_vec: row i (m_i0 v0 + m_i1 v1) + m_i2 v2
__device__ __forceinline__ V3 mat3_vec(const float m[9], V3 v) {
  float o[3];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    o[i] = add(add(mul(m[3 * i], v.x), mul(m[3 * i + 1], v.y)),
               mul(m[3 * i + 2], v.z));
  return {o[0], o[1], o[2]};
}
// interp: (c0 l0 + c1 l1) + c2 l2
__device__ __forceinline__ float interp(float c0, float c1, float c2,
                                        const float lam[3]) {
  return add(add(mul(c0, lam[0]), mul(c1, lam[1])), mul(c2, lam[2]));
}
__device__ __forceinline__ V3 interp3(V3 c0, V3 c1, V3 c2,
                                      const float lam[3]) {
  return {interp(c0.x, c1.x, c2.x, lam), interp(c0.y, c1.y, c2.y, lam),
          interp(c0.z, c1.z, c2.z, lam)};
}

// encoding.decode_octahedral_32
__device__ __forceinline__ V3 decode_oct(unsigned int w) {
  const float v0 = sub(mul(mul((float)(w & 0xFFFFu), kInv65535), 2.0f), 1.0f);
  const float v1 = sub(mul(mul((float)(w >> 16), kInv65535), 2.0f), 1.0f);
  const float z = sub(sub(1.0f, fabsf(v0)), fabsf(v1));
  const float t = clamp_min(-z, 0.0f);
  const float x = add(v0, v0 > 0.0f ? -t : t);
  const float y = add(v1, v1 > 0.0f ? -t : t);
  const float n = __fsqrt_rn(add(add(mul(x, x), mul(y, y)), mul(z, z)));
  return {dv(x, n), dv(y, n), dv(z, n)};
}

// encoding.encode_octahedral_32
__device__ __forceinline__ unsigned int encode_oct(V3 n) {
  const float den = add(add(fabsf(n.x), fabsf(n.y)), fabsf(n.z));
  const float nx = dv(n.x, den), ny = dv(n.y, den), nz = dv(n.z, den);
  float x = nx, y = ny;
  if (nz < 0.0f) {
    x = mul(sub(1.0f, fabsf(ny)), tsign(nx));
    y = mul(sub(1.0f, fabsf(nx)), tsign(ny));
  }
  const long long d0 =
      (long long)floorf(add(mul(add(mul(x, 0.5f), 0.5f), 65535.0f), 0.5f));
  const long long d1 =
      (long long)floorf(add(mul(add(mul(y, 0.5f), 0.5f), 65535.0f), 0.5f));
  return ((unsigned int)d1 << 16) | (unsigned int)d0;
}

// encoding.pack2x16float
__device__ __forceinline__ unsigned int pack_half2(float a, float b) {
  return (unsigned int)__half_as_ushort(__float2half_rn(a)) |
         ((unsigned int)__half_as_ushort(__float2half_rn(b)) << 16);
}

// The resolve record's clip x/y/w of corner k at c[3k .. 3k + 2];
// perspective-correct barycentrics at NDC (xn, yn) (resolve._channel_fields
// bary).
__device__ __forceinline__ void bary(const float c[9], float xn, float yn,
                                     float lam[3]) {
  V3 u, v;
  u.x = sub(c[0], mul(xn, c[2]));
  u.y = sub(c[3], mul(xn, c[5]));
  u.z = sub(c[6], mul(xn, c[8]));
  v.x = sub(c[1], mul(yn, c[2]));
  v.y = sub(c[4], mul(yn, c[5]));
  v.z = sub(c[7], mul(yn, c[8]));
  const V3 bc = cross(u, v);
  const float bsum = add(add(bc.x, bc.y), bc.z);
  const float sign = bsum < 0.0f ? -1.0f : 1.0f;
  const float den = clamp_min(mul(bsum, sign), (float)1e-20);
  lam[0] = dv(mul(bc.x, sign), den);
  lam[1] = dv(mul(bc.y, sign), den);
  lam[2] = dv(mul(bc.z, sign), den);
}

struct Args {
  const int* tri_id;          // (H, W)
  const float* depth;         // (H, W)
  const float4* rec;          // (N, 12) f32: three float4 a row
  const int4* attr;           // (P, 12) u32 bits: three int4 a row
  const float4* xform;        // (I, 4, 4) f32: four float4 a row
  const int* inst_material;   // (I,)
  const int* mat_albedo;      // (K,)
  const int* mat_normal;      // (K,)
  const float* base_color;    // (K, 4)
  const float4* emissive;     // (K, 4) emissive_rgba
  const float4* mr;           // (K, 4) mr_rgba
  const int2* tex_size;       // (T, 2) level-0 (w, h)
  const uint4* quads;         // (T * total, 32) u8: two uint4 a row
  const unsigned char* srgb;  // (T,) bool
  long long total;            // pool rows a texture
  long long base;             // pool base size
  int H, W, row0, height;
  int albedo_srgb, normal_srgb;  // 0: none, 1: decode, 2: per texture
  int2* normal_uv;            // (H, W, 2) out
  int* material;              // (H, W) out
  float* depth_out;           // (H, W) out
  float4* albedo;             // (H, W, 4) out
  float* emissive_out;        // (H, W, 3) out
  float4* mr_out;             // (H, W, 4) out
};

// f32(1 / n) taken in f64: torch's reciprocal of an integer divisor.
__device__ __forceinline__ float inv(int n) {
  return __double2float_rn(__ddiv_rn(1.0, (double)n));
}
// NDC of pixel (x, local row y): resolve_gbuffer's x_ndc / y_ndc.
__device__ __forceinline__ float ndc_x(const Args& a, int x) {
  return sub(mul(mul(add((float)x, 0.5f), inv(a.W)), 2.0f), 1.0f);
}
__device__ __forceinline__ float ndc_y(const Args& a, int y) {
  const float v = mul(add((float)(a.row0 + y), 0.5f), inv(a.height));
  return sub(1.0f, mul(v, 2.0f));
}

// uv alone at pixel (x, y), for the halo of the mip level's differences.
__device__ __forceinline__ float2 pixel_uv(const Args& a, int x, int y) {
  const long long tid = max(__ldg(a.tri_id + (long long)y * a.W + x), 0);
  const float4* r = a.rec + 3 * tid;
  const float4 r0 = __ldg(r), r1 = __ldg(r + 1), r2 = __ldg(r + 2);
  const float c[9] = {r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, r1.z, r1.w, r2.x};
  const long long tp = (long long)mul(r2.z, kInv3);
  const int4* p = a.attr + 3 * tp;
  const int4 p0 = __ldg(p), p1 = __ldg(p + 1);
  float lam[3];
  bary(c, ndc_x(a, x), ndc_y(a, y), lam);
  return make_float2(
      interp(__int_as_float(p0.x), __int_as_float(p0.z),
             __int_as_float(p1.x), lam),
      interp(__int_as_float(p0.y), __int_as_float(p0.w),
             __int_as_float(p1.y), lam));
}

// texture.sample_trilinear: the level from lod (clamped to [0, the
// texture's derived max level]), one texel-quad row, bilinear in the level
// and blended toward its resampled parent, then the sRGB decode.
__device__ __forceinline__ float4 sample(const Args& a, long long tex,
                                         float u, float v, float lod,
                                         float w0, float h0, int srgb_mode) {
  const float dml =
      floorf(log2f(add(clamp_min(tmin(w0, h0), 1.0f), 0.5f)));
  const float l = tmin(clamp_min(lod, 0.0f), dml);
  const float l0 = floorf(l);
  const long long level = (long long)l0;
  const float frac = sub(l, l0);
  const long long lw = max(shr((long long)w0, level), 1LL);
  const long long lh = max(shr((long long)h0, level), 1LL);
  const long long stride = max(shr(a.base, level), 1LL);
  const long long off = (4 * (a.base * a.base - stride * stride)) / 3;
  const float fx = sub(mul(u, (float)lw), 0.5f);
  const float fy = sub(mul(v, (float)lh), 0.5f);
  const float x0 = floorf(fx), y0 = floorf(fy);
  const float tx = sub(fx, x0), ty = sub(fy, y0);
  const long long idx = tex * a.total + off +
                        rem((long long)y0, lh) * stride +
                        rem((long long)x0, lw);
  const uint4 q0 = __ldg(a.quads + 2 * idx), q1 = __ldg(a.quads + 2 * idx + 1);
  const unsigned int w[8] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
  // word k of the row holds bytes 4k .. 4k + 3: corner k % 4 (c00, c10,
  // c01, c11) of the level (k < 4) or of the parent, channel by byte
  float out[4];
  const bool decode =
      srgb_mode == 1 || (srgb_mode == 2 && __ldg(a.srgb + tex) != 0);
#pragma unroll
  for (int ch = 0; ch < 4; ++ch) {
    float lv[2];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const float c00 = mul((float)((w[4 * s] >> (8 * ch)) & 0xFFu), kInv255);
      const float c10 =
          mul((float)((w[4 * s + 1] >> (8 * ch)) & 0xFFu), kInv255);
      const float c01 =
          mul((float)((w[4 * s + 2] >> (8 * ch)) & 0xFFu), kInv255);
      const float c11 =
          mul((float)((w[4 * s + 3] >> (8 * ch)) & 0xFFu), kInv255);
      const float top = add(c00, mul(sub(c10, c00), tx));
      const float bot = add(c01, mul(sub(c11, c01), tx));
      lv[s] = add(top, mul(sub(bot, top), ty));
    }
    float c = add(lv[0], mul(sub(lv[1], lv[0]), frac));
    if (decode && ch < 3)
      c = c <= (float)0.04045
              ? mul(c, kInv1292)
              : powf(mul(add(c, (float)0.055), kInv1055), (float)2.4);
    out[ch] = c;
  }
  return make_float4(out[0], out[1], out[2], out[3]);
}

template <bool kNormalMaps>
__global__ void __launch_bounds__(kTileW* kTileH)
    resolve_dense_kernel(const Args a) {
  __shared__ float2 s_uv[kTileH + 1][kTileW + 1];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int x0 = blockIdx.x * kTileW, y0 = blockIdx.y * kTileH;
  const int x = x0 + tx, y = y0 + ty;
  const bool inside = x < a.W && y < a.H;
  const long long pix = (long long)y * a.W + x;

  // the pixel's rows and its uv
  int tri = -1;
  float c[9];
  float lam[3];
  int4 p0, p1, p2;
  long long inst = 0;
  float2 uv = make_float2(0.0f, 0.0f);
  if (inside) {
    tri = __ldg(a.tri_id + pix);
    const long long tid = max(tri, 0);
    const float4* r = a.rec + 3 * tid;
    const float4 r0 = __ldg(r), r1 = __ldg(r + 1), r2 = __ldg(r + 2);
    c[0] = r0.x; c[1] = r0.y; c[2] = r0.z; c[3] = r0.w;
    c[4] = r1.x; c[5] = r1.y; c[6] = r1.z; c[7] = r1.w; c[8] = r2.x;
    inst = (long long)r2.y;
    const long long tp = (long long)mul(r2.z, kInv3);
    const int4* p = a.attr + 3 * tp;
    p0 = __ldg(p);
    p1 = __ldg(p + 1);
    p2 = __ldg(p + 2);
    bary(c, ndc_x(a, x), ndc_y(a, y), lam);
    uv = make_float2(interp(__int_as_float(p0.x), __int_as_float(p0.z),
                            __int_as_float(p1.x), lam),
                     interp(__int_as_float(p0.y), __int_as_float(p0.w),
                            __int_as_float(p1.y), lam));
    s_uv[ty][tx] = uv;
  }
  // the halo: the block's lower row, then its right column
  const int h = ty * kTileW + tx;
  if (h < kHalo) {
    const int hx = h < kTileW ? x0 + h : x0 + kTileW;
    const int hy = h < kTileW ? y0 + kTileH : y0 + (h - kTileW);
    if (hx < a.W && hy < a.H) {
      const float2 huv = pixel_uv(a, hx, hy);
      if (h < kTileW)
        s_uv[kTileH][h] = huv;
      else
        s_uv[h - kTileW][kTileW] = huv;
    }
  }
  __syncthreads();
  if (!inside) return;

  // instance, material, texture
  const float4* xf = a.xform + 4 * inst;
  const float4 m0 = __ldg(xf), m1 = __ldg(xf + 1), m2 = __ldg(xf + 2);
  const float basis[9] = {m0.x, m0.y, m0.z, m1.x, m1.y, m1.z,
                          m2.x, m2.y, m2.z};
  const int mid = __ldg(a.inst_material + inst);
  const long long alb = __ldg(a.mat_albedo + mid);
  const float base_a = __ldg(a.base_color + 4 * (long long)mid + 3);
  const int2 wh = __ldg(a.tex_size + alb);
  const float tex_w = (float)wh.x, tex_h = (float)wh.y;

  // shading.uv_lod: differences to the right and lower neighbours, 0 at
  // the window's last column and row
  float du0 = 0.0f, du1 = 0.0f, dv0 = 0.0f, dv1 = 0.0f;
  if (x + 1 < a.W) {
    const float2 r = s_uv[ty][tx + 1];
    du0 = sub(r.x, uv.x);
    du1 = sub(r.y, uv.y);
  }
  if (y + 1 < a.H) {
    const float2 b = s_uv[ty + 1][tx];
    dv0 = sub(b.x, uv.x);
    dv1 = sub(b.y, uv.y);
  }
  const float rho = tmax(add(mul(fabsf(du0), tex_w), mul(fabsf(du1), tex_h)),
                         add(mul(fabsf(dv0), tex_w), mul(fabsf(dv1), tex_h)));
  const float lod =
      clamp(log2f(clamp_min(rho, (float)1e-8)), 0.0f, 16.0f);
  const float4 albedo =
      sample(a, alb, uv.x, uv.y, lod, tex_w, tex_h, a.albedo_srgb);

  // the normal (attribute columns 6-8), with the normal map's frame
  // (columns 9-11, the w sign in bit 0) where the material has one
  const V3 n_raw = interp3(decode_oct((unsigned int)p1.z),
                           decode_oct((unsigned int)p1.w),
                           decode_oct((unsigned int)p2.x), lam);
  const V3 n_ws = mat3_vec(basis, n_raw);
  const V3 n_geo = normalize(n_ws);
  V3 normal = n_geo;
  if (kNormalMaps) {
    const long long mnor = __ldg(a.mat_normal + mid);
    if (mnor != 0) {
      const unsigned int t0 = (unsigned int)p2.y, t1 = (unsigned int)p2.z,
                         t2 = (unsigned int)p2.w;
      const V3 t_raw =
          interp3(decode_oct(t0), decode_oct(t1), decode_oct(t2), lam);
      const float t_w =
          interp(sub(1.0f, mul(2.0f, (float)(t0 & 1u))),
                 sub(1.0f, mul(2.0f, (float)(t1 & 1u))),
                 sub(1.0f, mul(2.0f, (float)(t2 & 1u))), lam);
      const V3 t_ws = mat3_vec(basis, t_raw);
      const V3 bc = cross(n_ws, t_ws);
      const V3 b_ws = {mul(bc.x, t_w), mul(bc.y, t_w), mul(bc.z, t_w)};
      const int2 nwh = __ldg(a.tex_size + mnor);
      const float4 nt = sample(a, mnor, uv.x, uv.y, lod, (float)nwh.x,
                               (float)nwh.y, a.normal_srgb);
      const V3 tt = normalize(t_ws), tb = normalize(b_ws);
      const float ka = sub(mul(nt.x, 2.0f), 1.0f);
      const float kb = sub(mul(nt.y, 2.0f), 1.0f);
      const float kc = sub(mul(nt.z, 2.0f), 1.0f);
      normal = {add(add(mul(tt.x, ka), mul(tb.x, kb)), mul(n_geo.x, kc)),
                add(add(mul(tt.y, ka), mul(tb.y, kb)), mul(n_geo.y, kc)),
                add(add(mul(tt.z, ka), mul(tb.z, kb)), mul(n_geo.z, kc))};
    }
    normal = normalize(normal);
  }

  // the alpha cut, then the outputs; background and cut pixels take the
  // cleared G-buffer and material 0's fields
  const bool cut = base_a < 0.5f || albedo.w < 0.5f;
  const bool keep = tri >= 0 && !cut;
  if (keep) {
    a.normal_uv[pix] = make_int2((int)encode_oct(normal),
                                 (int)pack_half2(uv.x, uv.y));
    a.material[pix] = mid;
    a.depth_out[pix] = __ldg(a.depth + pix);
    a.albedo[pix] = albedo;
  } else {
    a.normal_uv[pix] = make_int2(0, 0);
    a.material[pix] = 0;
    a.depth_out[pix] = 0.0f;
    a.albedo[pix] = make_float4(1.0f, 1.0f, 1.0f, 1.0f);
  }
  const float4 e = __ldg(a.emissive + (keep ? mid : 0));
  a.emissive_out[3 * pix] = e.x;
  a.emissive_out[3 * pix + 1] = e.y;
  a.emissive_out[3 * pix + 2] = e.z;
  a.mr_out[pix] = __ldg(a.mr + (keep ? mid : 0));
}

template <bool kNormalMaps>
int launch(const Args& a, void* stream) {
  const dim3 block(kTileW, kTileH);
  const dim3 grid((a.W + kTileW - 1) / kTileW, (a.H + kTileH - 1) / kTileH);
  resolve_dense_kernel<kNormalMaps>
      <<<grid, block, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// ptrs: tri_id, depth, rec, attr, xform, inst_material, mat_albedo,
// mat_normal, base_color, emissive, mr, tex_size, quads, srgb, then the
// outputs normal_uv, material, depth, albedo, emissive, mr. ints: total,
// base, H, W, row0, height, albedo_srgb, normal_srgb. H * W > 0: the
// wrapper launches nothing otherwise.
extern "C" int voidin_resolve_dense(const void* const* ptrs,
                                    const long long* ints, int normal_maps,
                                    void* stream) {
  Args a;
  a.tri_id = (const int*)ptrs[0];
  a.depth = (const float*)ptrs[1];
  a.rec = (const float4*)ptrs[2];
  a.attr = (const int4*)ptrs[3];
  a.xform = (const float4*)ptrs[4];
  a.inst_material = (const int*)ptrs[5];
  a.mat_albedo = (const int*)ptrs[6];
  a.mat_normal = (const int*)ptrs[7];
  a.base_color = (const float*)ptrs[8];
  a.emissive = (const float4*)ptrs[9];
  a.mr = (const float4*)ptrs[10];
  a.tex_size = (const int2*)ptrs[11];
  a.quads = (const uint4*)ptrs[12];
  a.srgb = (const unsigned char*)ptrs[13];
  a.normal_uv = (int2*)ptrs[14];
  a.material = (int*)ptrs[15];
  a.depth_out = (float*)ptrs[16];
  a.albedo = (float4*)ptrs[17];
  a.emissive_out = (float*)ptrs[18];
  a.mr_out = (float4*)ptrs[19];
  a.total = ints[0];
  a.base = ints[1];
  a.H = (int)ints[2];
  a.W = (int)ints[3];
  a.row0 = (int)ints[4];
  a.height = (int)ints[5];
  a.albedo_srgb = (int)ints[6];
  a.normal_srgb = (int)ints[7];
  return normal_maps ? launch<true>(a, stream) : launch<false>(a, stream);
}
