// TAA of a frame with a valid history in one launch: reprojection, the
// bilinear history fetch, the neighbourhood clamp and the blend.
//
// Replaces no TPU kernel: the JAX package's TAA is plain jnp
// (voidin_tpu/passes/taa.py reproject, taa_resolve), which XLA fuses on
// the TPU. Eager PyTorch does not fuse it: the port's chain
// (passes/taa.py reproject -> taa_resolve with the per-pixel fetch) ran as
// some 600 launches a frame, each reading and writing (H, W) to (H, W, 3)
// f32 images, and cost ~8 host ms and ~10 device ms of every 1080p frame.
// This kernel is that chain on the default fetch (passes/taa.py takes it
// wherever neither taa_quad_history nor taa_inwindow is set; ops/taa.py
// taa_resolve_fused), for the whole image (the sharded frame's slabs keep
// the chain).
//
// What it computes, per pixel (one thread), as the chain does:
//   reproject: the 3x3 max of depth (edge-clamped, torch.maximum's order:
//   the centre, then rows -1, 0, 1 and columns -1, 0, 1), the world
//   position through clip_to_world (w clamped to +/-1e-12 away from 0, the
//   position to +/-1e12), its clip position through prev_world_to_clip, the
//   velocity ((ndc + jitter) - (prev ndc + prev jitter)) and the in-bounds
//   flag; taa_resolve: the history uv, the bilinear clamp-to-edge fetch
//   with every corner rounded to f16 (the history_quads table, which never
//   reaches device memory), the YCbCr Gaussian 3x3 moments, the
//   Mitchell-Netravali centre, the adaptive box from the local contrast and
//   the texel-centre distance, the mu +/- 1.5 sigma clamp, the blend by
//   validity and clamp distance, and ycbcr_to_rgb.
// Every step is rounded as the chain rounds it on the card: the library is
// built with -fmad=false; sums keep the chain's order; division and square
// root are IEEE; a tensor divided by a Python scalar is a product with its
// f32 reciprocal (the wrapper computes those, ops/taa.py recip); the colour
// matrices go through fastmath.const_mat_vec, whose Python sum starts from
// the int 0, so each row's first term is (m c) + 0 (-0.0 becomes +0.0); the
// neighbourhood weights are the chain's f64 Python weights rounded to f32;
// clamp, minimum and maximum let NaN through as torch does; the floor
// texel goes through nan_to_num, a clamp and an int64 truncation. So NaN,
// infinities and signed zeros of the history come out as the chain's, and
// kernel and chain agree bit for bit.
//
// What bounds it on an H100. Per pixel it must read depth (4 B), colour
// (12 B) and the history (12 B) and write the resolved colour (12 B): 40 B,
// at 1080p 83 MB, 0.025 ms at 3.35 TB/s. Its ~450 FP32 operations a pixel
// (four IEEE divisions and three square roots among them) are ~0.014 ms of
// the card's FP32 rate. Design, for a stencil bound by memory: one thread a
// pixel in 32x8 blocks; each block stages its colour and depth tile with a
// one-pixel edge-clamped halo in shared memory ((34 x 10) x 16 B, 5.4 KB),
// so each neighbour is read from device memory about 1.3 times and not 9;
// the four history corners are gathered through L1 and L2 (the 25 MB
// history of a 1080p frame fits in the 50 MB L2, and neighbouring pixels
// reproject to neighbouring texels); the output is written once,
// coalesced by warp rows; no atomics and no scratch. The kernel writes a
// fresh image: the history cannot be written while other blocks read it
// (the caller copies the result into it).

#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

namespace {

constexpr int kTileW = 32;
constexpr int kTileH = 8;
constexpr int kHaloW = kTileW + 2;
constexpr int kHaloH = kTileH + 2;
constexpr int kThreads = kTileW * kTileH;

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
// the history_quads table's f16 word of x, read back as f32
__device__ __forceinline__ float f16(float x) {
  return __half2float(__float2half_rn(x));
}

struct V3 {
  float x, y, z;
};

// fastmath.const_mat_vec row: Python's sum(m_c * v_c) from the int 0,
// ((m0 v0 + 0) + m1 v1) + m2 v2. The matrix entries are the chain's
// np.float32 of the decimal (a double rounded to f32).
__device__ __forceinline__ float mat_row(float m0, float m1, float m2, V3 v) {
  return add(add(add(mul(v.x, m0), 0.0f), mul(v.y, m1)), mul(v.z, m2));
}
// core/color.py rgb_to_ycbcr / ycbcr_to_rgb
__device__ __forceinline__ V3 rgb_to_ycbcr(V3 c) {
  return {mat_row((float)0.2126, (float)0.7152, (float)0.0722, c),
          mat_row((float)-0.1146, (float)-0.3854, (float)0.5, c),
          mat_row((float)0.5, (float)-0.4542, (float)-0.0458, c)};
}
__device__ __forceinline__ V3 ycbcr_to_rgb(V3 c) {
  return {mat_row((float)1.0, (float)0.0, (float)1.5748, c),
          mat_row((float)1.0, (float)-0.1873, (float)-0.4681, c),
          mat_row((float)1.0, (float)1.8556, (float)0.0, c)};
}

// taa._smoothstep with (x - e0) / (e1 - e0) as a product with the f32
// reciprocal of the Python scalar e1 - e0
__device__ __forceinline__ float smoothstep(float e0, float inv_span, float x) {
  const float t = clamp(mul(sub(x, e0), inv_span), 0.0f, 1.0f);
  return mul(mul(t, t), sub(3.0f, mul(2.0f, t)));
}

// One row of fastmath.const_mat4_point4 with w = None:
// ((m0 x + m1 y) + m2 z) + m3
__device__ __forceinline__ float mat4_row(const float* m, float x, float y,
                                          float z) {
  return add(add(add(mul(x, m[0]), mul(y, m[1])), mul(z, m[2])), m[3]);
}

struct Args {
  const float* color;    // (H, W, 3) HDR of this frame
  const float* depth;    // (H, W) G-buffer depth
  const float* history;  // (H, W, 3) last frame's resolved image
  float* out;            // (H, W, 3) out
  int H, W;
  // the wrapper's f32 constants (ops/taa.py constants)
  float clip_to_world[16];       // row-major
  float prev_world_to_clip[16];  // row-major
  float jitter[2], prev_jitter[2];
  float lo_x, hi_x, lo_y, hi_y;  // the in-bounds clamp's limits
  float inv_w, inv_h;            // f32(1 / W), f32(1 / H)
  float gauss[9], mitchell[9];   // the 3x3 weights, rows then columns
  float inv_wsum, inv_mn_wsum;   // f32(1 / their f64 sums)
  float inv_span_contrast;       // f32(1 / (0.3 - -0.1))
  float inv_span_clamp;          // f32(1 / (2.0 - 0.0))
};
constexpr int kConsts = 16 + 16 + 2 + 2 + 4 + 2 + 9 + 9 + 2 + 2;

__global__ void __launch_bounds__(kThreads) taa_fused_kernel(const Args a) {
  __shared__ float s_col[kHaloH][kHaloW][3];
  __shared__ float s_dep[kHaloH][kHaloW];
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int bx = blockIdx.x * kTileW, by = blockIdx.y * kTileH;

  // the tile and its one-pixel halo, edge-clamped as taa._shift clamps
  for (int i = ty * kTileW + tx; i < kHaloH * kHaloW; i += kThreads) {
    const int sy = i / kHaloW, sx = i - sy * kHaloW;
    const int gy = min(max(by + sy - 1, 0), a.H - 1);
    const int gx = min(max(bx + sx - 1, 0), a.W - 1);
    const long long p = (long long)gy * a.W + gx;
    s_dep[sy][sx] = __ldg(a.depth + p);
    s_col[sy][sx][0] = __ldg(a.color + 3 * p);
    s_col[sy][sx][1] = __ldg(a.color + 3 * p + 1);
    s_col[sy][sx][2] = __ldg(a.color + 3 * p + 2);
  }
  __syncthreads();
  const int x = bx + tx, y = by + ty;
  if (x >= a.W || y >= a.H) return;
  const int cx = tx + 1, cy = ty + 1;

  // -- reproject --------------------------------------------------------
  float d = s_dep[cy][cx];
#pragma unroll
  for (int dy = -1; dy <= 1; ++dy)
#pragma unroll
    for (int dx = -1; dx <= 1; ++dx)
      if (dy != 0 || dx != 0) d = tmax(d, s_dep[cy + dy][cx + dx]);
  // shading._pixel_ndc: u = (x + 0.5) / W, v = (y + 0.5) / H
  const float u = mul(add((float)x, 0.5f), a.inv_w);
  const float v = mul(add((float)y, 0.5f), a.inv_h);
  const float x_ndc = sub(mul(u, 2.0f), 1.0f);
  const float y_ndc = sub(mul(sub(1.0f, v), 2.0f), 1.0f);
  // shading.world_position_from_depth
  const float* m = a.clip_to_world;
  const float wx = mat4_row(m, x_ndc, y_ndc, d);
  const float wy = mat4_row(m + 4, x_ndc, y_ndc, d);
  const float wz = mat4_row(m + 8, x_ndc, y_ndc, d);
  const float ww = mat4_row(m + 12, x_ndc, y_ndc, d);
  const float w = fabsf(ww) > (float)1e-12
                      ? ww
                      : (ww < 0.0f ? (float)-1e-12 : (float)1e-12);
  const float lim = (float)1e12;
  const float px = clamp(dv(wx, w), -lim, lim);
  const float py = clamp(dv(wy, w), -lim, lim);
  const float pz = clamp(dv(wz, w), -lim, lim);
  const float* pm = a.prev_world_to_clip;
  const float pw = mat4_row(pm + 12, px, py, pz);
  const float prev_x = dv(mat4_row(pm, px, py, pz), pw);
  const float prev_y = dv(mat4_row(pm + 4, px, py, pz), pw);
  const float vel_x =
      sub(add(x_ndc, a.jitter[0]), add(prev_x, a.prev_jitter[0]));
  const float vel_y =
      sub(add(y_ndc, a.jitter[1]), add(prev_y, a.prev_jitter[1]));
  // prev == clamp(prev, lo, hi): false for NaN
  const bool in_bounds = prev_x >= a.lo_x && prev_x <= a.hi_x &&
                         prev_y >= a.lo_y && prev_y <= a.hi_y;
  const float valid = in_bounds ? 1.0f : 0.0f;

  // -- the history fetch (taa._bilinear_clamp, per pixel) ----------------
  const float hist_u = sub(u, mul(vel_x, 0.5f));
  const float hist_v = add(v, mul(vel_y, 0.5f));
  const float fx = sub(mul(hist_u, (float)a.W), 0.5f);
  const float fy = sub(mul(hist_v, (float)a.H), 0.5f);
  const float x0 = floorf(fx), y0 = floorf(fy);
  const float lx = sub(fx, x0), ly = sub(fy, y0);
  // clamp(nan_to_num(floor), 0, W - 1) truncated to int64
  const float nx = isnan(x0) ? 0.0f : (isinf(x0) ? copysignf(FLT_MAX, x0) : x0);
  const float ny = isnan(y0) ? 0.0f : (isinf(y0) ? copysignf(FLT_MAX, y0) : y0);
  const int ix = (int)fminf(fmaxf(nx, 0.0f), (float)(a.W - 1));
  const int iy = (int)fminf(fmaxf(ny, 0.0f), (float)(a.H - 1));
  const int ix1 = min(ix + 1, a.W - 1), iy1 = min(iy + 1, a.H - 1);
  const float* r0 = a.history + 3 * (long long)iy * a.W;
  const float* r1 = a.history + 3 * (long long)iy1 * a.W;
  float hrgb[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float c00 = f16(__ldg(r0 + 3 * ix + k));
    const float c10 = f16(__ldg(r0 + 3 * ix1 + k));
    const float c01 = f16(__ldg(r1 + 3 * ix + k));
    const float c11 = f16(__ldg(r1 + 3 * ix1 + k));
    const float top = add(c00, mul(sub(c10, c00), lx));
    const float bot = add(c01, mul(sub(c11, c01), lx));
    hrgb[k] = add(top, mul(sub(bot, top), ly));
  }
  const V3 hist = rgb_to_ycbcr({hrgb[0], hrgb[1], hrgb[2]});

  // -- the neighbourhood: Gaussian YCbCr moments, Mitchell centre ---------
  V3 vs = {0.0f, 0.0f, 0.0f}, vs2 = {0.0f, 0.0f, 0.0f};
  V3 mn = {0.0f, 0.0f, 0.0f};
#pragma unroll
  for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
    for (int dx = -1; dx <= 1; ++dx) {
      const int i = 3 * (dy + 1) + dx + 1;
      const float* s = s_col[cy + dy][cx + dx];
      const V3 c = {s[0], s[1], s[2]};
      const V3 n = rgb_to_ycbcr(c);
      const float g = a.gauss[i], t = a.mitchell[i];
      vs = {add(vs.x, mul(n.x, g)), add(vs.y, mul(n.y, g)),
            add(vs.z, mul(n.z, g))};
      vs2 = {add(vs2.x, mul(mul(n.x, n.x), g)),
             add(vs2.y, mul(mul(n.y, n.y), g)),
             add(vs2.z, mul(mul(n.z, n.z), g))};
      mn = {add(mn.x, mul(c.x, t)), add(mn.y, mul(c.y, t)),
            add(mn.z, mul(c.z, t))};
    }
  }
  const V3 ex = {mul(vs.x, a.inv_wsum), mul(vs.y, a.inv_wsum),
                 mul(vs.z, a.inv_wsum)};
  const V3 ex2 = {mul(vs2.x, a.inv_wsum), mul(vs2.y, a.inv_wsum),
                  mul(vs2.z, a.inv_wsum)};
  const V3 sd = {__fsqrt_rn(clamp_min(sub(ex2.x, mul(ex.x, ex.x)), 0.0f)),
                 __fsqrt_rn(clamp_min(sub(ex2.y, mul(ex.y, ex.y)), 0.0f)),
                 __fsqrt_rn(clamp_min(sub(ex2.z, mul(ex.z, ex.z)), 0.0f))};
  const float contrast = dv(sd.x, add(ex.x, (float)1e-5));

  // -- the adaptive box ----------------------------------------------------
  const float hpx = mul(hist_u, (float)a.W);
  const float hpy = mul(hist_v, (float)a.H);
  const float frac_x = sub(hpx, floorf(hpx));
  const float frac_y = sub(hpy, floorf(hpy));
  const float tcd = add(fabsf(sub(0.5f, frac_x)), fabsf(sub(0.5f, frac_y)));
  float box = mul(1.0f, add(0.5f, mul(0.5f, smoothstep((float)-0.1,
                                                       a.inv_span_contrast,
                                                       contrast))));
  box = mul(box, add(0.5f, mul(0.5f, clamp(sub(1.0f, tcd), 0.0f, 1.0f))));
  const V3 center = rgb_to_ycbcr({mul(mn.x, a.inv_mn_wsum),
                                  mul(mn.y, a.inv_mn_wsum),
                                  mul(mn.z, a.inv_mn_wsum)});

  // -- clamp and blend -----------------------------------------------------
  const float bs2 = mul(box, box);
  const float bn = mul(box, 1.5f);
  const float h[3] = {hist.x, hist.y, hist.z};
  const float e[3] = {ex.x, ex.y, ex.z};
  const float sg[3] = {sd.x, sd.y, sd.z};
  const float ce[3] = {center.x, center.y, center.z};
  float nmin[3], nmax[3], cl[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const float mid = add(ce[k], mul(sub(e[k], ce[k]), bs2));
    nmin[k] = sub(mid, mul(sg[k], bn));
    nmax[k] = add(mid, mul(sg[k], bn));
    cl[k] = tmin(tmax(h[k], nmin[k]), nmax[k]);
  }
  float blend = add(1.0f, mul((float)(1.0 / 12.0 - 1.0), valid));
  const float cd = dv(tmin(fabsf(sub(h[0], nmin[0])),
                           fabsf(sub(h[0], nmax[0]))),
                      clamp_min(tmax(h[0], e[0]), (float)1e-5));
  blend = mul(blend, add((float)0.2,
                         mul((float)0.8,
                             smoothstep(0.0f, a.inv_span_clamp, cd))));
  float res[3];
#pragma unroll
  for (int k = 0; k < 3; ++k)
    res[k] = add(cl[k], mul(sub(ce[k], cl[k]), blend));
  const V3 rgb = ycbcr_to_rgb({res[0], res[1], res[2]});
  float* o = a.out + 3 * ((long long)y * a.W + x);
  o[0] = rgb.x;
  o[1] = rgb.y;
  o[2] = rgb.z;
}

}  // namespace

// ptrs: color, depth, history, out; consts: the kConsts f32 of Args in
// their order (ops/taa.py constants). H * W > 0: the wrapper launches
// nothing otherwise. Returns cudaGetLastError() after the launch.
extern "C" int voidin_taa(const void* const* ptrs, const float* consts, int H,
                          int W, void* stream) {
  Args a;
  a.color = (const float*)ptrs[0];
  a.depth = (const float*)ptrs[1];
  a.history = (const float*)ptrs[2];
  a.out = (float*)ptrs[3];
  a.H = H;
  a.W = W;
  float* dst[] = {a.clip_to_world, a.prev_world_to_clip, a.jitter,
                  a.prev_jitter, &a.lo_x, &a.hi_x, &a.lo_y, &a.hi_y,
                  &a.inv_w, &a.inv_h, a.gauss, a.mitchell, &a.inv_wsum,
                  &a.inv_mn_wsum, &a.inv_span_contrast, &a.inv_span_clamp};
  const int len[] = {16, 16, 2, 2, 1, 1, 1, 1, 1, 1, 9, 9, 1, 1, 1, 1};
  int at = 0;
  for (int i = 0; i < (int)(sizeof(len) / sizeof(len[0])); ++i)
    for (int j = 0; j < len[i]; ++j) dst[i][j] = consts[at++];
  if (at != kConsts) return (int)cudaErrorInvalidValue;
  const dim3 block(kTileW, kTileH);
  const dim3 grid((W + kTileW - 1) / kTileW, (H + kTileH - 1) / kTileH);
  taa_fused_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
