// Shared device math of the fused LTC kernels (ltc_rect.cu, ltc_ring.cu):
// each step rounded as the plain PyTorch twins round it on the card (the
// library is built with -fmad=false; sums in the twins' order; IEEE
// division and square root; clamps that let NaN through), and K3's
// bilinear fetch of the (64, 64, 4) LTC tables through L1
// (csrc/lut_fetch.cu semantics: rows first, clamp-edge weight merge; kBf16
// is LTC_LUT_BF16).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace ltc {

constexpr int kT = 64;  // table side
constexpr int kThreads = 256;
constexpr float kLutScale = (float)((64.0 - 1.0) / 64.0);
constexpr float kLutBias = (float)(0.5 / 64.0);

__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}

// torch.clamp(x, min=lo) / torch.clamp(x, lo, hi): NaN passes through.
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return isnan(x) ? x : fmaxf(x, lo);
}
__device__ __forceinline__ float clamp(float x, float lo, float hi) {
  return isnan(x) ? x : fminf(fmaxf(x, lo), hi);
}

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 v_sub(V3 a, V3 b) {
  return {sub(a.x, b.x), sub(a.y, b.y), sub(a.z, b.z)};
}
__device__ __forceinline__ V3 v_add(V3 a, V3 b) {
  return {add(a.x, b.x), add(a.y, b.y), add(a.z, b.z)};
}
__device__ __forceinline__ V3 v_scale(V3 a, float s) {
  return {mul(a.x, s), mul(a.y, s), mul(a.z, s)};
}
// _sum3(a * b) = (a0 b0 + a1 b1) + a2 b2
__device__ __forceinline__ float dot(V3 a, V3 b) {
  return add(add(mul(a.x, b.x), mul(a.y, b.y)), mul(a.z, b.z));
}
// _cross: each component a_j b_k - a_k b_j, separately rounded
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {sub(mul(a.y, b.z), mul(a.z, b.y)), sub(mul(a.z, b.x), mul(a.x, b.z)),
          sub(mul(a.x, b.y), mul(a.y, b.x))};
}
// _normalize: v / sqrt(clamp(v . v, min=1e-20))
__device__ __forceinline__ V3 normalize(V3 v) {
  const float s = __fsqrt_rn(clamp_min(dot(v, v), (float)1e-20));
  return {__fdiv_rn(v.x, s), __fdiv_rn(v.y, s), __fdiv_rn(v.z, s)};
}

struct M3 {
  float m[3][3];
};

// fastmath.mat3_mat3: c[i][j] = (a[i][0] b[0][j] + a[i][1] b[1][j])
//                               + a[i][2] b[2][j]
__device__ __forceinline__ M3 mat3_mat3(const M3& a, const M3& b) {
  M3 c;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      c.m[i][j] = add(
          add(mul(a.m[i][0], b.m[0][j]), mul(a.m[i][1], b.m[1][j])),
          mul(a.m[i][2], b.m[2][j]));
    }
  }
  return c;
}

// fastmath.mat3_vec, a row at a time: (r0 v.x + r1 v.y) + r2 v.z
__device__ __forceinline__ float row_dot(const float* r, V3 v) {
  return add(add(mul(r[0], v.x), mul(r[1], v.y)), mul(r[2], v.z));
}

__device__ __forceinline__ V3 mat3_vec(const M3& a, V3 v) {
  return {row_dot(a.m[0], v), row_dot(a.m[1], v), row_dot(a.m[2], v)};
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// K3's taps along one axis (csrc/lut_fetch.cu taps).
__device__ __forceinline__ void taps(float f, int& i0, int& i1, float& w0,
                                     float& w1) {
  float fl = floorf(f);
  fl = fminf(fmaxf(fl, 0.0f), (float)(kT - 1));
  const float t = sub(f, fl);
  i0 = (int)fl;
  i1 = i0 + 1 < kT ? i0 + 1 : kT - 1;
  const float one_minus = sub(1.0f, t);
  if (i1 == i0) {
    w0 = add(one_minus, t);
    w1 = 0.0f;
  } else {
    w0 = one_minus;
    w1 = t;
  }
}

// The four texel offsets and bilinear weights of one fetch at a uv
// pre-scaled by LUT_SCALE/BIAS.
template <bool kBf16>
struct Taps {
  int o00, o10, o01, o11;  // (row, column) = (y0, x0), (y1, x0), ...
  float wx0, wx1, wy0, wy1;

  __device__ __forceinline__ Taps(float u, float v) {
    int x0, x1, y0, y1;
    taps(sub(mul(u, (float)kT), 0.5f), x0, x1, wx0, wx1);
    taps(sub(mul(v, (float)kT), 0.5f), y0, y1, wy0, wy1);
    if (kBf16) {
      wy0 = round_bf16(wy0);
      wy1 = round_bf16(wy1);
    }
    o00 = y0 * kT + x0;
    o10 = y1 * kT + x0;
    o01 = y0 * kT + x1;
    o11 = y1 * kT + x1;
  }

  // rows first, then columns
  __device__ __forceinline__ float lerp(float a00, float a10, float a01,
                                        float a11) const {
    if (kBf16) {
      a00 = round_bf16(a00);
      a10 = round_bf16(a10);
      a01 = round_bf16(a01);
      a11 = round_bf16(a11);
    }
    const float r0 = add(mul(wy0, a00), mul(wy1, a10));
    const float r1 = add(mul(wy0, a01), mul(wy1, a11));
    return add(mul(wx0, r0), mul(wx1, r1));
  }
};

// Table access through L1: the (64, 64, 4) tables as stored.
struct Tables {
  const float4* ltc1;
  const float4* ltc2;
  __device__ __forceinline__ float4 t1(int o) const { return __ldg(ltc1 + o); }
  __device__ __forceinline__ float t2x(int o) const {
    return __ldg(reinterpret_cast<const float*>(ltc2 + o));
  }
  __device__ __forceinline__ float t2w(int o) const {
    return __ldg(reinterpret_cast<const float*>(ltc2 + o) + 3);
  }
};

}  // namespace ltc
