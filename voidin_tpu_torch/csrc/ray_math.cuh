// Ray-query arithmetic shared by csrc/shadow_trace.cu and
// csrc/closest_hit.cu: the slab test, Moller-Trumbore and the products
// and sums under them, each rounded as the plain PyTorch twins in
// voidin_tpu_torch/rt/traverse.py round it (the library is built with
// -fmad=false, so every + and * below rounds on its own).
//
// Two roundings of a sum of products live here. The shadow walk's twin
// (occluded_reference) sums in jnp.sum's order, ((a0 b0 + a1 b1) + a2 b2),
// and transforms rays with plain products (dot; shadow_trace.cu
// tri_hit_row). The closest-hit
// twin (closest_hit_reference) reproduces JAX's closest_hit bit for bit,
// and XLA compiles that jitted loop body with fused multiply-adds: each
// jnp.sum(a * b) becomes fma(a2, b2, fma(a1, b1, a0 b0)) and each row of
// fastmath.mat4_point / mat3_vec fma(m2, v2, fma(m0, v0, m1 v1)) (dot_fma,
// tri_t, row_fma). A fused multiply-add is taken in f64, where a * b is
// exact, and rounded once to f32, as fastmath._fma emulates it.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}

struct V3 {
  float x, y, z;
};

__device__ __forceinline__ V3 v_sub(V3 a, V3 b) {
  return {sub(a.x, b.x), sub(a.y, b.y), sub(a.z, b.z)};
}
// fastmath.sum3(a * b) = (a0 b0 + a1 b1) + a2 b2
__device__ __forceinline__ float dot(V3 a, V3 b) {
  return add(add(mul(a.x, b.x), mul(a.y, b.y)), mul(a.z, b.z));
}
// fastmath.cross component a_j b_k - a_k b_j: the second product rounded
// to f32, the difference taken in f64 and rounded to f32.
__device__ __forceinline__ float cross_comp(float aj, float bk, float ak,
                                            float bj) {
  const double s = (double)mul(ak, bj);
  return __double2float_rn(__dsub_rn(__dmul_rn((double)aj, (double)bk), s));
}
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {cross_comp(a.y, b.z, a.z, b.y), cross_comp(a.z, b.x, a.x, b.z),
          cross_comp(a.x, b.y, a.y, b.x)};
}
// rt/traverse.py inv_direction: 1 / where(|d| > 1e-20, d, 1e-20)
__device__ __forceinline__ float inv_guarded(float d) {
  return __frcp_rn(fabsf(d) > 1e-20f ? d : 1e-20f);
}
__device__ __forceinline__ V3 inv_direction(V3 d) {
  return {inv_guarded(d.x), inv_guarded(d.y), inv_guarded(d.z)};
}

// max.NaN / min.NaN (sm_80 on): jnp.maximum / jnp.minimum (and
// torch.maximum / minimum / amax / amin) in one instruction each, NaN in
// either operand gives NaN. Of +0 and -0 they may pick the other sign; the
// slab's values only meet comparisons, where the two are equal, so its hit
// and its entry distance order do not change.
__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// rt/traverse.py _slab_lo (intersections.wgsl:13-24): the slab test, hit
// iff hi >= lo && lo < t_max && hi > 0, with the distance at which the ray
// enters the box (*lo_out).
__device__ __forceinline__ bool slab_lo(V3 o, V3 inv, V3 bmin, V3 bmax,
                                        float t_max, float* lo_out) {
  const float x1 = mul(sub(bmin.x, o.x), inv.x);
  const float y1 = mul(sub(bmin.y, o.y), inv.y);
  const float z1 = mul(sub(bmin.z, o.z), inv.z);
  const float x2 = mul(sub(bmax.x, o.x), inv.x);
  const float y2 = mul(sub(bmax.y, o.y), inv.y);
  const float z2 = mul(sub(bmax.z, o.z), inv.z);
  const float hi =
      min_nan(min_nan(max_nan(x1, x2), max_nan(y1, y2)), max_nan(z1, z2));
  const float lo =
      max_nan(max_nan(min_nan(x1, x2), min_nan(y1, y2)), min_nan(z1, z2));
  *lo_out = lo;
  return hi >= lo && lo < t_max && hi > 0.0f;
}

// fastmath._fma: fma(a, b, c) in f64, rounded once to f32
__device__ __forceinline__ float fma_f64(float a, float b, float c) {
  return __double2float_rn(
      __dadd_rn(__dmul_rn((double)a, (double)b), (double)c));
}
// fastmath.dot_fma: fma(a2, b2, fma(a1, b1, a0 b0))
__device__ __forceinline__ float dot_fma(V3 a, V3 b) {
  return fma_f64(a.z, b.z, fma_f64(a.y, b.y, mul(a.x, b.x)));
}
// fastmath._row3_fma: a row of mat3_vec_fma, fma(m2, v2, fma(m0, v0, m1 v1))
__device__ __forceinline__ float row_fma(const float* m, V3 v) {
  return fma_f64(m[2], v.z, fma_f64(m[0], v.x, mul(m[1], v.y)));
}

// rt/traverse.py _tri_t: the hit distance of backface-culled
// Moller-Trumbore with the fused sums of dot_fma, -1 on a miss.
__device__ __forceinline__ float tri_t(V3 o, V3 d,
                                       const float* __restrict__ tri) {
  const V3 v0 = {__ldg(tri + 0), __ldg(tri + 1), __ldg(tri + 2)};
  const V3 v1 = {__ldg(tri + 3), __ldg(tri + 4), __ldg(tri + 5)};
  const V3 v2 = {__ldg(tri + 6), __ldg(tri + 7), __ldg(tri + 8)};
  const V3 e1 = v_sub(v1, v0);
  const V3 e2 = v_sub(v2, v0);
  const V3 uvec = cross(d, e2);
  const float det = dot_fma(e1, uvec);
  const float inv_det = __frcp_rn(fabsf(det) > 1e-20f ? det : 1e-20f);
  const V3 orig = v_sub(o, v0);
  const float u = mul(inv_det, dot_fma(orig, uvec));
  const V3 vvec = cross(orig, e1);
  const float v = mul(inv_det, dot_fma(d, vvec));
  const float t = mul(inv_det, dot_fma(e2, vvec));
  const bool ok = det >= 1e-10f && u >= 0.0f && u <= 1.0f && v >= 0.0f &&
                  add(u, v) <= 1.0f;
  return ok ? t : -1.0f;
}

}  // namespace
