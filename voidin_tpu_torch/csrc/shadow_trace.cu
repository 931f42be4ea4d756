// Any-hit shadow rays through TLAS -> BLAS: one thread per ray, a
// stackless walk over exit links.
//
// Takes the place of the JAX package's lock-step traversals,
// voidin_tpu/rt/traverse.py occluded (:137), occluded_packets (:321) and
// occluded_threaded / _occluded_threaded_core (:616-855), which give the
// same hits. That package has no Pallas kernel here: it walks the tree in
// plain jnp under lax.while_loop, one node per ray (or packet) a step. In
// eager PyTorch each step of such a loop would sync with the host, so the
// port walks in this kernel. Its plain PyTorch twin is
// voidin_tpu_torch/rt/traverse.py occluded_reference.
//
// What it computes, per active ray r (origin o, direction d, not
// normalized; t_max in units of |d|), over the threaded table of
// rt/traverse.py pack_threaded_table (64 B rows [min3, a, max3, exit,
// count, pad]; TLAS rows first, a = left child or -(instance + 1) at a
// leaf; BLAS rows after, a = mesh-local left_first, leaf iff count > 0;
// exits encoded e + 1, 0 = done, BLAS exits mesh-local):
//   cur = TLAS root; at each node one slab test (world space at TLAS nodes,
//   object space inside a BLAS). Internal hit -> first child; miss -> exit
//   link. TLAS leaf hit -> transform the ray by the instance row's inverse
//   (fastmath.mat4_point / mat3_vec order), 1/d with the 1e-20 guard, save
//   the leaf's exit in `resume`, jump to the BLAS root. BLAS leaf hit ->
//   Moller-Trumbore on its count <= 8 triangles tri_pos[tri_base +
//   left_first + i], stop at the first hit. A BLAS exit of 0 resumes at
//   `resume`. hit[r] = 1 byte; rays still walking after max_steps nodes
//   add one to *exhausted.
// Every step is rounded as the twin rounds it: the library is built with
// -fmad=false, sums keep jnp.sum's order ((a0 + a1) + a2), 1/x is the IEEE
// reciprocal, the slab's max / min let NaN through as jnp.maximum /
// jnp.minimum do (fmaxf / fminf would drop it), and the cross products
// follow fastmath.cross: a_j b_k - rnd(a_k b_j) taken in f64, where the
// first product is exact, and rounded once to f32 (jnp.cross's fused
// multiply-add, as the twin emulates it). So kernel and twin give the same
// bits on every ray.
//
// What bounds it on an H100. Per ray 24 B in and 1 B out, plus the table,
// instance and triangle rows once; the walk's arithmetic is ~12 FP32
// operations a node visit, ~30 an instance entry and ~40 a triangle test.
// At 1080p the bytes are ~50 MB (15 us at 3.35 TB/s) and the operations a
// few hundred million (a few us at 67 TFLOP/s): the bound is the bytes.
// What a walk costs in practice is neither: it is the dependent chain of
// node fetches (each node's row decides the next address) and the
// divergence of the rays of a warp, which walk different paths and take
// different numbers of steps. Design: one thread per ray, 128-thread
// blocks, rays in screen order so that a warp's rays are neighbours and
// mostly share their path; rows read through the read-only cache (__ldg,
// two 16 B loads a node), so the upper tree levels, which every ray
// visits, stay in L1/L2. No stack: the state is the ray, its object-space
// copy and four ints, all in registers.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kRowFloats = 16;
constexpr int kInstFloats = 24;

__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}

// jnp.maximum / jnp.minimum (and torch.maximum / minimum / amax / amin):
// NaN in either operand gives NaN.
__device__ __forceinline__ float max_nan(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
}
__device__ __forceinline__ float min_nan(float a, float b) {
  return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
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

// rt/traverse.py _slab (intersections.wgsl:13-24)
__device__ __forceinline__ bool slab(V3 o, V3 inv, V3 bmin, V3 bmax,
                                     float t_max) {
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
  return hi >= lo && lo < t_max && hi > 0.0f;
}

// rt/traverse.py _tri_hit: backface-culled Moller-Trumbore
// (intersections.wgsl:26-45) on one (9,) corner row.
__device__ __forceinline__ bool tri_hit(V3 o, V3 d,
                                        const float* __restrict__ tri,
                                        float t_max) {
  const V3 v0 = {__ldg(tri + 0), __ldg(tri + 1), __ldg(tri + 2)};
  const V3 v1 = {__ldg(tri + 3), __ldg(tri + 4), __ldg(tri + 5)};
  const V3 v2 = {__ldg(tri + 6), __ldg(tri + 7), __ldg(tri + 8)};
  const V3 e1 = v_sub(v1, v0);
  const V3 e2 = v_sub(v2, v0);
  const V3 uvec = cross(d, e2);
  const float det = dot(e1, uvec);
  const float inv_det = __frcp_rn(fabsf(det) > 1e-20f ? det : 1e-20f);
  const V3 orig = v_sub(o, v0);
  const float u = mul(inv_det, dot(orig, uvec));
  const V3 vvec = cross(orig, e1);
  const float v = mul(inv_det, dot(d, vvec));
  const float t = mul(inv_det, dot(e2, vvec));
  return det >= 1e-10f && u >= 0.0f && u <= 1.0f && v >= 0.0f &&
         add(u, v) <= 1.0f && t > 0.0f && t < t_max;
}

__global__ void __launch_bounds__(kThreads)
shadow_trace_kernel(const float* __restrict__ table, int n_tlas,
                    const float* __restrict__ inst,
                    const float* __restrict__ tri_pos,
                    const float* __restrict__ origins,
                    const float* __restrict__ dirs,
                    const uint8_t* __restrict__ active, long long n_rays,
                    float t_max, int max_steps, uint8_t* __restrict__ hit_out,
                    int* __restrict__ exhausted) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rays) return;
  if (active != nullptr && !active[r]) return;  // hit_out stays 0
  const V3 o = {__ldg(origins + 3 * r), __ldg(origins + 3 * r + 1),
                __ldg(origins + 3 * r + 2)};
  const V3 d = {__ldg(dirs + 3 * r), __ldg(dirs + 3 * r + 1),
                __ldg(dirs + 3 * r + 2)};
  const V3 inv0 = inv_direction(d);
  V3 co = o, cd = d, cinv = inv0;  // the ray in the current BLAS's space
  int cur = 1, resume = 0, tri_base = 0, bvh_base = 0;
  bool hit = false;
  for (int step = 0; cur != 0 && step < max_steps; ++step) {
    const bool is_blas = cur < 0;
    const int node = is_blas ? n_tlas - cur - 1 : cur - 1;
    const float4* row =
        reinterpret_cast<const float4*>(table + (size_t)node * kRowFloats);
    const float4 r0 = __ldg(row);
    const float4 r1 = __ldg(row + 1);
    const V3 bmin = {r0.x, r0.y, r0.z};
    const V3 bmax = {r1.x, r1.y, r1.z};
    const float a = r0.w;
    const int exit_enc = (int)r1.w;
    if (!is_blas) {
      if (!slab(o, inv0, bmin, bmax, t_max)) {
        cur = exit_enc;
      } else if (a >= 0.0f) {
        cur = (int)a + 1;
      } else {  // instance leaf: enter its BLAS in object space
        const float* ir = inst + (size_t)(int)(-a - 1.0f) * kInstFloats;
        float m[12];
#pragma unroll
        for (int k = 0; k < 12; ++k) m[k] = __ldg(ir + k);
        // fastmath.mat4_point / mat3_vec: ((m0 p0 + m1 p1) + m2 p2) + m3
        co = {add(add(add(mul(m[0], o.x), mul(m[1], o.y)), mul(m[2], o.z)),
                  m[3]),
              add(add(add(mul(m[4], o.x), mul(m[5], o.y)), mul(m[6], o.z)),
                  m[7]),
              add(add(add(mul(m[8], o.x), mul(m[9], o.y)), mul(m[10], o.z)),
                  m[11])};
        cd = {add(add(mul(m[0], d.x), mul(m[1], d.y)), mul(m[2], d.z)),
              add(add(mul(m[4], d.x), mul(m[5], d.y)), mul(m[6], d.z)),
              add(add(mul(m[8], d.x), mul(m[9], d.y)), mul(m[10], d.z))};
        cinv = inv_direction(cd);
        bvh_base = (int)__ldg(ir + 16);
        tri_base = (int)__ldg(ir + 17);
        resume = exit_enc;
        cur = -(bvh_base + 1);
      }
      continue;
    }
    if (slab(co, cinv, bmin, bmax, t_max)) {
      const int count = (int)__ldg(table + (size_t)node * kRowFloats + 8);
      const int left = (int)a;
      if (count <= 0) {
        cur = -(bvh_base + left + 1);
        continue;
      }
      const float* tri = tri_pos + (size_t)(tri_base + left) * 9;
      for (int k = 0; k < count && !hit; ++k) {
        hit = tri_hit(co, cd, tri + 9 * k, t_max);
      }
      if (hit) break;
    }
    cur = exit_enc > 0 ? -(bvh_base + exit_enc) : resume;
  }
  hit_out[r] = hit ? 1 : 0;
  if (!hit && cur != 0) atomicAdd(exhausted, 1);
}

}  // namespace

// R > 0 rays and at least one instance: the wrapper launches nothing
// otherwise. `active` may be null (every ray active); hit_out and
// *exhausted are zeroed by the caller.
extern "C" int voidin_shadow_trace(const void* table, int n_tlas,
                                   const void* inst, const void* tri_pos,
                                   const void* origins, const void* dirs,
                                   const void* active, long long n_rays,
                                   float t_max, int max_steps, void* hit_out,
                                   void* exhausted, void* stream) {
  const long long blocks = (n_rays + kThreads - 1) / kThreads;
  shadow_trace_kernel<<<(unsigned)blocks, kThreads, 0,
                        (cudaStream_t)stream>>>(
      (const float*)table, n_tlas, (const float*)inst,
      (const float*)tri_pos, (const float*)origins, (const float*)dirs,
      (const uint8_t*)active, n_rays, t_max, max_steps, (uint8_t*)hit_out,
      (int*)exhausted);
  return (int)cudaGetLastError();
}
