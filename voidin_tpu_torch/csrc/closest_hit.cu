// Closest-hit rays through TLAS -> BLAS: one thread per ray, a per-ray
// stack walk in JAX's push order.
//
// Takes the place of the JAX package's closest_hit
// (voidin_tpu/rt/traverse.py:889-1021, the src/bin/bvh_trace.wgsl demo),
// which walks every ray's stack in lock-step in plain jnp under
// lax.while_loop: there is no Pallas kernel to port, and in eager PyTorch
// each step of such a loop would sync with the host. Its plain PyTorch twin
// is voidin_tpu_torch/rt/traverse.py closest_hit_reference.
//
// What it computes, per active ray r (origin o, direction d, not
// normalized; t starts at t_out[r], the caller's t_max, in units of |d|),
// over the row layouts of rt/traverse.py scene_rays (TLAS rows [min3, a,
// max3, b] with a = left, b = right child, or a = -1, b = instance at a
// leaf; BLAS rows [min3, left_first, max3, count], leaf iff count > 0,
// children mesh-local; instance rows [inverse transform 16, BLAS root,
// first triangle, pad]):
//   stack = [TLAS root]. Pop an entry (+1 per pop in visits[r]): TLAS
//   node n (entry n + 1): slab test in world space against the best t so
//   far; internal hit -> push left + 1, then right + 1; leaf hit -> move
//   the ray into the instance's object space, push -(BLAS root + 1). BLAS
//   node n (entry -(n + 1)): slab test in object space; leaf hit -> each
//   of its count <= 8 triangles whose t lies in (0, t) becomes the best;
//   internal hit -> push -(base + left + 1), then -(base + left + 2). A
//   push onto a full stack (kStack entries) is dropped and counted in
//   *overflow. The walk ends when the stack is empty or after max_steps
//   pops; a ray that stops with a stack left counts in *exhausted.
// The pops follow JAX's order and every prune uses the best t of the same
// pop, so t, the visits and both counters are JAX's, not only the nearest
// hit. Rounding as the twin's (csrc/ray_math.cuh): -fmad=false, IEEE
// reciprocals with the 1e-20 guard, the slab's NaN-passing max / min, and
// the fused multiply-adds XLA puts in the jitted JAX loop (dot_fma,
// row_fma), taken in f64 and rounded once.
//
// What bounds it on an H100. Per ray 24 B in and 8 B out plus the rows
// once: at 1080p ~66 MB, 20 us at 3.35 TB/s; the operations (~12 a node
// visit, ~30 an instance entry, ~60 a triangle test with its f64 fused
// sums) are a few hundred million, a few us. The walk itself is neither:
// a dependent chain of row fetches per ray, divergent warps, and a walk
// that cannot stop at its first hit. Design (simple and right first): one
// thread per ray in screen order, so a warp's rays are neighbours and
// mostly share their path; rows read through the read-only cache (__ldg,
// two 16 B loads a node), so the upper levels every ray visits stay in
// L1/L2; the 48-entry stack in local memory (192 B a thread, cached in
// L1), the rest of the state in registers.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ray_math.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kStack = 48;  // rt/traverse.py STACK
constexpr int kRowFloats = 8;
constexpr int kInstFloats = 24;

__device__ __forceinline__ void push(int* stack, int& sp, int& overflow,
                                     int value) {
  if (sp >= kStack) {
    ++overflow;
  } else {
    stack[sp++] = value;
  }
}

__global__ void __launch_bounds__(kThreads)
closest_hit_kernel(const float* __restrict__ tlas,
                   const float* __restrict__ blas,
                   const float* __restrict__ inst,
                   const float* __restrict__ tri_pos,
                   const float* __restrict__ origins,
                   const float* __restrict__ dirs,
                   const uint8_t* __restrict__ active, long long n_rays,
                   int max_steps, float* __restrict__ t_out,
                   int* __restrict__ visits_out, int* __restrict__ overflow,
                   int* __restrict__ exhausted) {
  const long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= n_rays) return;
  if (active != nullptr && !active[r]) return;  // t stays t_max, visits 0
  const V3 o = {__ldg(origins + 3 * r), __ldg(origins + 3 * r + 1),
                __ldg(origins + 3 * r + 2)};
  const V3 d = {__ldg(dirs + 3 * r), __ldg(dirs + 3 * r + 1),
                __ldg(dirs + 3 * r + 2)};
  const V3 inv0 = inv_direction(d);
  float t = t_out[r];
  V3 co = o, cd = d, cinv = inv0;  // the ray in the current BLAS's space
  int tri_base = 0, bvh_base = 0;
  int stack[kStack];
  int sp = 1, visits = 0, ovf = 0;
  stack[0] = 1;
  while (sp > 0 && visits < max_steps) {
    const int entry = stack[--sp];
    ++visits;
    if (entry > 0) {
      const float4* row = reinterpret_cast<const float4*>(
          tlas + (size_t)(entry - 1) * kRowFloats);
      const float4 r0 = __ldg(row);
      const float4 r1 = __ldg(row + 1);
      if (!slab(o, inv0, {r0.x, r0.y, r0.z}, {r1.x, r1.y, r1.z}, t)) {
        continue;
      }
      if (!(r0.w < 0.0f)) {  // internal: left, then right
        push(stack, sp, ovf, (int)r0.w + 1);
        push(stack, sp, ovf, (int)r1.w + 1);
        continue;
      }
      // instance leaf: the ray in object space (fastmath.mat4_point_fma /
      // mat3_vec_fma), then its BLAS root
      const float* ir = inst + (size_t)(int)r1.w * kInstFloats;
      float m[12];
#pragma unroll
      for (int k = 0; k < 12; ++k) m[k] = __ldg(ir + k);
      co = {add(row_fma(m, o), m[3]), add(row_fma(m + 4, o), m[7]),
            add(row_fma(m + 8, o), m[11])};
      cd = {row_fma(m, d), row_fma(m + 4, d), row_fma(m + 8, d)};
      cinv = inv_direction(cd);
      bvh_base = (int)__ldg(ir + 16);
      tri_base = (int)__ldg(ir + 17);
      push(stack, sp, ovf, -(bvh_base + 1));
      continue;
    }
    const float4* row = reinterpret_cast<const float4*>(
        blas + (size_t)(-entry - 1) * kRowFloats);
    const float4 r0 = __ldg(row);
    const float4 r1 = __ldg(row + 1);
    if (!slab(co, cinv, {r0.x, r0.y, r0.z}, {r1.x, r1.y, r1.z}, t)) {
      continue;
    }
    const int left = (int)r0.w;
    const int count = (int)r1.w;
    if (count <= 0) {  // internal: left + 1, then left + 2
      push(stack, sp, ovf, -(bvh_base + left + 1));
      push(stack, sp, ovf, -(bvh_base + left + 2));
      continue;
    }
    const float* tri = tri_pos + (size_t)(tri_base + left) * 9;
    for (int k = 0; k < count; ++k) {
      const float th = tri_t(co, cd, tri + 9 * k);
      if (th > 0.0f && th < t) t = th;
    }
  }
  t_out[r] = t;
  visits_out[r] = visits;
  if (ovf) atomicAdd(overflow, ovf);
  if (sp > 0) atomicAdd(exhausted, 1);
}

}  // namespace

// R > 0 rays and at least one instance: the wrapper launches nothing
// otherwise. `active` may be null (every ray active); t_out holds each
// ray's t_max, visits_out, *overflow and *exhausted are zeroed by the
// caller.
extern "C" int voidin_closest_hit(const void* tlas, const void* blas,
                                  const void* inst, const void* tri_pos,
                                  const void* origins, const void* dirs,
                                  const void* active, long long n_rays,
                                  int max_steps, void* t_out,
                                  void* visits_out, void* overflow,
                                  void* exhausted, void* stream) {
  const long long blocks = (n_rays + kThreads - 1) / kThreads;
  closest_hit_kernel<<<(unsigned)blocks, kThreads, 0,
                       (cudaStream_t)stream>>>(
      (const float*)tlas, (const float*)blas, (const float*)inst,
      (const float*)tri_pos, (const float*)origins, (const float*)dirs,
      (const uint8_t*)active, n_rays, max_steps, (float*)t_out,
      (int*)visits_out, (int*)overflow, (int*)exhausted);
  return (int)cudaGetLastError();
}
