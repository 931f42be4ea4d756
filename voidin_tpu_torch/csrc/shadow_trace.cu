// Any-hit shadow rays through TLAS -> BLAS: one thread a ray, each step
// testing both children of a node, nearer box first.
//
// Takes the place of the JAX package's lock-step traversals,
// voidin_tpu/rt/traverse.py occluded (:137), occluded_packets (:321) and
// occluded_threaded / _occluded_threaded_core (:616-855), which give the
// same hits. That package has no Pallas kernel here: it walks the tree in
// plain jnp under lax.while_loop, one node per ray (or packet) a step. In
// eager PyTorch each step of such a loop would sync with the host, so the
// port walks in this kernel. Its plain PyTorch twin is
// voidin_tpu_torch/rt/traverse.py occluded_reference; the layout is
// rt/traverse.py pack_shadow_rows (ShadowRows), integers as int32 bits.
//
// What it computes, per active ray r (origin o, direction d, not
// normalized; t_max in units of |d|): the twin's walk, step for step. An
// entry is kind << 30 | index: a TLAS node to expand (TLAS rows [min3,
// left, max3, right], a leaf [min3, -(instance + 1), max3, -1]; the
// virtual root n_tlas has one child, the root), an instance to enter
// (rows of 16 words: the inverse transform's first 12, the mesh's BLAS
// root, its first triangle) or a BLAS node to expand, given by the pool
// row of its first child (BLAS rows [min3, left_first, max3, count],
// mesh-local left_first; a node's children are adjacent rows). A step
// slab-tests the entry's children (an instance: the ray moved into object
// space by fastmath.mat4_point / mat3_vec, 1/d with the 1e-20 guard, then
// its BLAS root alone); each hit child in order becomes an entry, or for a
// BLAS leaf has its <= 8 triangles ([v0, e1, e2] rows) tested at once,
// where a hit ends the walk. Of two entries the one whose box the ray
// enters first (the slab's tmin') is next and the other goes on the ray's
// stack (kStack; a push onto a full stack is dropped and counted); with
// none the next comes off the stack. hit[r] = 1 byte; rays still walking
// after max_steps steps add one to counters[0], dropped pushes to
// counters[1].
// Every step is rounded as the twin rounds it: the library is built with
// -fmad=false, sums keep jnp.sum's order ((a0 + a1) + a2), 1/x is the IEEE
// reciprocal, the slab's max / min let NaN through as jnp.maximum /
// jnp.minimum do, and the cross products follow fastmath.cross
// (ray_math.cuh).
//
// What bounds it on an H100. Per ray 24 B in and 1 B out, plus the tables
// once; ~12 FP32 operations a box test, ~30 an instance entry, ~40 a
// triangle test: at 1080p a byte bound of ~10 us. What sets its time is
// neither: it is the longest walks, each a chain of dependent steps. In
// the config-5 frame the former kernel (one node a step, 64 B rows)
// walked the 1,024 rays with the most node visits (160-279 of a mean of
// 23) in 0.235 ms of its 0.37 (PERF.md §6). What shortened the chain,
// measured on the card: NaN-propagating min / max as one instruction each
// (max.NaN / min.NaN; the select chains they replace were most of a
// step), half the steps (two children a step, their two 32 B rows read
// together), the TLAS and instance rows (~5 KB in config 5) in shared
// memory, triangle rows that carry their edges (three float4 loads, no
// subtractions). What did not, in the same runs: persistent warps fed
// active rays by a global counter (they put the longest rays of the frame
// into the same warps: 0.47-0.87 ms), a register-resident stack with
// prefetched pops, two triangles' rows loaded at once (more registers,
// fewer resident blocks) and an L1-heavy carveout. The layout is rebuilt
// every frame (the skinned scene refits its boxes) by one launch of
// pack_shadow_rows_kernel below: its twin's ~25 eager ops cost the shade
// stage more host time than the walk saved.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ray_math.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kStack = 128;   // rt/traverse.py SHADOW_STACK
constexpr int kShift = 30;    // rt/traverse.py KIND_SHIFT
constexpr int kNoChild = -2;  // rt/traverse.py NO_CHILD
constexpr uint32_t kBlas = 0u, kTlas = 1u, kInst = 2u;
constexpr uint32_t kIndex = (1u << kShift) - 1u;
// the TLAS and instance rows go to shared memory up to this size
constexpr int kTopShared = 96 * 1024;

__device__ __forceinline__ uint32_t entry(uint32_t kind, int idx) {
  return (kind << kShift) | (uint32_t)idx;
}

// rt/traverse.py _tri_hit_edges on one triangle row [v0, e1, e2, pad]
__device__ __forceinline__ bool tri_hit_row(V3 o, V3 d, float4 p, float4 q,
                                            float4 s, float t_max) {
  const V3 v0 = {p.x, p.y, p.z};
  const V3 e1 = {p.w, q.x, q.y};
  const V3 e2 = {q.z, q.w, s.x};
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

// A BLAS leaf's triangles: true on the first hit.
__device__ __forceinline__ bool leaf_hit(const float4* __restrict__ tris,
                                         int first, int count, V3 o, V3 d,
                                         float t_max) {
  const float4* t = tris + 3 * (size_t)first;
  for (int k = 0; k < count; ++k) {
    if (tri_hit_row(o, d, __ldg(t + 3 * k), __ldg(t + 3 * k + 1),
                    __ldg(t + 3 * k + 2), t_max)) {
      return true;
    }
  }
  return false;
}

struct Walk {
  bool hit;
  bool live;  // still walking at max_steps
  int dropped;
};

// One ray's walk (the twin's occluded_reference): of two hit children,
// the one whose box the ray enters first is taken first.
__device__ Walk walk(const float4* tlas, const float4* inst,
                     const float4* __restrict__ blas,
                     const float4* __restrict__ tris, int n_tlas, V3 o, V3 d,
                     float t_max, int max_steps) {
  const V3 inv0 = inv_direction(d);
  V3 co = o, cd = d, cinv = inv0;
  int bvh_base = 0, tri_base = 0, sp = 0, dropped = 0;
  uint32_t stack[kStack];
  uint32_t cur = entry(kTlas, n_tlas);
  bool live = true, hit = false;
  for (int step = 0; live && step < max_steps; ++step) {
    const uint32_t kind = cur >> kShift;
    const int idx = (int)(cur & kIndex);
    const float4 zero = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    float4 a0 = zero, b0 = zero, a1 = zero, b1 = zero;
    bool two;
    int child0 = 0, child1 = 0;
    if (kind == kTlas) {
      const float4 na = tlas[2 * idx], nb = tlas[2 * idx + 1];
      child0 = __float_as_int(na.w);
      child1 = __float_as_int(nb.w);
      a0 = tlas[2 * child0];
      b0 = tlas[2 * child0 + 1];
      two = child1 >= 0;
      if (two) {
        a1 = tlas[2 * child1];
        b1 = tlas[2 * child1 + 1];
      }
    } else {
      int row = idx;
      if (kind == kInst) {
        const float4* ir = inst + 4 * idx;
        const float4 m0 = ir[0], m1 = ir[1], m2 = ir[2], m3 = ir[3];
        // fastmath.mat4_point / mat3_vec: ((m0 p0 + m1 p1) + m2 p2) + m3
        co = {add(add(add(mul(m0.x, o.x), mul(m0.y, o.y)), mul(m0.z, o.z)),
                  m0.w),
              add(add(add(mul(m1.x, o.x), mul(m1.y, o.y)), mul(m1.z, o.z)),
                  m1.w),
              add(add(add(mul(m2.x, o.x), mul(m2.y, o.y)), mul(m2.z, o.z)),
                  m2.w)};
        cd = {add(add(mul(m0.x, d.x), mul(m0.y, d.y)), mul(m0.z, d.z)),
              add(add(mul(m1.x, d.x), mul(m1.y, d.y)), mul(m1.z, d.z)),
              add(add(mul(m2.x, d.x), mul(m2.y, d.y)), mul(m2.z, d.z))};
        cinv = inv_direction(cd);
        bvh_base = __float_as_int(m3.x);
        tri_base = __float_as_int(m3.y);
        row = bvh_base;
      }
      const float4* br = blas + 2 * (size_t)row;
      a0 = __ldg(br);
      b0 = __ldg(br + 1);
      two = kind == kBlas;
      if (two) {
        a1 = __ldg(br + 2);
        b1 = __ldg(br + 3);
      }
    }
    const bool world = kind == kTlas;
    const V3 ro = world ? o : co;
    const V3 rinv = world ? inv0 : cinv;
    float lo0 = 0.0f, lo1 = 0.0f;
    const bool h0 = slab_lo(ro, rinv, {a0.x, a0.y, a0.z}, {b0.x, b0.y, b0.z},
                            t_max, &lo0);
    const bool h1 = two && slab_lo(ro, rinv, {a1.x, a1.y, a1.z},
                                   {b1.x, b1.y, b1.z}, t_max, &lo1);
    // each hit child: an entry, or a leaf's triangles
    bool c0 = false, c1 = false;
    uint32_t e0 = 0, e1 = 0;
    if (h0) {
      const int ref = __float_as_int(a0.w);
      if (world) {
        c0 = true;
        e0 = ref >= 0 ? entry(kTlas, child0) : entry(kInst, -ref - 1);
      } else if (__float_as_int(b0.w) <= 0) {
        c0 = true;
        e0 = entry(kBlas, bvh_base + ref);
      } else if (leaf_hit(tris, tri_base + ref, __float_as_int(b0.w), co,
                          cd, t_max)) {
        hit = true;
        break;
      }
    }
    if (h1) {
      const int ref = __float_as_int(a1.w);
      if (world) {
        c1 = true;
        e1 = ref >= 0 ? entry(kTlas, child1) : entry(kInst, -ref - 1);
      } else if (__float_as_int(b1.w) <= 0) {
        c1 = true;
        e1 = entry(kBlas, bvh_base + ref);
      } else if (leaf_hit(tris, tri_base + ref, __float_as_int(b1.w), co,
                          cd, t_max)) {
        hit = true;
        break;
      }
    }
    if (c0 && c1) {
      const bool swap = lo1 < lo0;
      if (sp < kStack) {
        stack[sp++] = swap ? e0 : e1;
      } else {
        ++dropped;
      }
      cur = swap ? e1 : e0;
    } else if (c0 || c1) {
      cur = c0 ? e0 : e1;
    } else if (sp > 0) {
      cur = stack[--sp];
    } else {
      live = false;
    }
  }
  return {hit, live && !hit, dropped};
}

// The walk of the ray in lane r (origin, direction) into hit_out and the
// thread's counts.
__device__ __forceinline__ void walk_lane(
    int r, const float4* tlas, const float4* inst,
    const float4* __restrict__ blas, const float4* __restrict__ tris,
    int n_tlas, const float* __restrict__ origins,
    const float* __restrict__ dirs, float t_max, int max_steps,
    uint8_t* __restrict__ hit_out, int* exhausted, int* dropped) {
  const V3 o = {__ldg(origins + 3 * r), __ldg(origins + 3 * r + 1),
                __ldg(origins + 3 * r + 2)};
  const V3 d = {__ldg(dirs + 3 * r), __ldg(dirs + 3 * r + 1),
                __ldg(dirs + 3 * r + 2)};
  const Walk w = walk(tlas, inst, blas, tris, n_tlas, o, d, t_max,
                      max_steps);
  if (w.hit) hit_out[r] = 1;
  *exhausted += w.live;
  *dropped += w.dropped;
}

// One thread a lane; inactive lanes return at once.
__global__ void __launch_bounds__(kThreads)
shadow_trace_kernel(const float4* __restrict__ top, int n_tlas, int n_inst,
                    int top_shared, const float4* __restrict__ blas,
                    const float4* __restrict__ tris,
                    const float* __restrict__ origins,
                    const float* __restrict__ dirs,
                    const uint8_t* __restrict__ active, int n_rays,
                    float t_max, int max_steps, uint8_t* __restrict__ hit_out,
                    int* __restrict__ counters) {
  extern __shared__ float4 smem[];
  const int top_f4 = (n_tlas + 1) * 2 + n_inst * 4;
  const float4* tp = top;
  if (top_shared) {
    for (int i = threadIdx.x; i < top_f4; i += kThreads) {
      smem[i] = __ldg(top + i);
    }
    __syncthreads();
    tp = smem;
  }
  const int r = blockIdx.x * kThreads + threadIdx.x;
  if (r >= n_rays || (active != nullptr && !active[r])) return;
  int exhausted = 0, dropped = 0;
  walk_lane(r, tp, tp + (n_tlas + 1) * 2, blas, tris, n_tlas,
                   origins, dirs, t_max, max_steps, hit_out, &exhausted,
                   &dropped);
  if (exhausted) atomicAdd(counters, exhausted);
  if (dropped) atomicAdd(counters + 1, dropped);
}

int shared_bytes(int n_tlas, int n_inst, bool* top_shared) {
  const int top = ((n_tlas + 1) * 2 + n_inst * 4) * 16;
  *top_shared = top <= kTopShared;
  return *top_shared ? top : 0;
}

// rt/traverse.py pack_shadow_rows in one launch: thread i writes TLAS row i
// (row n_tlas is the virtual root), instance row i, BLAS row i and
// triangle row i, where each exists. Integers go in as their int32 bits;
// the float -> int conversions truncate, as torch's .to(torch.int32) does.
__global__ void __launch_bounds__(kThreads)
pack_shadow_rows_kernel(const float* __restrict__ table, int n_tlas,
                        int n_blas, const float* __restrict__ inst,
                        int n_inst, const float* __restrict__ tri_pos,
                        int n_tri, float* __restrict__ top,
                        float* __restrict__ blas, float* __restrict__ tris) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i < n_tlas) {
    const float* t = table + 16 * (size_t)i;
    const float a = t[3];
    int right = -1;
    if (a >= 0.0f) {  // internal: the second child is the first's exit
      const int left = min(max((int)a, 0), n_tlas - 1);
      right = (int)__fsub_rn(table[16 * (size_t)left + 7], 1.0f);
    }
    float* o = top + 8 * (size_t)i;
    o[0] = t[0];
    o[1] = t[1];
    o[2] = t[2];
    o[3] = __int_as_float((int)a);
    o[4] = t[4];
    o[5] = t[5];
    o[6] = t[6];
    o[7] = __int_as_float(right);
  } else if (i == n_tlas) {
    float* o = top + 8 * (size_t)i;
    for (int k = 0; k < 7; ++k) o[k] = 0.0f;
    o[7] = __int_as_float(kNoChild);
  }
  if (i < n_inst) {
    const float* s = inst + 24 * (size_t)i;
    float* o = top + 8 * (size_t)(n_tlas + 1) + 16 * (size_t)i;
    for (int k = 0; k < 12; ++k) o[k] = s[k];
    o[12] = __int_as_float((int)s[16]);
    o[13] = __int_as_float((int)s[17]);
    o[14] = 0.0f;
    o[15] = 0.0f;
  }
  if (i < n_blas) {
    const float* b = table + 16 * (size_t)(n_tlas + i);
    float* o = blas + 8 * (size_t)i;
    o[0] = b[0];
    o[1] = b[1];
    o[2] = b[2];
    o[3] = __int_as_float((int)b[3]);
    o[4] = b[4];
    o[5] = b[5];
    o[6] = b[6];
    o[7] = __int_as_float((int)b[8]);
  }
  if (i < n_tri) {
    const float* v = tri_pos + 9 * (size_t)i;
    float* o = tris + 12 * (size_t)i;
    o[0] = v[0];
    o[1] = v[1];
    o[2] = v[2];
    for (int k = 0; k < 3; ++k) {
      o[3 + k] = __fsub_rn(v[3 + k], v[k]);
      o[6 + k] = __fsub_rn(v[6 + k], v[k]);
    }
    o[9] = o[10] = o[11] = 0.0f;
  }
}

}  // namespace

// The kernel's tables from the threaded ones: `top` holds (n_tlas + 1) * 8
// + n_inst * 16 floats, `blas` n_blas * 8, `tris` n_tri * 12.
extern "C" int voidin_pack_shadow_rows(const void* table, int n_tlas,
                                       int n_blas, const void* inst,
                                       int n_inst, const void* tri_pos,
                                       int n_tri, void* top, void* blas,
                                       void* tris, void* stream) {
  int n = n_tlas + 1;
  n = n_inst > n ? n_inst : n;
  n = n_blas > n ? n_blas : n;
  n = n_tri > n ? n_tri : n;
  pack_shadow_rows_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                            (cudaStream_t)stream>>>(
      (const float*)table, n_tlas, n_blas, (const float*)inst, n_inst,
      (const float*)tri_pos, n_tri, (float*)top, (float*)blas, (float*)tris);
  return (int)cudaGetLastError();
}

// R > 0 rays (R < 2^31 - 64) and at least one instance: the wrapper
// launches nothing otherwise. `active` may be null (every ray active);
// hit_out and counters[0..1] (exhausted rays, dropped pushes) are zeroed
// by the caller.
extern "C" int voidin_shadow_trace(const void* top, int n_tlas, int n_inst,
                                   const void* blas, const void* tris,
                                   const void* origins, const void* dirs,
                                   const void* active, int n_rays,
                                   float t_max, int max_steps, void* hit_out,
                                   void* counters, void* stream) {
  bool top_shared = false;
  const int smem = shared_bytes(n_tlas, n_inst, &top_shared);
  cudaError_t e = cudaFuncSetAttribute(
      shadow_trace_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kTopShared);
  if (e != cudaSuccess) return (int)e;
  const long long blocks = ((long long)n_rays + kThreads - 1) / kThreads;
  shadow_trace_kernel<<<(unsigned)blocks, kThreads, smem,
                        (cudaStream_t)stream>>>(
      (const float4*)top, n_tlas, n_inst, top_shared ? 1 : 0,
      (const float4*)blas, (const float4*)tris, (const float*)origins,
      (const float*)dirs, (const uint8_t*)active, n_rays, t_max, max_steps,
      (uint8_t*)hit_out, (int*)counters);
  return (int)cudaGetLastError();
}

// The kernel's registers a thread, local memory a thread and resident
// blocks an SM at a scene's shared memory (cudaFuncGetAttributes,
// cudaOccupancyMaxActiveBlocksPerMultiprocessor): out[0..4] = registers,
// local bytes, blocks an SM, threads a block, shared bytes a block.
extern "C" int voidin_shadow_trace_attrs(int n_tlas, int n_inst, int* out) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, shadow_trace_kernel);
  if (e != cudaSuccess) return (int)e;
  bool top_shared = false;
  const int smem = shared_bytes(n_tlas, n_inst, &top_shared);
  e = cudaFuncSetAttribute(shadow_trace_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           kTopShared);
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, shadow_trace_kernel, kThreads, smem);
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = blocks;
  out[3] = kThreads;
  out[4] = smem;
  return (int)e;
}
