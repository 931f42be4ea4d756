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
// visit, ~30 an instance entry, ~40 a triangle test) are a few hundred
// million, a few us. The walk is neither. Measured on the card before
// this design (PERF.md §6, the 1080p scenes): the 1,024 longest walks
// alone took under half of the time (0.23-0.26 of 0.51-0.55 ms); the
// rest was the bulk of warps, each as long as its longest lane and
// running the union of its lanes' branches. So the design cuts what a
// warp executes and keeps each ray's walk as it was: the slab's
// NaN-propagating min / max as one instruction each (max.NaN / min.NaN);
// one slab test for TLAS and BLAS pops alike; the instance and triangle
// tests, the long branches, run once the warp's lanes each hold a leaf
// (a lane that pops a leaf waits for the others); and where the caller
// gives the rays' row width (an image's rays in screen order, as
// examples/bvh_trace.py makes them), a warp walks an 8x4 tile of pixels
// and a block a 16x8 one, whose rays share more of their path than 32
// pixels of one row do. The longest walks are now most of the time.
// Tried on the card and slower (PERF.md §6): boxes tested at their
// parent's pop with the entry distance on the stack, so that a pop that
// misses fetches nothing (a hit pop's work doubles while the warp waits
// on its longest lane all the same); the TLAS and instance rows in shared
// memory; the stack's top in registers; 64-thread blocks; register caps.

#include <cuda_runtime.h>
#include <stdint.h>

#include "ray_math.cuh"

namespace {

constexpr int kThreads = 128;  // a 16x8 tile of pixels with a row width
constexpr int kStack = 48;     // rt/traverse.py STACK
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

// The ray of this thread, -1 for none: rays in rows of `width` (screen
// order) give each block a 16x8 tile and each warp an 8x4 one; width 0,
// consecutive rays.
__device__ __forceinline__ long long thread_ray(long long n_rays,
                                                int width) {
  long long r;
  if (width > 0) {
    const int tiles_x = (width + 15) / 16;
    const int lane = threadIdx.x;
    const int x = (int)(blockIdx.x % tiles_x) * 16 + ((lane >> 5) & 1) * 8 +
                  (lane & 7);
    const long long y = (long long)(blockIdx.x / tiles_x) * 8 +
                        ((lane >> 6) & 1) * 4 + ((lane >> 3) & 3);
    if (x >= width) return -1;
    r = y * width + x;
  } else {
    r = (long long)blockIdx.x * kThreads + threadIdx.x;
  }
  return r < n_rays ? r : -1;
}

__global__ void __launch_bounds__(kThreads)
closest_hit_kernel(const float* __restrict__ tlas,
                   const float* __restrict__ blas,
                   const float* __restrict__ inst,
                   const float* __restrict__ tri_pos,
                   const float* __restrict__ origins,
                   const float* __restrict__ dirs,
                   const uint8_t* __restrict__ active, long long n_rays,
                   int width, int max_steps, float* __restrict__ t_out,
                   int* __restrict__ visits_out, int* __restrict__ overflow,
                   int* __restrict__ exhausted) {
  const long long r = thread_ray(n_rays, width);
  if (r < 0) return;
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
  for (;;) {
    // pops until one hits a leaf; then the warp's lanes that hold one test
    // it together, each in its own walk's order
    int leaf = 0, ia = 0, ib = 0;
    while (sp > 0 && visits < max_steps) {
      const int entry = stack[--sp];
      ++visits;
      const bool world = entry > 0;
      const float4* row = reinterpret_cast<const float4*>(
          world ? tlas + (size_t)(entry - 1) * kRowFloats
                : blas + (size_t)(-entry - 1) * kRowFloats);
      const float4 r0 = __ldg(row);
      const float4 r1 = __ldg(row + 1);
      float lo;
      if (!slab_lo(world ? o : co, world ? inv0 : cinv, {r0.x, r0.y, r0.z},
                   {r1.x, r1.y, r1.z}, t, &lo)) {
        continue;
      }
      ia = (int)r0.w;
      ib = (int)r1.w;
      if (world ? !(r0.w < 0.0f) : ib <= 0) {
        // internal: TLAS left + 1, right + 1; BLAS -(base + left + 1),
        // -(base + left + 2)
        const int first = world ? ia + 1 : -(bvh_base + ia + 1);
        push(stack, sp, ovf, first);
        push(stack, sp, ovf, world ? ib + 1 : first - 1);
        continue;
      }
      leaf = entry;
      break;
    }
    if (leaf == 0) break;
    if (leaf > 0) {
      // instance ib: the ray in object space (fastmath.mat4_point_fma /
      // mat3_vec_fma), then its BLAS root
      const float* ir = inst + (size_t)ib * kInstFloats;
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
    // BLAS leaf: its ib triangles from tri_base + ia
    const float* tri = tri_pos + (size_t)(tri_base + ia) * 9;
    for (int k = 0; k < ib; ++k) {
      const float th = tri_t(co, cd, tri + 9 * k);
      if (th > 0.0f && th < t) t = th;
    }
  }
  t_out[r] = t;
  visits_out[r] = visits;
  if (ovf) atomicAdd(overflow, ovf);
  if (sp > 0) atomicAdd(exhausted, 1);
}

long long grid_blocks(long long n_rays, int width) {
  if (width > 0) {
    const long long rows = (n_rays + width - 1) / width;
    return (long long)((width + 15) / 16) * ((rows + 7) / 8);
  }
  return (n_rays + kThreads - 1) / kThreads;
}

}  // namespace

// R > 0 rays and at least one instance: the wrapper launches nothing
// otherwise. `width` > 0: the rays lie in rows of that many (screen
// order), walked in 16x8 tiles; 0: walked in order. `active` may be null
// (every ray active); t_out holds each ray's t_max, visits_out, *overflow
// and *exhausted are zeroed by the caller.
extern "C" int voidin_closest_hit(const void* tlas, const void* blas,
                                  const void* inst, const void* tri_pos,
                                  const void* origins, const void* dirs,
                                  const void* active, long long n_rays,
                                  int width, int max_steps, void* t_out,
                                  void* visits_out, void* overflow,
                                  void* exhausted, void* stream) {
  closest_hit_kernel<<<(unsigned)grid_blocks(n_rays, width), kThreads, 0,
                       (cudaStream_t)stream>>>(
      (const float*)tlas, (const float*)blas, (const float*)inst,
      (const float*)tri_pos, (const float*)origins, (const float*)dirs,
      (const uint8_t*)active, n_rays, width, max_steps, (float*)t_out,
      (int*)visits_out, (int*)overflow, (int*)exhausted);
  return (int)cudaGetLastError();
}

// The kernel's registers a thread, local memory a thread and resident
// blocks an SM (cudaFuncGetAttributes,
// cudaOccupancyMaxActiveBlocksPerMultiprocessor): out[0..4] = registers,
// local bytes, blocks an SM, threads a block, shared bytes a block.
extern "C" int voidin_closest_hit_attrs(int* out) {
  cudaFuncAttributes a;
  cudaError_t e = cudaFuncGetAttributes(&a, closest_hit_kernel);
  if (e != cudaSuccess) return (int)e;
  int blocks = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, closest_hit_kernel, kThreads, 0);
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = blocks;
  out[3] = kThreads;
  out[4] = 0;
  return (int)e;
}
