// Fine raster: per-tile reverse-Z depth/id competition over tile-sorted
// pair records (kernel K1 of the port).
//
// Replaces voidin_tpu/ops/fine_raster.py _kernel_pairs / fine_raster_pairs,
// the Pallas TPU kernel that evaluated 128-record chunks against a tile's
// 128 pixels as MXU dot products.
//
// What it computes. For each 8x16 tile, the records in
// [start, start + count) of the tile-sorted stream (16 f32 each: three
// edge planes and a depth plane as (ax, ay, b) baked to the tile origin,
// the id at 12, zmax at 15). For each pixel centre (lane % 16 + 0.5,
// lane / 16 + 0.5) a record is a candidate when e0, e1, e2 >= 0; its depth
// is min(plane, zmax). The largest depth wins (reverse-Z), init depth 0
// and id -1.
//
// Ties decide real pixels (a quad's two triangles meet at bit-equal depth
// on the diagonal), so the grouping is the TPU kernel's: chunks of 128
// records aligned to GLOBAL 128-slot boundaries (chunk0 = start / 128),
// records of a boundary chunk outside the tile's range masked; within a
// chunk the highest id among the maximal depths wins; across chunks an
// equal depth keeps the earlier chunk's winner (strict >). A NaN candidate
// poisons its chunk's maximum, as jnp.max does, so that chunk takes no
// pixel. The library is built with -fmad=false: every plane is evaluated
// as ((ax * px) + (ay * py)) + b with separately rounded operations, the
// order the PyTorch twin (fine_raster_pairs_reference) uses, so kernel and
// twin agree bit for bit.
//
// What bounds it on an H100. Per pixel and record: 4 plane evaluations
// (12 FLOP) and a few compares, over ~pairs x 128 pixels; memory traffic
// is 64 B per record per tile plus 8 B of output per pixel, small beside
// L2 bandwidth. The bound is FP32 instruction throughput and the serial
// per-thread loop over the chunk. Design: one 128-thread CTA per tile, one
// thread per pixel; each chunk (8 KB) is staged in shared memory with
// coalesced 16-byte loads, then every thread reads the records as
// shared-memory broadcasts. A simple first kernel: no double buffering of
// chunks yet.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kChunk = 128;   // records per chunk
constexpr int kRecF = 16;     // f32 per record
constexpr int kTileW = 16;
constexpr int kTilePx = 128;  // 8 x 16 pixels
constexpr int kFId = 12;
constexpr int kFZmax = 15;

__device__ __forceinline__ float plane(const float* r, float px, float py) {
  return __fadd_rn(__fadd_rn(__fmul_rn(r[0], px), __fmul_rn(r[1], py)), r[2]);
}

__global__ void __launch_bounds__(kTilePx)
fine_raster_pairs_kernel(const float* __restrict__ rec,
                         const int* __restrict__ starts,
                         const int* __restrict__ counts,
                         float* __restrict__ depth_out,
                         float* __restrict__ id_out,
                         int n_chunks_total) {
  __shared__ __align__(16) float srec[kChunk * kRecF];
  const int tile = blockIdx.x;
  const int lane = threadIdx.x;
  const int start = starts[tile];
  const int count = counts[tile];
  const float px = (float)(lane % kTileW) + 0.5f;
  const float py = (float)(lane / kTileW) + 0.5f;
  float bd = 0.0f;
  float bi = -1.0f;
  if (count > 0) {
    const int chunk0 = start / kChunk;
    const int offset = start - chunk0 * kChunk;
    const int span = offset + count;
    int n_chunks = (span + kChunk - 1) / kChunk;
    if (chunk0 + n_chunks > n_chunks_total) n_chunks = n_chunks_total - chunk0;
    for (int c = 0; c < n_chunks; ++c) {
      __syncthreads();  // previous chunk fully consumed
      const float4* src = reinterpret_cast<const float4*>(
          rec + (size_t)(chunk0 + c) * kChunk * kRecF);
      float4* dst = reinterpret_cast<float4*>(srec);
      for (int k = lane; k < kChunk * kRecF / 4; k += kTilePx) dst[k] = src[k];
      __syncthreads();
      const int lo = offset - c * kChunk;
      const int hi = span - c * kChunk;
      const int r0 = lo > 0 ? lo : 0;
      const int r1 = hi < kChunk ? hi : kChunk;
      float gmax = -1.0f;
      float gid = -1.0f;
      bool poisoned = false;
      for (int r = r0; r < r1; ++r) {
        const float* q = srec + r * kRecF;
        const float e0 = plane(q + 0, px, py);
        const float e1 = plane(q + 3, px, py);
        const float e2 = plane(q + 6, px, py);
        if (!(e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f)) continue;
        const float d = plane(q + 9, px, py);
        const float zmax = q[kFZmax];
        if (isnan(d) || isnan(zmax)) { poisoned = true; continue; }
        const float cand = d < zmax ? d : zmax;
        const float id = q[kFId];
        if (cand > gmax) {
          gmax = cand;
          gid = id;
        } else if (cand == gmax) {
          gid = fmaxf(gid, id);
        }
      }
      if (!poisoned && gmax > bd) {
        bd = gmax;
        bi = gid;
      }
    }
  }
  depth_out[(size_t)tile * kTilePx + lane] = bd;
  id_out[(size_t)tile * kTilePx + lane] = bi;
}

}  // namespace

extern "C" int voidin_fine_raster_pairs(const void* rec, const void* starts,
                                        const void* counts, void* depth,
                                        void* id, int nt, int n_chunks_total,
                                        void* stream) {
  if (nt > 0) {
    fine_raster_pairs_kernel<<<nt, kTilePx, 0, (cudaStream_t)stream>>>(
        (const float*)rec, (const int*)starts, (const int*)counts,
        (float*)depth, (float*)id, n_chunks_total);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* voidin_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
