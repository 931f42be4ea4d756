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
//
// The track2 variant (fine_raster_pairs_kernel<true>, C entry
// voidin_fine_raster_pairs_track2) replaces the TPU kernel's track2 path,
// voidin_tpu/ops/fine_raster.py:214-276: besides the winner it keeps the
// runner-up (depth2, id2) among DISTINCT depths, which the alpha-masked
// resolve falls back to where the winner's texel is cut. The TPU kernel
// gets the within-chunk second place from a second full masked max over
// the (128 records x 128 pixels) candidate block; here each thread streams
// its pixel's records once, keeping two (depth, id) pairs in registers, so
// the variant adds a few compares per record-pixel test and 8 B of output
// per pixel, and nothing to shared memory or the record traffic. Its bound
// is the base kernel's: FP32 issue rate of the plane evaluations and the
// serial chunk loop.

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

// Per thread, a chunk is one pass over its records keeping (m1, i1) =
// the largest candidate and the highest id at it and, for kTrack2,
// (m2, i2) = the largest candidate strictly below m1 and the highest id at
// it. That is the TPU kernel's masked max (every record at the chunk's max
// masked out, then max again): a new maximum demotes (m1, i1) to (m2, i2),
// a tie of m1 only raises i1, anything below m1 competes for m2. Only
// candidates > 0 can change the outputs (the running best and runner-up
// start at depth 0 and move only on a strict >), so the -1 of non-inside
// records and negative depths need no separate handling. The chunk result
// is then merged as the TPU kernel merges it (fine_raster.py:253-276).
template <bool kTrack2>
__global__ void __launch_bounds__(kTilePx)
fine_raster_pairs_kernel(const float* __restrict__ rec,
                         const int* __restrict__ starts,
                         const int* __restrict__ counts,
                         float* __restrict__ depth_out,
                         float* __restrict__ id_out,
                         float* __restrict__ depth2_out,
                         float* __restrict__ id2_out,
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
  float bd2 = 0.0f;
  float bi2 = -1.0f;
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
      float m1 = -1.0f, i1 = -1.0f, m2 = -1.0f, i2 = -1.0f;
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
        if (cand > m1) {
          if (kTrack2) {
            m2 = m1;
            i2 = i1;
          }
          m1 = cand;
          i1 = id;
        } else if (cand == m1) {
          i1 = fmaxf(i1, id);
        } else if (kTrack2) {
          if (cand > m2) {
            m2 = cand;
            i2 = id;
          } else if (cand == m2) {
            i2 = fmaxf(i2, id);
          }
        }
      }
      // A NaN poisons the chunk's max (jnp.max): it changes neither the
      // best nor the runner-up.
      if (poisoned) continue;
      const bool take = m1 > bd;
      if (kTrack2) {
        const float g2id = m2 > 0.0f ? i2 : -1.0f;
        // demoted best; a bit-equal tie of the running best collapses
        const float lv = take ? bd : (m1 == bd ? -1.0f : m1);
        const float li = take ? bi : i1;
        float m2v = bd2, m2i = bi2;
        if (m2 > bd2) {
          m2v = m2;
          m2i = g2id;
        }
        if (lv > m2v) {
          bd2 = lv;
          bi2 = li;
        } else {
          bd2 = m2v;
          bi2 = m2i;
        }
      }
      if (take) {
        bd = m1;
        bi = i1;
      }
    }
  }
  const size_t o = (size_t)tile * kTilePx + lane;
  depth_out[o] = bd;
  id_out[o] = bi;
  if (kTrack2) {
    depth2_out[o] = bd2;
    id2_out[o] = bi2;
  }
}

}  // namespace

extern "C" int voidin_fine_raster_pairs(const void* rec, const void* starts,
                                        const void* counts, void* depth,
                                        void* id, int nt, int n_chunks_total,
                                        void* stream) {
  if (nt > 0) {
    fine_raster_pairs_kernel<false><<<nt, kTilePx, 0, (cudaStream_t)stream>>>(
        (const float*)rec, (const int*)starts, (const int*)counts,
        (float*)depth, (float*)id, nullptr, nullptr, n_chunks_total);
  }
  return (int)cudaGetLastError();
}

extern "C" int voidin_fine_raster_pairs_track2(
    const void* rec, const void* starts, const void* counts, void* depth,
    void* id, void* depth2, void* id2, int nt, int n_chunks_total,
    void* stream) {
  if (nt > 0) {
    fine_raster_pairs_kernel<true><<<nt, kTilePx, 0, (cudaStream_t)stream>>>(
        (const float*)rec, (const int*)starts, (const int*)counts,
        (float*)depth, (float*)id, (float*)depth2, (float*)id2,
        n_chunks_total);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* voidin_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
