// Fine raster: per-tile reverse-Z depth/id competition (kernels K1 and K2
// of the port).
//
// K1, fine_raster_pairs_kernel, replaces voidin_tpu/ops/fine_raster.py
// _kernel_pairs / fine_raster_pairs, the Pallas TPU kernel that evaluated
// 128-record chunks of tile-sorted pair records against a tile's 128
// pixels as MXU dot products. K2, fine_raster_blocks_kernel, replaces
// _kernel / fine_raster_pallas, its block variant over per-tile blocks
// capped at K records, and voidin_tpu/passes/raster.py fine_raster_xla,
// the XLA twin the JAX package runs for that path.
//
// What they compute. For each 8x16 tile, a list of records (16 f32 each:
// three edge planes and a depth plane as (ax, ay, b) baked to the tile
// origin, the id at 12, zmax at 15). For each pixel centre
// (lane % 16 + 0.5, lane / 16 + 0.5) a record is a candidate when e0, e1,
// e2 >= 0; its depth is min(plane, zmax). The largest depth wins
// (reverse-Z), init depth 0 and id -1.
//
// Ties decide real pixels (a quad's two triangles meet at bit-equal depth
// on the diagonal), so the grouping is the TPU kernels': within a group
// the highest id among the maximal depths wins; across groups an equal
// depth keeps the earlier group's winner (strict >). A NaN candidate
// poisons its group's maximum, as jnp.max does, so that group takes no
// pixel. K1's groups are chunks of 128 records aligned to GLOBAL 128-slot
// boundaries (chunk0 = start / 128), records of a boundary chunk outside
// the tile's range masked; K2's are groups of 8 aligned to the block's
// start, slots at or past min(count, K) masked, and records with a
// negative id never compete (empty slots carry record 0's coefficients
// with id -1). The library is built with -fmad=false: every plane is
// evaluated as ((ax * px) + (ay * py)) + b with separately rounded
// operations, the order the PyTorch twins use, so kernels and twins agree
// bit for bit.
//
// What bounds them on an H100. Per pixel and record: 4 plane evaluations
// (12 FLOP) and a few compares; memory traffic is 64 B per record plus 8 B
// of output per pixel, small beside L2 bandwidth. The bound is FP32
// instruction throughput and the serial per-thread record loop. Design:
// one 128-thread CTA per tile, one thread per pixel; records are staged in
// shared memory with coalesced 16-byte copies, then every thread reads
// them as shared-memory broadcasts. K1 stages, of each chunk its range
// touches, only the tile's own records [r0, r1) (13 of 128 on an average
// 1080p north-star tile: staging whole chunks copied ~10x the record bytes
// the tile uses, through L2), with cp.async into two buffers, so a tile
// that spans several chunks (the fullest 1080p tile: 650 records, 6
// chunks) copies the next slice while it tests the current one. K2 loops
// only to min(count, K), in 128-record slices aligned to the block start
// (a whole K = 1024 block, 64 KB, would exceed the 48 KB static limit),
// so every 8-group falls inside one slice; its slices are copied
// synchronously.
//
// The track2 variants (kTrack2) replace the TPU kernel's track2 path,
// voidin_tpu/ops/fine_raster.py:214-276, and fine_raster_xla(track2=True)
// (raster.py:999-1013) for K2: besides the winner they keep the runner-up
// (depth2, id2) among DISTINCT depths, which the alpha-masked resolve
// falls back to where the winner's texel is cut. The TPU kernel gets the
// group's second place from a second full masked max over the candidate
// block; here each thread streams its pixel's records once, keeping two
// (depth, id) pairs in registers: a few compares per record-pixel test
// and 8 B of output per pixel, nothing more in shared memory or records.
//
// K1's payload variant (kPayload) replaces the TPU kernel's winner-payload
// contraction (fine_raster.py:123-133, :222-238, :293-302,
// RasterConfig.kernel_payload): it writes the winning record's row of a
// pair-ordered payload stream (the slim resolve record, 24 words) per
// pixel, so resolve skips its per-pixel record gather. The TPU kernel
// selected the row with an MXU dot against a one-hot matrix, which is why
// its payload had to avoid NaN bit patterns; here each thread keeps the
// SLOT of its winning record (updated where the id is: a larger depth, or
// an equal depth with a larger id; carried across chunks on take) and at
// the end copies that row's raw 32-bit words, one column per pass so that
// the 128 lanes' stores coalesce; pixels with no winner write zeros. The
// copy bounds the variant: at 1080p its output is 2,073,600 px x 96 B =
// 199 MB, more than the records it reads, and each column's loads gather
// one word from each lane's row.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kChunk = 128;   // records per K1 chunk and per staged slice
constexpr int kGroup = 8;     // records per K2 group
constexpr int kRecF = 16;     // f32 per record
constexpr int kTileW = 16;
constexpr int kTilePx = 128;  // 8 x 16 pixels
constexpr int kFId = 12;
constexpr int kFZmax = 15;

__device__ __forceinline__ float plane(const float* r, float px, float py) {
  return __fadd_rn(__fadd_rn(__fmul_rn(r[0], px), __fmul_rn(r[1], py)), r[2]);
}

// One group's running state per thread: (m1, i1) = the largest candidate
// and the highest id at it, s1 = the slot of that record (kSlot) and, for
// kTrack2, (m2, i2) = the largest candidate strictly below m1 and the
// highest id at it. That is the TPU kernels' masked max (every record at
// the group's max masked out, then max again): a new maximum demotes
// (m1, i1) to (m2, i2), a tie of m1 only raises i1, anything below m1
// competes for m2. Only candidates > 0 can change the outputs (the running
// best and runner-up start at depth 0 and move only on a strict >), so the
// -1 of non-inside records and negative depths need no separate handling.
struct Group {
  float m1 = -1.0f, i1 = -1.0f, m2 = -1.0f, i2 = -1.0f;
  int s1 = -1;
  bool poisoned = false;
};

template <bool kTrack2, bool kSlot, bool kTestId>
__device__ __forceinline__ void group_add(Group& g, const float* q, float px,
                                          float py, int slot) {
  const float e0 = plane(q + 0, px, py);
  const float e1 = plane(q + 3, px, py);
  const float e2 = plane(q + 6, px, py);
  const float id = q[kFId];
  if (!(e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f)) return;
  if (kTestId && !(id >= 0.0f)) return;
  const float d = plane(q + 9, px, py);
  const float zmax = q[kFZmax];
  if (isnan(d) || isnan(zmax)) {
    g.poisoned = true;
    return;
  }
  const float cand = d < zmax ? d : zmax;
  if (cand > g.m1) {
    if (kTrack2) {
      g.m2 = g.m1;
      g.i2 = g.i1;
    }
    g.m1 = cand;
    g.i1 = id;
    if (kSlot) g.s1 = slot;
  } else if (cand == g.m1) {
    if (kSlot) {
      if (id > g.i1) {
        g.i1 = id;
        g.s1 = slot;
      }
    } else {
      g.i1 = fmaxf(g.i1, id);
    }
  } else if (kTrack2) {
    if (cand > g.m2) {
      g.m2 = cand;
      g.i2 = id;
    } else if (cand == g.m2) {
      g.i2 = fmaxf(g.i2, id);
    }
  }
}

// The group result merged as the TPU kernel merges it
// (fine_raster.py:253-276). A poisoned group (NaN) changes neither the
// best nor the runner-up. Returns whether the group took the pixel.
template <bool kTrack2>
__device__ __forceinline__ bool group_merge(const Group& g, float& bd,
                                            float& bi, float& bd2,
                                            float& bi2) {
  if (g.poisoned) return false;
  const bool take = g.m1 > bd;
  if (kTrack2) {
    const float g2id = g.m2 > 0.0f ? g.i2 : -1.0f;
    // demoted best; a bit-equal tie of the running best collapses
    const float lv = take ? bd : (g.m1 == bd ? -1.0f : g.m1);
    const float li = take ? bi : g.i1;
    float m2v = bd2, m2i = bi2;
    if (g.m2 > bd2) {
      m2v = g.m2;
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
    bd = g.m1;
    bi = g.i1;
  }
  return take;
}

// Copies n records (n * 16 f32, 16-byte aligned) into shared memory.
__device__ __forceinline__ void stage(float* srec, const float* src, int n,
                                      int lane) {
  const float4* s = reinterpret_cast<const float4*>(src);
  float4* d = reinterpret_cast<float4*>(srec);
  for (int k = lane; k < n * kRecF / 4; k += kTilePx) d[k] = s[k];
}

// The same copy as cp.async (global -> shared, 16 bytes a piece,
// bypassing L1); it lands by the matching cp_async_wait.
__device__ __forceinline__ void stage_async(float* srec, const float* src,
                                            int n, int lane) {
  const float4* s = reinterpret_cast<const float4*>(src);
  float4* d = reinterpret_cast<float4*>(srec);
  for (int k = lane; k < n * kRecF / 4; k += kTilePx) {
    const unsigned dst = (unsigned)__cvta_generic_to_shared(d + k);
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(s + k)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most one committed group of this thread is in flight.
__device__ __forceinline__ void cp_async_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Records [r0, r1) of chunk c of a tile whose range starts `offset` slots
// into its first chunk and spans `span` slots from that chunk's start.
__device__ __forceinline__ void slice_of(int c, int offset, int span, int& r0,
                                         int& r1) {
  const int lo = offset - c * kChunk;
  const int hi = span - c * kChunk;
  r0 = lo > 0 ? lo : 0;
  r1 = hi < kChunk ? hi : kChunk;
}

template <bool kTrack2>
__device__ __forceinline__ void write_out(int tile, int lane, float bd,
                                          float bi, float bd2, float bi2,
                                          float* depth_out, float* id_out,
                                          float* depth2_out, float* id2_out) {
  const size_t o = (size_t)tile * kTilePx + lane;
  depth_out[o] = bd;
  id_out[o] = bi;
  if (kTrack2) {
    depth2_out[o] = bd2;
    id2_out[o] = bi2;
  }
}

template <bool kTrack2, bool kPayload>
__global__ void __launch_bounds__(kTilePx)
fine_raster_pairs_kernel(const float* __restrict__ rec,
                         const int* __restrict__ starts,
                         const int* __restrict__ counts,
                         const unsigned* __restrict__ payload, int pay_f,
                         float* __restrict__ depth_out,
                         float* __restrict__ id_out,
                         float* __restrict__ depth2_out,
                         float* __restrict__ id2_out,
                         unsigned* __restrict__ pay_out,
                         int n_chunks_total) {
  __shared__ __align__(16) float srec[2][kChunk * kRecF];  // double buffer
  const int tile = blockIdx.x;
  const int lane = threadIdx.x;
  const int start = starts[tile];
  const int count = counts[tile];
  const float px = (float)(lane % kTileW) + 0.5f;
  const float py = (float)(lane / kTileW) + 0.5f;
  float bd = 0.0f, bi = -1.0f, bd2 = 0.0f, bi2 = -1.0f;
  int bslot = -1;  // the winning record's global slot (kPayload)
  if (count > 0) {
    const int chunk0 = start / kChunk;
    const int offset = start - chunk0 * kChunk;
    const int span = offset + count;
    int n_chunks = (span + kChunk - 1) / kChunk;
    if (chunk0 + n_chunks > n_chunks_total) n_chunks = n_chunks_total - chunk0;
    int r0, r1;  // the slice of chunk c, staged in srec[c & 1]
    slice_of(0, offset, span, r0, r1);
    if (n_chunks > 0) {
      stage_async(srec[0], rec + ((size_t)chunk0 * kChunk + r0) * kRecF,
                  r1 - r0, lane);
    }
    cp_async_commit();
    for (int c = 0; c < n_chunks; ++c) {
      int n0 = 0, n1 = 0;  // the next chunk's slice, copied meanwhile
      if (c + 1 < n_chunks) {
        slice_of(c + 1, offset, span, n0, n1);
        stage_async(srec[(c + 1) & 1],
                    rec + ((size_t)(chunk0 + c + 1) * kChunk + n0) * kRecF,
                    n1 - n0, lane);
      }
      cp_async_commit();
      cp_async_wait_all_but_one();  // slice c has landed
      __syncthreads();
      const float* buf = srec[c & 1];
      Group g;
      for (int r = r0; r < r1; ++r) {
        group_add<kTrack2, kPayload, false>(g, buf + (r - r0) * kRecF, px,
                                            py, r);
      }
      if (group_merge<kTrack2>(g, bd, bi, bd2, bi2) && kPayload) {
        bslot = (chunk0 + c) * kChunk + g.s1;
      }
      __syncthreads();  // slice c consumed before c + 2 refills its buffer
      r0 = n0;
      r1 = n1;
    }
  }
  write_out<kTrack2>(tile, lane, bd, bi, bd2, bi2, depth_out, id_out,
                     depth2_out, id2_out);
  if (kPayload) {
    const unsigned* row = payload + (size_t)(bslot < 0 ? 0 : bslot) * pay_f;
    unsigned* dst = pay_out + (size_t)tile * pay_f * kTilePx + lane;
    for (int k = 0; k < pay_f; ++k) {
      dst[(size_t)k * kTilePx] = bslot >= 0 ? row[k] : 0u;
    }
  }
}

template <bool kTrack2>
__global__ void __launch_bounds__(kTilePx)
fine_raster_blocks_kernel(const float* __restrict__ rec,
                          const int* __restrict__ counts,
                          float* __restrict__ depth_out,
                          float* __restrict__ id_out,
                          float* __restrict__ depth2_out,
                          float* __restrict__ id2_out, int k_cap) {
  __shared__ __align__(16) float srec[kChunk * kRecF];
  const int tile = blockIdx.x;
  const int lane = threadIdx.x;
  int count = counts[tile];
  count = count < k_cap ? count : k_cap;
  const float px = (float)(lane % kTileW) + 0.5f;
  const float py = (float)(lane / kTileW) + 0.5f;
  float bd = 0.0f, bi = -1.0f, bd2 = 0.0f, bi2 = -1.0f;
  const float* block = rec + (size_t)tile * k_cap * kRecF;
  for (int s0 = 0; s0 < count; s0 += kChunk) {
    const int n = count - s0 < kChunk ? count - s0 : kChunk;
    __syncthreads();  // previous slice fully consumed
    stage(srec, block + (size_t)s0 * kRecF, n, lane);
    __syncthreads();
    for (int g0 = 0; g0 < n; g0 += kGroup) {
      const int g1 = g0 + kGroup < n ? g0 + kGroup : n;
      Group g;
      for (int r = g0; r < g1; ++r) {
        group_add<kTrack2, false, true>(g, srec + r * kRecF, px, py, r);
      }
      group_merge<kTrack2>(g, bd, bi, bd2, bi2);
    }
  }
  write_out<kTrack2>(tile, lane, bd, bi, bd2, bi2, depth_out, id_out,
                     depth2_out, id2_out);
}

template <bool kTrack2, bool kPayload>
int launch_pairs(const void* rec, const void* starts, const void* counts,
                 const void* payload, int pay_f, void* depth, void* id,
                 void* depth2, void* id2, void* pay_out, int nt,
                 int n_chunks_total, void* stream) {
  if (nt > 0) {
    fine_raster_pairs_kernel<kTrack2, kPayload>
        <<<nt, kTilePx, 0, (cudaStream_t)stream>>>(
            (const float*)rec, (const int*)starts, (const int*)counts,
            (const unsigned*)payload, pay_f, (float*)depth, (float*)id,
            (float*)depth2, (float*)id2, (unsigned*)pay_out, n_chunks_total);
  }
  return (int)cudaGetLastError();
}

template <bool kTrack2>
int launch_blocks(const void* rec, const void* counts, void* depth, void* id,
                  void* depth2, void* id2, int nt, int k_cap, void* stream) {
  if (nt > 0) {
    fine_raster_blocks_kernel<kTrack2>
        <<<nt, kTilePx, 0, (cudaStream_t)stream>>>(
            (const float*)rec, (const int*)counts, (float*)depth, (float*)id,
            (float*)depth2, (float*)id2, k_cap);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int voidin_fine_raster_pairs(const void* rec, const void* starts,
                                        const void* counts, void* depth,
                                        void* id, int nt, int n_chunks_total,
                                        void* stream) {
  return launch_pairs<false, false>(rec, starts, counts, nullptr, 0, depth,
                                    id, nullptr, nullptr, nullptr, nt,
                                    n_chunks_total, stream);
}

extern "C" int voidin_fine_raster_pairs_track2(
    const void* rec, const void* starts, const void* counts, void* depth,
    void* id, void* depth2, void* id2, int nt, int n_chunks_total,
    void* stream) {
  return launch_pairs<true, false>(rec, starts, counts, nullptr, 0, depth,
                                   id, depth2, id2, nullptr, nt,
                                   n_chunks_total, stream);
}

extern "C" int voidin_fine_raster_pairs_payload(
    const void* rec, const void* starts, const void* counts,
    const void* payload, int pay_f, void* depth, void* id, void* pay_out,
    int nt, int n_chunks_total, void* stream) {
  return launch_pairs<false, true>(rec, starts, counts, payload, pay_f,
                                   depth, id, nullptr, nullptr, pay_out, nt,
                                   n_chunks_total, stream);
}

extern "C" int voidin_fine_raster_pairs_payload_track2(
    const void* rec, const void* starts, const void* counts,
    const void* payload, int pay_f, void* depth, void* id, void* depth2,
    void* id2, void* pay_out, int nt, int n_chunks_total, void* stream) {
  return launch_pairs<true, true>(rec, starts, counts, payload, pay_f, depth,
                                  id, depth2, id2, pay_out, nt,
                                  n_chunks_total, stream);
}

extern "C" int voidin_fine_raster_blocks(const void* rec, const void* counts,
                                         void* depth, void* id, int nt,
                                         int k_cap, void* stream) {
  return launch_blocks<false>(rec, counts, depth, id, nullptr, nullptr, nt,
                              k_cap, stream);
}

extern "C" int voidin_fine_raster_blocks_track2(const void* rec,
                                                const void* counts,
                                                void* depth, void* id,
                                                void* depth2, void* id2,
                                                int nt, int k_cap,
                                                void* stream) {
  return launch_blocks<true>(rec, counts, depth, id, depth2, id2, nt, k_cap,
                             stream);
}

extern "C" const char* voidin_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
