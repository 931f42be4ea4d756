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
// What bounds K1 on an H100. Per pixel and record: 4 plane evaluations
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
// chunks) copies the next slice while it tests the current one.
//
// What bounds K2 on an H100, and its design. A 1080p frame's records are
// unevenly spread: of 16,200 tiles a third are empty, half hold 1-8
// records, and 430 tiles at the horizon hold 59% of the records, up to 650
// each, most of them triangles of a few pixels (half of all records cover
// no pixel centre at all). One thread per pixel walking every record of
// its tile is then bound twice over: by shared memory (4 warps x four
// 16-byte broadcasts per record occupy the SM's load unit for 64 cycles a
// record) and by the fullest tile, whose block is one dependent chain of
// 650 load-test-branch steps that alone lasts three quarters of the whole
// launch. So K2:
//   - launches only as many blocks as the card holds at once; block b
//     walks tiles b, b + gridDim.x, ... A lane of each warp holds the
//     count of each of the block's next 32 tiles, so no tile waits for
//     its count;
//   - moves records in rounds of 32 (four groups of 8, 2 KB) with
//     cp.async, three rounds ahead of the one being tested and across
//     tile boundaries, into a ring of four stages; one barrier a round.
//     Staged records are 80 bytes apart, so that lanes reading the same
//     word of consecutive records fall on distinct banks;
//   - gives each warp an 8 x 4 pixel region of the tile, one pixel a lane,
//     and tests a round in three steps. Lane l first tests record l
//     against the whole region (each edge plane at the region's corner
//     where it is largest: rounding is monotone, so the test never rejects
//     a record that some pixel would accept); a ballot gives the round's
//     survivors, about one record in four. Then every lane tests the
//     survivors' edges at its own pixel, two records a pass, into a
//     32-bit mask of hits. Last, each lane walks its own hits in slot
//     order: depth plane, the group's max / highest id (and second place),
//     and at each change of group the group's merge into the pixel's
//     running best, as the TPU kernel merges it. A pixel's groups are
//     never split or reordered;
//   - writes a tile's 128 pixels when its last round is done; tiles
//     without records get their outputs from the feed.
// Against the one-thread-per-pixel kernel this took the launch on the
// 1080p north-star blocks from 0.080 to 0.045 ms, and its track2 variant
// on the masked frame's from 0.092 to 0.059 ms (NVIDIA H100 80GB HBM3,
// 700 W). What remains is the fullest tile's chain of 21 rounds, during
// which the other blocks' light tiles compete for issue slots. Which tile
// a block starts with decides when that chain begins: launching 2 to 8
// times the resident blocks moved the time by -17% to +11% with the
// multiple, so the launch stays at the resident count.
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

// A candidate record at one pixel: depth plane value d, clamp zmax, id.
template <bool kTrack2, bool kSlot>
__device__ __forceinline__ void group_update(Group& g, float d, float zmax,
                                             float id, int slot) {
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

template <bool kTrack2, bool kSlot>
__device__ __forceinline__ void group_add(Group& g, const float* q, float px,
                                          float py, int slot) {
  const float e0 = plane(q + 0, px, py);
  const float e1 = plane(q + 3, px, py);
  const float e2 = plane(q + 6, px, py);
  if (!(e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f)) return;
  group_update<kTrack2, kSlot>(g, plane(q + 9, px, py), q[kFZmax], q[kFId],
                               slot);
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

// One 16-byte cp.async (global -> shared, bypassing L1); it lands by the
// matching cp_async_wait.
__device__ __forceinline__ void cp_async_16(float4* dst, const float4* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

// Copies n records (n * 16 f32, 16-byte aligned) into shared memory with
// cp.async, one piece per thread and pass.
__device__ __forceinline__ void stage_async(float* srec, const float* src,
                                            int n, int lane) {
  const float4* s = reinterpret_cast<const float4*>(src);
  float4* d = reinterpret_cast<float4*>(srec);
  for (int k = lane; k < n * kRecF / 4; k += kTilePx) cp_async_16(d + k, s + k);
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most kPending committed groups of this thread are in
// flight.
template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
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
      cp_async_wait<1>();  // slice c has landed
      __syncthreads();
      const float* buf = srec[c & 1];
      Group g;
      for (int r = r0; r < r1; ++r) {
        group_add<kTrack2, kPayload>(g, buf + (r - r0) * kRecF, px,
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

// K2's unit of work is a round: kRound consecutive records of one tile's
// block (kRound / 8 groups), one 16-byte cp.async per thread. One warp per
// 8 x 4 pixel region of the tile.
constexpr int kK2Warps = 4;
constexpr int kK2Threads = kK2Warps * 32;
constexpr int kRound = 32;
constexpr int kStages = 4;    // rounds staged in shared memory, a power of 2
// f32 between two staged records: 16 + 4, so that eight lanes reading the
// same 16-byte word of eight consecutive records hit 32 distinct banks.
constexpr int kRecStride = kRecF + 4;
constexpr int kRegionW = 8;   // a warp's pixels: 8 x 4 of the tile's 16 x 8
constexpr int kRegionH = 4;
static_assert(kK2Threads == kTilePx, "one thread per pixel of the tile");
static_assert(kRound == 32, "one lane per record of a round");
static_assert(kRound * kRecF / 4 == kK2Threads, "one piece per thread");
static_assert(kK2Warps * kRegionW * kRegionH == kTilePx, "regions tile it");

// A record's first three 16-byte words: a = ax0 ay0 b0 ax1, b = ay1 b1
// ax2 ay2, c = b2 axd ayd bd. Its three edge planes at (x, y), each
// ((ax * x) + (ay * y)) + b in separately rounded operations as plane().
__device__ __forceinline__ bool edges_inside(const float* q, float x,
                                             float y) {
  const float4* q4 = reinterpret_cast<const float4*>(q);
  const float4 a = q4[0], b = q4[1], c = q4[2];
  const float e0 = __fadd_rn(__fadd_rn(__fmul_rn(a.x, x), __fmul_rn(a.y, y)),
                             a.z);
  const float e1 = __fadd_rn(__fadd_rn(__fmul_rn(a.w, x), __fmul_rn(b.x, y)),
                             b.y);
  const float e2 = __fadd_rn(__fadd_rn(__fmul_rn(b.z, x), __fmul_rn(b.w, y)),
                             c.x);
  return e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f;
}

// Whether the record can pass its three edge tests at any pixel centre of
// the region [xlo, xhi] x [ylo, yhi]: each edge plane at the corner where
// it is largest, in the same separately rounded operations. Rounding is
// monotone, so no pixel of the region exceeds that value; a NaN fails here
// as it fails at every pixel.
__device__ __forceinline__ bool region_may_hit(const float* q, float xlo,
                                               float xhi, float ylo,
                                               float yhi) {
  const float4* q4 = reinterpret_cast<const float4*>(q);
  const float4 a = q4[0], b = q4[1], c = q4[2];
  const float e0 = __fadd_rn(
      __fadd_rn(__fmul_rn(a.x, a.x >= 0.0f ? xhi : xlo),
                __fmul_rn(a.y, a.y >= 0.0f ? yhi : ylo)), a.z);
  const float e1 = __fadd_rn(
      __fadd_rn(__fmul_rn(a.w, a.w >= 0.0f ? xhi : xlo),
                __fmul_rn(b.x, b.x >= 0.0f ? yhi : ylo)), b.y);
  const float e2 = __fadd_rn(
      __fadd_rn(__fmul_rn(b.z, b.z >= 0.0f ? xhi : xlo),
                __fmul_rn(b.w, b.w >= 0.0f ? yhi : ylo)), c.x);
  return e0 >= 0.0f && e1 >= 0.0f && e2 >= 0.0f;
}

template <bool kTrack2>
__global__ void __launch_bounds__(kK2Threads)
fine_raster_blocks_kernel(const float* __restrict__ rec,
                          const int* __restrict__ counts,
                          float* __restrict__ depth_out,
                          float* __restrict__ id_out,
                          float* __restrict__ depth2_out,
                          float* __restrict__ id2_out, int nt, int k_cap) {
  __shared__ __align__(16) float stage[kStages][kRound * kRecStride];
  __shared__ int4 meta[kStages];  // (tile or -1, records, last of its tile)
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  // warp w owns the 8 x 4 region at (8 * (w % 2), 4 * (w / 2))
  const int x0 = kRegionW * (warp % (kTileW / kRegionW));
  const int y0 = kRegionH * (warp / (kTileW / kRegionW));
  const int pixel = (y0 + lane / kRegionW) * kTileW + x0 + lane % kRegionW;
  const float px = (float)(pixel % kTileW) + 0.5f;
  const float py = (float)(pixel / kTileW) + 0.5f;
  const float xlo = (float)x0 + 0.5f, xhi = (float)(x0 + kRegionW) - 0.5f;
  const float ylo = (float)y0 + 0.5f, yhi = (float)(y0 + kRegionH) - 0.5f;

  // The feed, the same in every thread: this block's tiles are blockIdx.x +
  // i * gridDim.x, i = 0, 1, ...; lane l holds the count of tile i0 + l of
  // the current window of 32 and of the next one, so no round waits for
  // its tile's count.
  const long long stride = gridDim.x;
  auto window = [&](int i0) {
    const long long t = blockIdx.x + (i0 + lane) * stride;
    return t < nt ? __ldg(counts + t) : 0;
  };
  int win = window(0), next_win = window(32);
  int f_i = -1;        // index of the tile being fed
  long long f_tile = 0;
  int f_count = 0;     // its records, capped at K
  int f_round = 0;     // its next round
  bool f_open = true;  // tiles left
  // Copies the next round of this block's tiles into stage `s` and commits
  // it; a tile without records gets its outputs here. Past the last tile
  // it commits an empty group with tile -1.
  auto feed = [&](int s) {
    while (f_open && f_round * kRound >= f_count) {
      ++f_i;
      if (f_i > 0 && f_i % 32 == 0) {
        win = next_win;
        next_win = window(f_i + 32);
      }
      f_tile = blockIdx.x + f_i * stride;
      if (f_tile >= nt) {
        f_open = false;
        break;
      }
      const int c = __shfl_sync(0xffffffffu, win, f_i % 32);
      f_count = c < k_cap ? c : k_cap;
      f_round = 0;
      if (f_count <= 0) {
        write_out<kTrack2>((int)f_tile, tid, 0.0f, -1.0f, 0.0f, -1.0f,
                           depth_out, id_out, depth2_out, id2_out);
      }
    }
    if (f_open) {
      const int first = f_round * kRound;
      const int n = f_count - first < kRound ? f_count - first : kRound;
      const float4* src = reinterpret_cast<const float4*>(
          rec + ((size_t)f_tile * k_cap + first) * kRecF);
      float4* dst = reinterpret_cast<float4*>(stage[s]);
      if (tid / 4 < n) {  // piece tid % 4 of record tid / 4
        cp_async_16(dst + tid / 4 * (kRecStride / 4) + tid % 4, src + tid);
      }
      if (tid == 0) {
        meta[s] = make_int4((int)f_tile, n, first + n >= f_count, 0);
      }
      ++f_round;
    } else if (tid == 0) {
      meta[s] = make_int4(-1, 0, 0, 0);
    }
    cp_async_commit();
  };

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) feed(s);
  cp_async_wait<kStages - 2>();  // round 0 has landed
  __syncthreads();
  float bd = 0.0f, bi = -1.0f, bd2 = 0.0f, bi2 = -1.0f;
  for (int k = 0;; ++k) {
    const int4 m = meta[k % kStages];
    if (m.x < 0) break;
    // round k - 1's stage is free since the barrier that ended it
    feed((k + kStages - 1) % kStages);
    const float* srec = stage[k % kStages];
    // Lane l holds record l of the round against the warp's region.
    const float* mine = srec + lane * kRecStride;
    const bool may = lane < m.y && mine[kFId] >= 0.0f &&
                     region_may_hit(mine, xlo, xhi, ylo, yhi);
    unsigned todo = __ballot_sync(0xffffffffu, may);
    // The survivors' edge tests at this lane's pixel, two a pass (the
    // second repeats the first when one is left: the mask takes no harm).
    unsigned hits = 0u;
    while (todo != 0u) {
      const int r0 = __ffs(todo) - 1;
      todo &= todo - 1u;
      const int r1 = todo != 0u ? __ffs(todo) - 1 : r0;
      todo &= todo - 1u;
      const bool in0 = edges_inside(srec + r0 * kRecStride, px, py);
      const bool in1 = edges_inside(srec + r1 * kRecStride, px, py);
      hits |= (in0 ? 1u : 0u) << r0 | (in1 ? 1u : 0u) << r1;
    }
    // This lane's hits in slot order, merged a group of 8 at a time.
    Group g;
    int group = 0;
    while (hits != 0u) {
      const int r = __ffs(hits) - 1;
      hits &= hits - 1u;
      if (r / kGroup != group) {
        group_merge<kTrack2>(g, bd, bi, bd2, bi2);
        g = Group();
        group = r / kGroup;
      }
      const float* q = srec + r * kRecStride;
      group_update<kTrack2, false>(g, plane(q + 9, px, py), q[kFZmax],
                                   q[kFId], 0);
    }
    group_merge<kTrack2>(g, bd, bi, bd2, bi2);
    if (m.z) {
      write_out<kTrack2>(m.x, pixel, bd, bi, bd2, bi2, depth_out, id_out,
                         depth2_out, id2_out);
      bd = 0.0f, bi = -1.0f, bd2 = 0.0f, bi2 = -1.0f;
    }
    cp_async_wait<kStages - 2>();  // round k + 1 has landed
    __syncthreads();  // ... and every warp is done with round k's stage
  }
  cp_async_wait<0>();
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

// Blocks of K2 the current device holds at once (its SMs times the blocks
// of this kernel resident on one), asked once per device.
template <bool kTrack2>
int resident_blocks(cudaError_t& err) {
  static int cached[64] = {};
  int dev = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return 0;
  if (dev < 64 && cached[dev] > 0) return cached[dev];
  int sms = 0, per_sm = 0;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess) {
    return 0;
  }
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, fine_raster_blocks_kernel<kTrack2>, kK2Threads, 0)) !=
      cudaSuccess) {
    return 0;
  }
  const int n = sms * per_sm;
  if (n <= 0) {
    err = cudaErrorLaunchOutOfResources;
    return 0;
  }
  if (dev < 64) cached[dev] = n;
  return n;
}

template <bool kTrack2>
int launch_blocks(const void* rec, const void* counts, void* depth, void* id,
                  void* depth2, void* id2, int nt, int k_cap, void* stream) {
  if (nt > 0) {
    cudaError_t err = cudaSuccess;
    const int resident = resident_blocks<kTrack2>(err);
    if (err != cudaSuccess) return (int)err;
    fine_raster_blocks_kernel<kTrack2>
        <<<nt < resident ? nt : resident, kK2Threads, 0,
           (cudaStream_t)stream>>>(
            (const float*)rec, (const int*)counts, (float*)depth, (float*)id,
            (float*)depth2, (float*)id2, nt, k_cap);
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
