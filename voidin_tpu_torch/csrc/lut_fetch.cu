// LUT fetch: bilinear sampling of C <= 8 tables of 64x64 f32 at a uv per
// pixel (kernel K3 of the port).
//
// Replaces voidin_tpu/ops/lut_fetch.py _kernel / lut_fetch_pallas, the
// Pallas TPU kernel that built one-hot two-tap weight matrices in VMEM and
// contracted them with the tables on the MXU (TPUs have no texture units,
// and per-pixel gathers were the frame's hottest ops there).
//
// What it computes, per pixel and table (uv pre-scaled by the caller):
//   fx = u * 64 - 0.5,  x0 = clamp(floor(fx), 0, 63),  tx = fx - x0,
//   x1 = min(x0 + 1, 63); y likewise;
//   rows first:    r(x) = wy0 * t[y0, x] + wy1 * t[y1, x]
//   then columns:  out  = wx0 * r(x0) + wx1 * r(x1)
// with (wy0, wy1) = (1 - ty, ty); where the clamp makes y1 == y0 the two
// weights add on that one row, (wy0, wy1) = ((1 - ty) + ty, 0), as the
// TPU kernel's one-hot sum does (x the same way). Built with -fmad=false,
// so the arithmetic is separately rounded in the order of the PyTorch twin
// (lut_fetch_reference).
//
// What bounds it on an H100. Per pixel: 8 B of uv in, 4 B per channel out,
// and 4 table loads per channel from C x 16 KB of tables. At 1080p with 5
// channels that is ~58 MB of DRAM traffic — memory bound, ~20 us at the
// card's bandwidth if the table loads hit cache. The tables (80 KB for 5
// channels) are above the 48 KB of static shared memory, so they are read
// through the read-only L1 path (__ldg) instead of being staged: they stay
// resident in each SM's L1/texture cache, and the kernel needs no shared
// memory and no block-wide synchronisation. One thread per pixel, channel
// loop inside, so the four tap addresses are computed once.
//
// The bf16 variant (lut_fetch_kernel<true>, C entry voidin_lut_fetch_bf16)
// replaces the TPU kernel's bf16 path, voidin_tpu/ops/lut_fetch.py:59-61
// (the LTC_LUT_BF16 semantics): the row weights, after the clamp-edge
// merge, and every table entry are rounded to bf16 (round to nearest even,
// __float2bfloat16_rn); the bf16 x bf16 row products are exact in f32 and
// are summed in f32; the column weights stay f32. On the TPU the point was
// halving the weight matrices' bytes; here the weights live in registers
// and the tables stay f32 in memory, so the variant moves the same bytes
// as the f32 kernel and adds six conversions per pixel and channel. Same
// bound, same design.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kT = 64;  // table side

__device__ __forceinline__ void taps(float f, int& i0, int& i1, float& w0,
                                     float& w1) {
  float fl = floorf(f);
  fl = fminf(fmaxf(fl, 0.0f), (float)(kT - 1));
  const float t = __fsub_rn(f, fl);
  i0 = (int)fl;
  i1 = i0 + 1 < kT ? i0 + 1 : kT - 1;
  const float one_minus = __fsub_rn(1.0f, t);
  if (i1 == i0) {
    w0 = __fadd_rn(one_minus, t);
    w1 = 0.0f;
  } else {
    w0 = one_minus;
    w1 = t;
  }
}

__device__ __forceinline__ float round_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <bool kBf16>
__global__ void lut_fetch_kernel(const float* __restrict__ uv,
                                 const float* __restrict__ tables, int n_chan,
                                 long long p, float* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p) return;
  const float u = __ldg(uv + 2 * i);
  const float v = __ldg(uv + 2 * i + 1);
  const float fx = __fsub_rn(__fmul_rn(u, (float)kT), 0.5f);
  const float fy = __fsub_rn(__fmul_rn(v, (float)kT), 0.5f);
  int x0, x1, y0, y1;
  float wx0, wx1, wy0, wy1;
  taps(fx, x0, x1, wx0, wx1);
  taps(fy, y0, y1, wy0, wy1);
  if (kBf16) {
    wy0 = round_bf16(wy0);
    wy1 = round_bf16(wy1);
  }
  for (int c = 0; c < n_chan; ++c) {
    const float* t = tables + (size_t)c * kT * kT;
    float a00 = __ldg(t + y0 * kT + x0);
    float a10 = __ldg(t + y1 * kT + x0);
    float a01 = __ldg(t + y0 * kT + x1);
    float a11 = __ldg(t + y1 * kT + x1);
    if (kBf16) {
      a00 = round_bf16(a00);
      a10 = round_bf16(a10);
      a01 = round_bf16(a01);
      a11 = round_bf16(a11);
    }
    const float r0 = __fadd_rn(__fmul_rn(wy0, a00), __fmul_rn(wy1, a10));
    const float r1 = __fadd_rn(__fmul_rn(wy0, a01), __fmul_rn(wy1, a11));
    out[(size_t)c * p + i] =
        __fadd_rn(__fmul_rn(wx0, r0), __fmul_rn(wx1, r1));
  }
}

template <bool kBf16>
int launch(const void* uv, const void* tables, int n_chan, long long p,
           void* out, void* stream) {
  if (p > 0) {
    const int threads = 256;
    const long long blocks = (p + threads - 1) / threads;
    lut_fetch_kernel<kBf16>
        <<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
            (const float*)uv, (const float*)tables, n_chan, p, (float*)out);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int voidin_lut_fetch(const void* uv, const void* tables,
                                int n_chan, long long p, void* out,
                                void* stream) {
  return launch<false>(uv, tables, n_chan, p, out, stream);
}

extern "C" int voidin_lut_fetch_bf16(const void* uv, const void* tables,
                                     int n_chan, long long p, void* out,
                                     void* stream) {
  return launch<true>(uv, tables, n_chan, p, out, stream);
}
