// Fused LTC rect-light evaluation: the LUT fetch (kernel K3) inside its
// consumer, the whole area-light term of shade, in one launch.
//
// Replaces voidin_tpu/ops/lut_fetch.py _kernel / lut_fetch_pallas (the
// Pallas TPU kernel, bilinear 64x64 table fetch) together with the XLA
// code around its five calls a frame, voidin_tpu/passes/shading.py
// ltc_matrix (:191-218), ltc_evaluate_rect (:277-311) and the
// full-resolution per-light loop of shade (:490-505). On the TPU, XLA fused
// that chain around the kernel; eager PyTorch does not, and the chain ran
// as ~60 elementwise launches per ltc_evaluate_rect call, each reading and
// writing (H, W) or (H, W, 3) f32 fields.
//
// What it computes, per pixel (nor, rd = view, pos, roughness) and light l
// (area_points[l], 4 corners):
//   ltc_matrix: uv = (roughness, sqrt(1 - clamp(nor . view, 0, 1)))
//     * LUT_SCALE + LUT_BIAS; t1 = ltc1[uv].xyzw, t2x = ltc2[uv].x;
//     M = rows (t1.x, 0, t1.z), (0, 1, 0), (t1.y, 0, t1.w).
//   ltc_evaluate_rect(M): basis rows T1 = normalize(view - nor (view.nor)),
//     T2 = nor x T1, nor; minv = M @ basis; L_k = normalize(minv (P_k -
//     pos)); vsum = sum of integrate_edge over the 4 edges; length = |vsum|;
//     z = vsum.z / max(length, 1e-20), negated when pos is behind the
//     light's plane; scale = ltc2[(z/2 + 1/2, length) * LUT_SCALE +
//     LUT_BIAS].w; result length * scale, 0 behind.
//   Outputs diff[l] = ltc_evaluate_rect(identity) and
//   spec[l] = ltc_evaluate_rect(M) * t2x, each (L, H, W) f32: the two terms
//   shade's per-light combine consumes.
// Every step is rounded as the PyTorch twin (ops/ltc_rect.py
// ltc_rect_terms_reference) rounds it: the library is built with
// -fmad=false, the sums keep the twin's order ((a + b) + c), division and
// square root are IEEE (__fdiv_rn, __fsqrt_rn), 0.5 / s is rcp(s) * 0.5 as
// torch's reversed division computes it, clamps let NaN through as
// torch.clamp does, and the identity matrix's 0 * x terms are kept (a
// non-finite x makes them NaN, not 0). So kernel and twin agree bit for bit.
// The fetch is K3's (csrc/lut_fetch.cu): rows first, clamp-edge weight
// merge; kBf16 carries LTC_LUT_BF16 (row weights and table entries rounded
// to bf16, f32 sums), as lut_fetch_kernel<true> does.
//
// What bounds it on an H100. Per pixel 40 B in (three (H, W, 3) fields and
// roughness) and 8 B out per light: at 1080p with two lights 116 MB,
// 0.035 ms at 3.35 TB/s. The arithmetic is heavier than that: per pixel one
// matrix fetch and basis, then per light two evaluations, each with 4
// normalisations, 4 edge integrals, a norm and a fetch — some 1,300 FP32
// operations per pixel with two lights, about 110 of them IEEE divisions
// and square roots that expand to several instructions each. So the kernel
// is bound by FP32 instruction throughput, not bytes. Design: one thread
// per pixel, all lights in one launch, the matrix fetch and the basis
// computed once per pixel and shared by both evaluations of every light;
// nothing between the inputs and the two outputs touches device memory.
// The tables stay on chip through L1: 16-byte __ldg taps of the
// texel-interleaved (64, 64, 4) tables as stored, one float4 per ltc1 tap;
// the 128 KB of the two tables stays resident in the SMs' L1/texture
// caches, since neighbouring pixels tap neighbouring texels. One thread per
// pixel, 256-thread CTAs. A variant that staged ltc1 and ltc2's x and w
// channels (96 KB) once per CTA in dynamic shared memory, two persistent
// CTAs per SM, gave the same words and was slower on an H100: 0.265 ms
// against 0.212 at 1080p with two lights (PERF.md).

#include "ltc_common.cuh"

namespace {

using namespace ltc;

// integrate_edge (ltc.wgsl:52-66)
__device__ __forceinline__ V3 integrate_edge(V3 v1, V3 v2) {
  const float x = dot(v1, v2);
  const float y = fabsf(x);
  const float a = add((float)0.8543985,
                      mul(add((float)0.4965155, mul((float)0.0145206, y)), y));
  const float b = add((float)3.4175940, mul(add((float)4.1616724, y), y));
  const float v = __fdiv_rn(a, b);
  float ts;
  if (x > 0.0f) {
    ts = v;
  } else {
    const float s = __fsqrt_rn(clamp_min(sub(1.0f, mul(x, x)), (float)1e-7));
    ts = sub(mul(__frcp_rn(s), 0.5f), v);
  }
  return v_scale(cross(v1, v2), ts);
}

// ltc_evaluate_rect for one light and one matrix, from the light-relative
// corners rel[k] = P_k - pos.
template <bool kBf16>
__device__ __forceinline__ float evaluate_rect(const Tables& tab,
                                               const M3& minv, const V3* rel,
                                               bool behind) {
  V3 ln[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) ln[k] = normalize(mat3_vec(minv, rel[k]));
  const V3 vsum = v_add(v_add(v_add(integrate_edge(ln[0], ln[1]),
                                    integrate_edge(ln[1], ln[2])),
                              integrate_edge(ln[2], ln[3])),
                        integrate_edge(ln[3], ln[0]));
  const float length = __fsqrt_rn(dot(vsum, vsum));
  float z = __fdiv_rn(vsum.z, clamp_min(length, (float)1e-20));
  z = behind ? -z : z;
  const Taps<kBf16> tp(add(mul(add(mul(z, 0.5f), 0.5f), kLutScale), kLutBias),
                       add(mul(length, kLutScale), kLutBias));
  const float scale = tp.lerp(tab.t2w(tp.o00), tab.t2w(tp.o10),
                              tab.t2w(tp.o01), tab.t2w(tp.o11));
  return behind ? 0.0f : mul(length, scale);
}

__device__ __forceinline__ V3 load3(const float* p, long long i) {
  return {__ldg(p + 3 * i), __ldg(p + 3 * i + 1), __ldg(p + 3 * i + 2)};
}

// One pixel: the matrix fetch and the basis once, then every light.
template <bool kBf16>
__device__ __forceinline__ void shade_pixel(
    const Tables& tab, const float* __restrict__ nor,
    const float* __restrict__ rd, const float* __restrict__ pos,
    const float* __restrict__ roughness, const float* __restrict__ points,
    int n_lights, long long p, long long i, float* __restrict__ diff,
    float* __restrict__ spec) {
  const V3 n = load3(nor, i);
  const V3 view = load3(rd, i);
  const V3 x = load3(pos, i);
  const float rough = __ldg(roughness + i);

  // ltc_matrix
  const float ndotv = clamp(dot(n, view), 0.0f, 1.0f);
  const Taps<kBf16> tp(add(mul(rough, kLutScale), kLutBias),
                       add(mul(__fsqrt_rn(sub(1.0f, ndotv)), kLutScale),
                           kLutBias));
  const float4 a00 = tab.t1(tp.o00), a10 = tab.t1(tp.o10);
  const float4 a01 = tab.t1(tp.o01), a11 = tab.t1(tp.o11);
  const float t1x = tp.lerp(a00.x, a10.x, a01.x, a11.x);
  const float t1y = tp.lerp(a00.y, a10.y, a01.y, a11.y);
  const float t1z = tp.lerp(a00.z, a10.z, a01.z, a11.z);
  const float t1w = tp.lerp(a00.w, a10.w, a01.w, a11.w);
  const float t2x = tp.lerp(tab.t2x(tp.o00), tab.t2x(tp.o10),
                            tab.t2x(tp.o01), tab.t2x(tp.o11));
  const M3 m_spec = {{{t1x, 0.0f, t1z}, {0.0f, 1.0f, 0.0f}, {t1y, 0.0f, t1w}}};
  const M3 m_diff = {{{1.0f, 0.0f, 0.0f}, {0.0f, 1.0f, 0.0f},
                      {0.0f, 0.0f, 1.0f}}};

  // the basis of ltc_evaluate_rect, the same for every light
  const V3 t1v = normalize(v_sub(view, v_scale(n, dot(view, n))));
  const V3 t2v = cross(n, t1v);
  const M3 basis = {{{t1v.x, t1v.y, t1v.z}, {t2v.x, t2v.y, t2v.z},
                     {n.x, n.y, n.z}}};
  const M3 minv_diff = mat3_mat3(m_diff, basis);
  const M3 minv_spec = mat3_mat3(m_spec, basis);

  for (int l = 0; l < n_lights; ++l) {
    const float* q = points + 12 * l;
    V3 corner[4], rel[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      corner[k] = {__ldg(q + 3 * k), __ldg(q + 3 * k + 1),
                   __ldg(q + 3 * k + 2)};
      rel[k] = v_sub(corner[k], x);
    }
    const V3 light_normal =
        cross(v_sub(corner[1], corner[0]), v_sub(corner[3], corner[0]));
    const bool behind = dot(rel[0], light_normal) < 0.0f;
    const size_t o = (size_t)l * p + i;
    diff[o] = evaluate_rect<kBf16>(tab, minv_diff, rel, behind);
    spec[o] = mul(evaluate_rect<kBf16>(tab, minv_spec, rel, behind), t2x);
  }
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
ltc_rect_kernel(const float* __restrict__ nor, const float* __restrict__ rd,
                const float* __restrict__ pos,
                const float* __restrict__ roughness,
                const float* __restrict__ points, int n_lights,
                const float4* __restrict__ ltc1,
                const float4* __restrict__ ltc2, long long p,
                float* __restrict__ diff, float* __restrict__ spec) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p) return;
  const Tables tab{ltc1, ltc2};
  shade_pixel<kBf16>(tab, nor, rd, pos, roughness, points, n_lights, p, i,
                     diff, spec);
}

template <bool kBf16>
int launch(const void* nor, const void* rd, const void* pos,
           const void* roughness, const void* points, int n_lights,
           const void* ltc1, const void* ltc2, long long p, void* diff,
           void* spec, void* stream) {
  // p > 0 and n_lights > 0: the wrapper launches nothing otherwise.
  const long long blocks = (p + kThreads - 1) / kThreads;
  ltc_rect_kernel<kBf16><<<(unsigned)blocks, kThreads, 0,
                           (cudaStream_t)stream>>>(
      (const float*)nor, (const float*)rd, (const float*)pos,
      (const float*)roughness, (const float*)points, n_lights,
      (const float4*)ltc1, (const float4*)ltc2, p, (float*)diff,
      (float*)spec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int voidin_ltc_rect(const void* nor, const void* rd,
                               const void* pos, const void* roughness,
                               const void* points, int n_lights,
                               const void* ltc1, const void* ltc2,
                               long long p, void* diff,
                               void* spec, void* stream) {
  return launch<false>(nor, rd, pos, roughness, points, n_lights, ltc1, ltc2,
                       p, diff, spec, stream);
}

extern "C" int voidin_ltc_rect_bf16(const void* nor, const void* rd,
                                    const void* pos, const void* roughness,
                                    const void* points, int n_lights,
                                    const void* ltc1, const void* ltc2,
                                    long long p, void* diff,
                                    void* spec, void* stream) {
  return launch<true>(nor, rd, pos, roughness, points, n_lights, ltc1, ltc2,
                      p, diff, spec, stream);
}
