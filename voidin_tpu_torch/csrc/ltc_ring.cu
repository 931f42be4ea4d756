// Fused LTC ring-light evaluation: the LUT fetch (kernel K3) inside its
// consumers on the ring-light frame, both LTC terms of shade_ring_light in
// one launch.
//
// Replaces voidin_tpu/ops/lut_fetch.py _kernel / lut_fetch_pallas (the
// Pallas TPU kernel, bilinear 64x64 table fetch) together with the XLA
// code around its four calls a ring frame: voidin_tpu/passes/shading.py
// ltc_matrix (:191-218), ltc_evaluate_disk (:771-873) three times (the
// annulus' outer and inner disks under the fetched matrix, the full disk
// under the identity) and the spec / diffuse terms of shade_ring_light
// (:969-1051). Eager PyTorch ran that chain as some 250 elementwise
// launches a disk, each reading and writing (H, W) or (H, W, 3) f32 fields.
//
// What it computes, per pixel (nor, rd = view, pos) at the constant
// roughness, with the disks' corners (-ex-ey, +ex-ey, +ex+ey) as kernel
// arguments:
//   ltc_matrix: uv = (roughness, sqrt(1 - clamp(nor . view, 0, 1)))
//     * LUT_SCALE + LUT_BIAS; t1 = ltc1[uv].xyzw, t2x = ltc2[uv].x;
//     M = rows (t1.x, 0, t1.z), (0, 1, 0), (t1.y, 0, t1.w).
//   the basis: rows T1 = normalize(view - nor (view . nor)), T2 = nor x T1,
//     nor; minv = M @ basis (and I @ basis).
//   evaluate_disk(minv, corners) (ops/ltc_ring.py): the corners in cosine
//     space, the ellipse's centre and axes, its eigen-decomposition (the
//     aligned branch where the axes are orthogonal), the cubic of the
//     horizon-clipped sphere (two atan2 and four cos), the average
//     direction and form factor, and the form factor times the LTC2
//     channel-3 tap at (avg.z / 2 + 1/2, form) * LUT_SCALE + LUT_BIAS,
//     times the front-facing test unless two-sided.
//   Outputs spec = (disk(M, outer) - disk(M, inner)) * t2x and
//   diff = disk(I, outer), each (H, W) f32.
// Every step is rounded as the PyTorch twin (ltc_ring_terms_reference)
// rounds it on the card: the library is built with -fmad=false; sums keep
// the twin's order; division and square root are IEEE; a tensor divided by
// a Python scalar is a product with its f32 reciprocal, as torch's CUDA
// division by a CPU scalar computes it (x / 3 is x * 0.33333334f), and
// 1 / x is rcp(x) (torch's reversed division); fastmath.cross's components
// are the twin's own f64 expression, rounded once to f32 (exactly XLA's
// fused a_j b_k - rnd(a_k b_j)); relu turns -0 into +0 (atan2 sees the
// sign) and clamps let NaN through. The unselected branch of each select
// computes nothing that the selected one reads. atan2f and cosf are the CUDA
// math library's, as in torch's atan2 and cos kernels.
//
// What bounds it on an H100. Per pixel 36 B in (three (H, W, 3) fields)
// and 8 B out: at 1080p 91 MB, 0.027 ms at 3.35 TB/s. The arithmetic is
// far heavier: per pixel one matrix fetch and basis, then three disk
// evaluations, each about 380 FP32 operations with ~30 IEEE divisions and
// square roots (several instructions each), 2 atan2f and 4 cosf (tens of
// instructions each) and a fetch — some 1,300 operations per pixel
// (chip_smoke.ltc_ring_bound counts them). So it is bound by FP32
// instruction throughput, not bytes. Design (csrc/ltc_rect.cu's): one
// thread per pixel, 256-thread CTAs; the matrix fetch and the basis once
// per pixel, shared by the three evaluations; the tables read through L1
// by 16-byte __ldg taps of the (64, 64, 4) tables as stored; nothing
// between the inputs and the two outputs touches device memory.

#include "ltc_common.cuh"

namespace {

using namespace ltc;

constexpr float kThird = 1.0f / 3.0f;  // torch's CUDA x / 3.0
constexpr float kTwoThirdsPi = (float)(2.0 * 3.14159265358979323846 / 3.0);

// The outer and inner disks' corners (-ex-ey, +ex-ey, +ex+ey).
struct Disks {
  float p[2][3][3];
};

// ops/ltc_ring.py relu: clamp(x, min=0) + 0, NaN kept, -0 -> +0
__device__ __forceinline__ float relu(float x) {
  return add(clamp_min(x, 0.0f), 0.0f);
}
// ops/ltc_ring.py guard: where(|x| > eps, x, eps)
__device__ __forceinline__ float guard(float x, float eps) {
  return fabsf(x) > eps ? x : eps;
}
// torch's 1 / x: reciprocal(x) * 1
__device__ __forceinline__ float rcp(float x) { return __frcp_rn(x); }

// fastmath.cross: each component a_j b_k - rnd(a_k b_j) in f64, rounded
// once to f32 (a_j b_k is exact in f64)
__device__ __forceinline__ float cross_comp(float aj, float bk, float ak,
                                            float bj) {
  return __double2float_rn(__dsub_rn(__dmul_rn((double)aj, (double)bk),
                                     (double)mul(ak, bj)));
}
__device__ __forceinline__ V3 cross_fma(V3 a, V3 b) {
  return {cross_comp(a.y, b.z, a.z, b.y), cross_comp(a.z, b.x, a.x, b.z),
          cross_comp(a.x, b.y, a.y, b.x)};
}

// solve_cubic(c0, c1, c2, c3 = 1): the middle root e2 and the outer ones
// e1, e3 after the reference's partial sort.
__device__ __forceinline__ void solve_cubic(float c0, float c1, float c2,
                                            float& e1, float& e2,
                                            float& e3) {
  const float B = mul(c2, kThird);  // c2 / 1 / 3
  const float C = mul(c1, kThird);
  const float D = c0;
  const float d1 = sub(C, mul(B, B));
  const float d2 = sub(D, mul(C, B));
  const float d3 = sub(mul(B, D), mul(C, C));
  const float disc = relu(sub(mul(mul(4.0f, d1), d3), mul(d2, d2)));
  const float sq_disc = __fsqrt_rn(disc);

  // algorithm A (largest root)
  const float d_a = add(mul(mul(B, -2.0f), d1), d2);
  const float theta_a = mul(atan2f(sq_disc, -d_a), kThird);
  const float sc_a = mul(__fsqrt_rn(relu(-d1)), 2.0f);
  const float x1a = mul(sc_a, cosf(theta_a));
  const float x3a = mul(sc_a, cosf(add(theta_a, kTwoThirdsPi)));
  const float xl = add(x1a, x3a) > mul(B, 2.0f) ? x1a : x3a;
  const float xl_num = sub(xl, B);  // xl_den = 1

  // algorithm D (smallest root)
  const float d_d = add(mul(-D, d2), mul(mul(C, 2.0f), d3));
  const float theta_d = mul(atan2f(mul(D, sq_disc), -d_d), kThird);
  const float sc_d = mul(__fsqrt_rn(relu(-d3)), 2.0f);
  const float x1d = mul(sc_d, cosf(theta_d));
  const float x3d = mul(sc_d, cosf(add(theta_d, kTwoThirdsPi)));
  const float xs = add(x1d, x3d) < mul(C, 2.0f) ? x1d : x3d;
  const float xs_num = -D;
  const float xs_den = add(xs, C);

  // e = 1 xs_den, f = -xl_num xs_den - 1 xs_num: the products by 1 exact
  const float f = sub(mul(-xl_num, xs_den), xs_num);
  const float g = mul(xl_num, xs_num);
  const float xm_num = sub(mul(C, f), mul(B, g));
  const float xm_den = add(mul(-B, f), mul(C, xs_den));

  const float rx = __fdiv_rn(xs_num, guard(xs_den, (float)1e-20));
  const float ry = __fdiv_rn(xm_num, guard(xm_den, (float)1e-20));
  const float rz = xl_num;  // xl_num / guard(1) is exact
  const bool x_small = (rx < ry) && (rx < rz);
  const bool z_small = (rz < rx) && (rz < ry);
  e1 = x_small ? ry : rx;
  e2 = x_small ? rx : (z_small ? rz : ry);
  e3 = z_small ? ry : rz;
}

// ops/ltc_ring.py evaluate_disk for one disk, from the basis-transformed
// matrix and the pixel's position.
template <bool kBf16>
__device__ float evaluate_disk(const Tables& tab, const M3& minv,
                               const float (&pts)[3][3], V3 x,
                               bool two_sided) {
  V3 l[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const V3 corner = {pts[k][0], pts[k][1], pts[k][2]};
    l[k] = mat3_vec(minv, v_sub(corner, x));
  }
  const V3 c = v_scale(v_add(l[0], l[2]), 0.5f);
  V3 v1 = v_scale(v_sub(l[1], l[2]), 0.5f);
  V3 v2 = v_scale(v_sub(l[1], l[0]), 0.5f);

  const bool front = dot(cross_fma(v1, v2), c) >= 0.0f;
  const float occlusion = (two_sided || front) ? 1.0f : 0.0f;

  const float d11 = dot(v1, v1);
  const float d22 = dot(v2, v2);
  const float d12 = dot(v1, v2);
  const bool skew =
      __fdiv_rn(fabsf(d12),
                __fsqrt_rn(clamp_min(mul(d11, d22), (float)1e-20))) >
      (float)1e-4;

  float a, b;
  if (skew) {  // the eigen-decomposition branch
    const float tr = add(d11, d22);
    const float det = __fsqrt_rn(relu(sub(mul(d11, d22), mul(d12, d12))));
    const float u = mul(__fsqrt_rn(relu(sub(tr, mul(det, 2.0f)))), 0.5f);
    const float w = mul(__fsqrt_rn(relu(add(tr, mul(det, 2.0f)))), 0.5f);
    const float e_max = mul(add(u, w), add(u, w));
    const float e_min = mul(sub(u, w), sub(u, w));
    V3 v1e, v2e;
    if (d11 > d22) {
      v1e = v_add(v_scale(v1, d12), v_scale(v2, sub(e_max, d11)));
      v2e = v_add(v_scale(v1, d12), v_scale(v2, sub(e_min, d11)));
    } else {
      v1e = v_add(v_scale(v2, d12), v_scale(v1, sub(e_max, d22)));
      v2e = v_add(v_scale(v2, d12), v_scale(v1, sub(e_min, d22)));
    }
    a = rcp(clamp_min(e_max, (float)1e-20));
    b = rcp(clamp_min(e_min, (float)1e-20));
    v1 = normalize(v1e);
    v2 = normalize(v2e);
  } else {  // the aligned branch
    a = rcp(clamp_min(d11, (float)1e-20));
    b = rcp(clamp_min(d22, (float)1e-20));
    v1 = v_scale(v1, __fsqrt_rn(a));
    v2 = v_scale(v2, __fsqrt_rn(b));
  }

  V3 v3 = cross_fma(v1, v2);
  if (dot(c, v3) < 0.0f) v3 = {-v3.x, -v3.y, -v3.z};

  const float ll = dot(v3, c);
  const float ll_safe = guard(ll, (float)1e-20);
  const float x0 = __fdiv_rn(dot(v1, c), ll_safe);
  const float y0 = __fdiv_rn(dot(v2, c), ll_safe);
  a = mul(mul(a, ll), ll);
  b = mul(mul(b, ll), ll);

  const float ab = mul(a, b);
  const float x0sq1 = add(mul(x0, x0), 1.0f);
  const float c1 = sub(sub(mul(ab, add(x0sq1, mul(y0, y0))), a), b);
  const float c2 =
      sub(sub(1.0f, mul(a, x0sq1)), mul(b, add(mul(y0, y0), 1.0f)));
  float e1, e2, e3;
  solve_cubic(ab, c1, c2, e1, e2, e3);

  const float avg_x = __fdiv_rn(mul(a, x0), guard(sub(a, e2), (float)1e-20));
  const float avg_y = __fdiv_rn(mul(b, y0), guard(sub(b, e2), (float)1e-20));
  const V3 avg_dir = normalize(
      v_add(v_add(v_scale(v1, avg_x), v_scale(v2, avg_y)), v3));

  const float l1f =
      __fsqrt_rn(relu(__fdiv_rn(-e2, guard(e3, (float)1e-20))));
  const float l2f =
      __fsqrt_rn(relu(__fdiv_rn(-e2, guard(e1, (float)1e-20))));
  const float form = __fdiv_rn(
      mul(l1f, l2f),
      __fsqrt_rn(mul(add(mul(l1f, l1f), 1.0f), add(mul(l2f, l2f), 1.0f))));

  const Taps<kBf16> tp(
      add(mul(add(mul(avg_dir.z, 0.5f), 0.5f), kLutScale), kLutBias),
      add(mul(form, kLutScale), kLutBias));
  const float scale = tp.lerp(tab.t2w(tp.o00), tab.t2w(tp.o10),
                              tab.t2w(tp.o01), tab.t2w(tp.o11));
  return mul(mul(form, scale), occlusion);
}

__device__ __forceinline__ V3 load3(const float* p, long long i) {
  return {__ldg(p + 3 * i), __ldg(p + 3 * i + 1), __ldg(p + 3 * i + 2)};
}

template <bool kBf16>
__global__ void __launch_bounds__(kThreads)
ltc_ring_kernel(const float* __restrict__ nor, const float* __restrict__ rd,
                const float* __restrict__ pos, float roughness, Disks disks,
                int two_sided, const float4* __restrict__ ltc1,
                const float4* __restrict__ ltc2, long long p,
                float* __restrict__ spec, float* __restrict__ diff) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= p) return;
  const Tables tab{ltc1, ltc2};
  const V3 n = load3(nor, i);
  const V3 view = load3(rd, i);
  const V3 x = load3(pos, i);

  // ltc_matrix
  const float ndotv = clamp(dot(n, view), 0.0f, 1.0f);
  const Taps<kBf16> tp(add(mul(roughness, kLutScale), kLutBias),
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

  // ltc_basis, the same for the three evaluations
  const V3 t1v = normalize(v_sub(view, v_scale(n, dot(view, n))));
  const V3 t2v = cross_fma(n, t1v);
  const M3 basis = {{{t1v.x, t1v.y, t1v.z}, {t2v.x, t2v.y, t2v.z},
                     {n.x, n.y, n.z}}};
  const M3 minv_spec = mat3_mat3(m_spec, basis);
  const M3 minv_diff = mat3_mat3(m_diff, basis);

  const bool ts = two_sided != 0;
  const float outer = evaluate_disk<kBf16>(tab, minv_spec, disks.p[0], x, ts);
  const float inner = evaluate_disk<kBf16>(tab, minv_spec, disks.p[1], x, ts);
  spec[i] = mul(sub(outer, inner), t2x);
  diff[i] = evaluate_disk<kBf16>(tab, minv_diff, disks.p[0], x, ts);
}

template <bool kBf16>
int launch(const void* nor, const void* rd, const void* pos, float roughness,
           const float* points, int two_sided, const void* ltc1,
           const void* ltc2, long long p, void* spec, void* diff,
           void* stream) {
  // p > 0: the wrapper launches nothing otherwise. `points` is host memory,
  // (2, 3, 3) f32, passed by value.
  Disks disks;
  for (int d = 0; d < 2; ++d)
    for (int k = 0; k < 3; ++k)
      for (int c = 0; c < 3; ++c) disks.p[d][k][c] = points[9 * d + 3 * k + c];
  const long long blocks = (p + kThreads - 1) / kThreads;
  ltc_ring_kernel<kBf16><<<(unsigned)blocks, kThreads, 0,
                           (cudaStream_t)stream>>>(
      (const float*)nor, (const float*)rd, (const float*)pos, roughness,
      disks, two_sided, (const float4*)ltc1, (const float4*)ltc2, p,
      (float*)spec, (float*)diff);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int voidin_ltc_ring(const void* nor, const void* rd,
                               const void* pos, float roughness,
                               const float* points, int two_sided,
                               const void* ltc1, const void* ltc2,
                               long long p, void* spec, void* diff,
                               void* stream) {
  return launch<false>(nor, rd, pos, roughness, points, two_sided, ltc1, ltc2,
                       p, spec, diff, stream);
}

extern "C" int voidin_ltc_ring_bf16(const void* nor, const void* rd,
                                    const void* pos, float roughness,
                                    const float* points, int two_sided,
                                    const void* ltc1, const void* ltc2,
                                    long long p, void* spec, void* diff,
                                    void* stream) {
  return launch<true>(nor, rd, pos, roughness, points, two_sided, ltc1, ltc2,
                      p, spec, diff, stream);
}
