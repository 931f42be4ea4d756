// Skinning and refits: every skin of a scene posed, and its BLAS and the
// TLAS refit, in three launches a frame.
//
// Replaces no TPU kernel: the JAX package skins in plain jnp
// (voidin_tpu/scene/skin.py apply_skins, refit_blas, refit_tlas), which XLA
// fuses on the TPU. Eager PyTorch does not fuse it: the port's chain
// (scene/skin.py apply_skin per skin, then refit_blas level by level, then
// refit_tlas) ran as ~7,400 launches a frame on a crowd of 32 skins, each
// launch a few microseconds of work behind ~40 us of host dispatch. These
// kernels compute that chain for every skin at once (ops/skin.py launches
// them; scene/skin.py keeps the chain as their plain twin).
//
// skin_pose_kernel: one thread a triangle corner, a block a run of
//   kTris triangles of one skin. The skin's joint matrices are staged in
//   shared memory (64 B each, as they lie in global memory; dynamic shared
//   memory sized by the batch's largest skeleton, which set-up holds to
//   ops/skin.py MAX_JOINTS). Per corner, as the chain rounds it: the four joint
//   matrices blended ((M0 w0 + M1 w1) + M2 w2) + M3 w3, each product and
//   sum rounded; position, normal and tangent rotated by the blend's 3x3
//   (fastmath.dot_fma: m0 v0 rounded, then two fused steps emulated in
//   f64, a * b exact there, the sum rounded to f64 and then to f32), the
//   translation added; normal and tangent divided by max(|v|, 1e-20)
//   (IEEE sqrt and division); both octahedral-encoded as
//   encoding.encode_octahedral_32 does (torch.sign's 0 for a zero, floor,
//   a truncating cast to int64); the tangent's handedness in the LSB; the
//   uv words copied. Writes the corner's row words into the frame's copies
//   of tri_pos and tri_attr_packed, and the mesh's box: each block reduces
//   its corners to a partial box, and the skin's last block (an arrival
//   counter a skin, reset by that block) reduces the partials into
//   mesh_min / mesh_max.
// blas_refit_kernel: every refittable BLAS of the batch in one
//   cooperative launch, as refit_blas walks each plan: level after level,
//   deepest first (step k takes level k of every skin's plan), a grid-wide
//   barrier between levels, one thread a plan row. A leaf takes the union
//   of its triangles' posed corners (read back from tri_pos); an internal
//   node the union of its children left and left + 1. It reads each skin's
//   own refit plan (SkinData refit_order, refit_child, refit_leaf_tri) in
//   place: set-up adds a few hundred bytes of step tables, no copy.
// tlas_refit_kernel: the same over the TLAS's plan; a leaf's box is its
//   instance's mesh box, the 8 corners through the instance transform
//   (rotation as dot_fma, then the translation), as refit_tlas computes it.
//
// Min and max are exact, so every schedule gives the chain's words, with
// one choice to make: between -0.0 and +0.0 the chain takes JAX's rule
// (min prefers -0, max prefers +0; scene/skin.py _amin and friends), and
// so do zmin / zmax below. NaN propagates as torch's min and max let it.
//
// What bounds it on an H100: the pose must read each corner's three rest
// vectors (36 B), four weights (16 B) and four joint indices (4 B at one
// byte each) and write its position (12 B) and two octahedral words (8 B):
// 228 B a triangle, 84 MB on the crowd, 25 us at 3.35 TB/s (the layout
// here reads the indices as int32, the uv and the handedness as well).
// Its FP32 and FP64 work is ~150 operations a corner, ~2 us. The refits
// read a few MB; their time is the levels' barriers (19 BLAS levels on the
// crowd). Each launch is one grid; the frame's three launches cost a few
// microseconds of host each.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kTris = 128;           // triangles a pose block
constexpr int kThreads = 3 * kTris;  // one thread a corner
constexpr int kRefitThreads = 128;

__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float dv(float a, float b) {
  return __fdiv_rn(a, b);
}
// fastmath._fma: fma(a, b, c) emulated in f64, where a * b is exact; the
// sum rounds to f64, then to f32, as the twin computes it.
__device__ __forceinline__ float fma64(float a, float b, float c) {
  return __double2float_rn(
      __dadd_rn(__dmul_rn((double)a, (double)b), (double)c));
}
// fastmath.dot_fma of a 3-vector: fma(a2, b2, fma(a1, b1, a0 * b0)).
__device__ __forceinline__ float dot3(float a0, float a1, float a2, float b0,
                                      float b1, float b2) {
  return fma64(a2, b2, fma64(a1, b1, mul(a0, b0)));
}
// min / max with JAX's signed zeros (-0 < +0), NaN passing through.
__device__ __forceinline__ float zmin(float a, float b) {
  if (isnan(a)) return a;
  if (isnan(b)) return b;
  return (a < b || (a == b && signbit(a))) ? a : b;
}
__device__ __forceinline__ float zmax(float a, float b) {
  if (isnan(a)) return a;
  if (isnan(b)) return b;
  return (a > b || (a == b && !signbit(a))) ? a : b;
}
// torch.sign: (0 < a) - (a < 0), so 0 for either zero and for NaN.
__device__ __forceinline__ float sgn(float a) {
  return (float)((0.0f < a) - (a < 0.0f));
}
// encoding.encode_octahedral_32 of one vector.
__device__ __forceinline__ int encode_oct(float n0, float n1, float n2) {
  const float denom = add(add(fabsf(n0), fabsf(n1)), fabsf(n2));
  const float x = dv(n0, denom), y = dv(n1, denom), z = dv(n2, denom);
  float fx = x, fy = y;
  if (z < 0.0f) {
    fx = mul(sub(1.0f, fabsf(y)), sgn(x));
    fy = mul(sub(1.0f, fabsf(x)), sgn(y));
  }
  const float vx = add(mul(fx, 0.5f), 0.5f);
  const float vy = add(mul(fy, 0.5f), 0.5f);
  const long long d0 =
      (long long)floorf(add(mul(vx, 65535.0f), 0.5f)) & 0xFFFFFFFFLL;
  const long long d1 =
      (long long)floorf(add(mul(vy, 65535.0f), 0.5f)) & 0xFFFFFFFFLL;
  return (int)(unsigned int)(((d1 << 16) | d0) & 0xFFFFFFFFLL);
}
// v / max(|v|, 1e-20) (scene/skin.py _unit; torch.clamp passes NaN).
__device__ __forceinline__ void unit(float& v0, float& v1, float& v2) {
  float n = __fsqrt_rn(add(add(mul(v0, v0), mul(v1, v1)), mul(v2, v2)));
  if (!isnan(n)) n = fmaxf(n, 1e-20f);
  v0 = dv(v0, n);
  v1 = dv(v1, n);
  v2 = dv(v2, n);
}

// One skin's tables (SkinData), each contiguous and 16-byte aligned.
struct SkinTables {
  const float* pos;      // (T, 3, 3)
  const float* nrm;      // (T, 3, 3)
  const float* tan;      // (T, 3, 3)
  const float* tan_w;    // (T, 3)
  const float* uv;       // (T, 3, 2)
  const int* joints;     // (T, 3, 4)
  const float* weights;  // (T, 3, 4)
};

// skin_info row: n_tri, base_tri, joint_offset, n_joints, mesh_id,
// first_block, n_blocks, 0.
struct PoseArgs {
  const SkinTables* skins;
  const int* skin_info;   // (S, 8)
  const int* block_skin;  // (blocks,)
  const float4* joint_mats;  // (J, 4, 4)
  float* tri_pos;         // (T_pool, 9)
  int* tri_attr;          // (T_pool, 12)
  float* mesh_min;        // (M, 3)
  float* mesh_max;
  float* partials;        // (blocks, 6)
  int* skin_done;         // (S,), zero between launches
};

__device__ __forceinline__ void block_box(float lo[3], float hi[3],
                                          float (*red)[kThreads / 32]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      lo[i] = zmin(lo[i], __shfl_down_sync(0xffffffffu, lo[i], off));
      hi[i] = zmax(hi[i], __shfl_down_sync(0xffffffffu, hi[i], off));
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      red[i][warp] = lo[i];
      red[3 + i][warp] = hi[i];
    }
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kThreads / 32; ++w) {
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        lo[i] = zmin(lo[i], red[i][w]);
        hi[i] = zmax(hi[i], red[3 + i][w]);
      }
    }
  }
}

__global__ void __launch_bounds__(kThreads)
    skin_pose_kernel(PoseArgs a) {
  extern __shared__ float4 sj[];  // the skin's joint matrices
  __shared__ float red[6][kThreads / 32];
  __shared__ int last;
  const int s = a.block_skin[blockIdx.x];
  const int* info = a.skin_info + 8 * s;
  const int n_tri = info[0], base_tri = info[1], joint_off = info[2];
  const int n_joints = info[3], mesh_id = info[4], first_block = info[5];
  const int n_blocks = info[6];
  const SkinTables t = a.skins[s];

  const float4* J = a.joint_mats + 4 * (long long)joint_off;
  for (int i = threadIdx.x; i < 4 * n_joints; i += kThreads)
    sj[i] = __ldg(J + i);
  __syncthreads();

  const long long k =
      (long long)(blockIdx.x - first_block) * kThreads + threadIdx.x;
  const bool valid = k < 3LL * n_tri;
  const float inf = __int_as_float(0x7f800000);
  float lo[3] = {inf, inf, inf}, hi[3] = {-inf, -inf, -inf};
  if (valid) {
    const int4 jt = __ldg(reinterpret_cast<const int4*>(t.joints) + k);
    const float4 w = __ldg(reinterpret_cast<const float4*>(t.weights) + k);
    const int ji[4] = {jt.x, jt.y, jt.z, jt.w};
    const float wi[4] = {w.x, w.y, w.z, w.w};
    // the blend's rows 0-2 (the 3x3 and the translation column)
    float m[12];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      float4 acc;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const float4 row = sj[4 * ji[q] + r];
        const float4 p = make_float4(mul(row.x, wi[q]), mul(row.y, wi[q]),
                                     mul(row.z, wi[q]), mul(row.w, wi[q]));
        if (q == 0) {
          acc = p;
        } else {
          acc = make_float4(add(acc.x, p.x), add(acc.y, p.y),
                            add(acc.z, p.z), add(acc.w, p.w));
        }
      }
      m[4 * r] = acc.x;
      m[4 * r + 1] = acc.y;
      m[4 * r + 2] = acc.z;
      m[4 * r + 3] = acc.w;
    }
    const float* rp = t.pos + 3 * k;
    const float* rn = t.nrm + 3 * k;
    const float* rt = t.tan + 3 * k;
    const float p0 = __ldg(rp), p1 = __ldg(rp + 1), p2 = __ldg(rp + 2);
    const float n0 = __ldg(rn), n1 = __ldg(rn + 1), n2 = __ldg(rn + 2);
    const float t0 = __ldg(rt), t1 = __ldg(rt + 1), t2 = __ldg(rt + 2);
    float pos[3], nrm[3], tan[3];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const float* R = m + 4 * r;
      pos[r] = add(dot3(R[0], R[1], R[2], p0, p1, p2), R[3]);
      nrm[r] = dot3(R[0], R[1], R[2], n0, n1, n2);
      tan[r] = dot3(R[0], R[1], R[2], t0, t1, t2);
    }
    unit(nrm[0], nrm[1], nrm[2]);
    unit(tan[0], tan[1], tan[2]);
    const int n_oct = encode_oct(nrm[0], nrm[1], nrm[2]);
    int t_oct = encode_oct(tan[0], tan[1], tan[2]);
    t_oct = (t_oct & -2) | (__ldg(t.tan_w + k) < 0.0f ? 1 : 0);
    const float2 uv = __ldg(reinterpret_cast<const float2*>(t.uv) + k);

    const long long tri = k / 3;
    const int c = (int)(k - 3 * tri);
    const long long row = base_tri + tri;
    float* out_p = a.tri_pos + 9 * row + 3 * c;
    out_p[0] = pos[0];
    out_p[1] = pos[1];
    out_p[2] = pos[2];
    int* out_a = a.tri_attr + 12 * row;
    out_a[2 * c] = __float_as_int(uv.x);
    out_a[2 * c + 1] = __float_as_int(uv.y);
    out_a[6 + c] = n_oct;
    out_a[9 + c] = t_oct;
#pragma unroll
    for (int i = 0; i < 3; ++i) lo[i] = hi[i] = pos[i];
  }

  // the mesh box: this block's partial, then the skin's last block
  block_box(lo, hi, red);
  if (threadIdx.x == 0) {
    float* part = a.partials + 6 * (long long)blockIdx.x;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      part[i] = lo[i];
      part[3 + i] = hi[i];
    }
    __threadfence();
    last = atomicAdd(a.skin_done + s, 1) == n_blocks - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    lo[i] = inf;
    hi[i] = -inf;
  }
  for (int b = threadIdx.x; b < n_blocks; b += kThreads) {
    const float* part = a.partials + 6 * (long long)(first_block + b);
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      lo[i] = zmin(lo[i], __ldcg(part + i));
      hi[i] = zmax(hi[i], __ldcg(part + 3 + i));
    }
  }
  __syncthreads();  // red is reused
  block_box(lo, hi, red);
  if (threadIdx.x == 0) {
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      a.mesh_min[3 * mesh_id + i] = lo[i];
      a.mesh_max[3 * mesh_id + i] = hi[i];
    }
    a.skin_done[s] = 0;
  }
}

// Level loops: one thread a plan row, rows of a level spread over the
// grid, the levels one after another with a grid-wide barrier between
// them (a cooperative launch, every block resident). A node's children
// lie in earlier levels, written before the barrier; their boxes are read
// through L2 (__ldcg), since a block's L1 may hold a stale line of them.

// One refittable skin's plan (SkinData refit_order, refit_child,
// refit_leaf_tri, int32) and blas_info row: bvh_base, base_tri, the leaf
// table's columns, 0.
struct BlasPlan {
  const int* order;     // (B,) mesh-local node ids
  const int* child;     // (B,) mesh-local left child, -1 at a leaf
  const int* leaf_tri;  // (B, C) skin-local triangles, -1 pad
};

struct BlasArgs {
  const BlasPlan* plans;   // (R,)
  const int* info;         // (R, 4)
  const int* step_first;   // (K, R): skin r's first plan row at step k
  const int* step_prefix;  // (K, R + 1): step k's rows before skin r
  const float* tri_pos;    // (T_pool, 9), posed
  float* bmin;             // (N_nodes, 3)
  float* bmax;
  int n_plans, n_steps, n_nodes;
};

__global__ void __launch_bounds__(kRefitThreads)
    blas_refit_kernel(BlasArgs a) {
  cg::grid_group grid = cg::this_grid();
  const long long stride = (long long)gridDim.x * kRefitThreads;
  const float inf = __int_as_float(0x7f800000);
  for (int k = 0; k < a.n_steps; ++k) {
    const int* pre = a.step_prefix + (long long)k * (a.n_plans + 1);
    const int total = pre[a.n_plans];
    for (long long t = (long long)blockIdx.x * kRefitThreads + threadIdx.x;
         t < total; t += stride) {
      int r = 0, hi = a.n_plans - 1;  // the last plan with pre[r] <= t
      while (r < hi) {
        const int mid = (r + hi + 1) >> 1;
        if (pre[mid] <= t) {
          r = mid;
        } else {
          hi = mid - 1;
        }
      }
      const BlasPlan p = a.plans[r];
      const int4 info = reinterpret_cast<const int4*>(a.info)[r];
      const long long row = a.step_first[(long long)k * a.n_plans + r] +
                            (t - pre[r]);
      const int node = info.x + __ldg(p.order + row);
      const int child = __ldg(p.child + row);
      float lo[3] = {inf, inf, inf}, hi3[3] = {-inf, -inf, -inf};
      if (child < 0) {
        const int* lt = p.leaf_tri + row * info.z;
        for (int j = 0; j < info.z; ++j) {
          const int tri = __ldg(lt + j);
          if (tri < 0) continue;
          const float* q = a.tri_pos + 9 * (long long)(info.y + tri);
#pragma unroll
          for (int c = 0; c < 9; ++c) {
            const float v = __ldg(q + c);
            lo[c % 3] = zmin(lo[c % 3], v);
            hi3[c % 3] = zmax(hi3[c % 3], v);
          }
        }
      } else {
        const int c0 = info.x + child;
        const int c1 = c0 + 1 < a.n_nodes ? c0 + 1 : a.n_nodes - 1;
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          lo[i] = zmin(__ldcg(a.bmin + 3 * c0 + i), __ldcg(a.bmin + 3 * c1 + i));
          hi3[i] = zmax(__ldcg(a.bmax + 3 * c0 + i), __ldcg(a.bmax + 3 * c1 + i));
        }
      }
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        a.bmin[3 * node + i] = lo[i];
        a.bmax[3 * node + i] = hi3[i];
      }
    }
    grid.sync();
  }
}

// The TLAS plan (TlasData refit_order, refit_child (B, 2), refit_instance,
// int32) and its level bounds (K + 1).
struct TlasArgs {
  const int* order;
  const int* child;
  const int* instance;
  const int* levels;
  const float* mesh_min;   // (M, 3)
  const float* mesh_max;
  const int* mesh_id;      // (N,)
  const float* transform;  // (N, 4, 4)
  float* bmin;             // (B, 3)
  float* bmax;
  int n_levels;
};

__global__ void __launch_bounds__(kRefitThreads)
    tlas_refit_kernel(TlasArgs a) {
  cg::grid_group grid = cg::this_grid();
  const int stride = gridDim.x * kRefitThreads;
  const float inf = __int_as_float(0x7f800000);
  for (int k = 0; k < a.n_levels; ++k) {
    for (int t = a.levels[k] + blockIdx.x * kRefitThreads + threadIdx.x;
         t < a.levels[k + 1]; t += stride) {
      const int node = __ldg(a.order + t);
      const int c0 = __ldg(a.child + 2 * t), c1 = __ldg(a.child + 2 * t + 1);
      float lo[3] = {inf, inf, inf}, hi[3] = {-inf, -inf, -inf};
      if (c0 < 0) {
        const int inst = max(__ldg(a.instance + t), 0);
        const int mid = __ldg(a.mesh_id + inst);
        float mn[3], mx[3], T[12];
#pragma unroll
        for (int j = 0; j < 3; ++j) {
          mn[j] = __ldg(a.mesh_min + 3 * mid + j);
          mx[j] = __ldg(a.mesh_max + 3 * mid + j);
        }
#pragma unroll
        for (int j = 0; j < 12; ++j) T[j] = __ldg(a.transform + 16LL * inst + j);
#pragma unroll
        for (int c = 0; c < 8; ++c) {
          const float v0 = (c & 1) ? mx[0] : mn[0];
          const float v1 = (c & 2) ? mx[1] : mn[1];
          const float v2 = (c & 4) ? mx[2] : mn[2];
#pragma unroll
          for (int r = 0; r < 3; ++r) {
            const float* R = T + 4 * r;
            const float w = add(dot3(R[0], R[1], R[2], v0, v1, v2), R[3]);
            lo[r] = zmin(lo[r], w);
            hi[r] = zmax(hi[r], w);
          }
        }
      } else {
        const int d0 = max(c0, 0), d1 = max(c1, 0);
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          lo[i] = zmin(__ldcg(a.bmin + 3 * d0 + i), __ldcg(a.bmin + 3 * d1 + i));
          hi[i] = zmax(__ldcg(a.bmax + 3 * d0 + i), __ldcg(a.bmax + 3 * d1 + i));
        }
      }
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        a.bmin[3 * node + i] = lo[i];
        a.bmax[3 * node + i] = hi[i];
      }
    }
    grid.sync();
  }
}

// Blocks of kRefitThreads a cooperative launch asks for at most (cached per
// device and kernel): every one must be resident at once.
template <typename Args>
int resident(void (*kernel)(Args), int* cache, cudaError_t& err) {
  int dev = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return 0;
  if (dev < 64 && cache[dev] > 0) return cache[dev];
  int sms = 0, per_sm = 0;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, kernel, kRefitThreads, 0)) != cudaSuccess) {
    return 0;
  }
  const int n = sms * per_sm;
  if (n <= 0) {
    err = cudaErrorLaunchOutOfResources;
    return 0;
  }
  if (dev < 64) cache[dev] = n;
  return n;
}

template <typename Args>
int launch_levels(void (*kernel)(Args), int* cache, Args a, long long rows,
                  void* stream) {
  cudaError_t err = cudaSuccess;
  const int fit = resident(kernel, cache, err);
  if (err != cudaSuccess) return (int)err;
  long long want = (rows + kRefitThreads - 1) / kRefitThreads;
  if (want < 1) want = 1;
  const int grid = (int)(want < fit ? want : fit);
  void* args[] = {&a};
  return (int)cudaLaunchCooperativeKernel((const void*)kernel, grid,
                                          kRefitThreads, args, 0,
                                          (cudaStream_t)stream);
}

int blas_resident[64];
int tlas_resident[64];

}  // namespace

// ptrs: skins (S SkinTables), skin_info, block_skin, joint_mats, tri_pos,
// tri_attr, mesh_min, mesh_max, partials, skin_done. ints: blocks (> 0), the
// shared memory of the largest skeleton's matrices.
extern "C" int voidin_skin_pose(const void* const* ptrs,
                                const long long* ints, void* stream) {
  PoseArgs a;
  a.skins = (const SkinTables*)ptrs[0];
  a.skin_info = (const int*)ptrs[1];
  a.block_skin = (const int*)ptrs[2];
  a.joint_mats = (const float4*)ptrs[3];
  a.tri_pos = (float*)ptrs[4];
  a.tri_attr = (int*)ptrs[5];
  a.mesh_min = (float*)ptrs[6];
  a.mesh_max = (float*)ptrs[7];
  a.partials = (float*)ptrs[8];
  a.skin_done = (int*)ptrs[9];
  const int smem = (int)ints[1];
  const cudaError_t err = cudaFuncSetAttribute(
      skin_pose_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  skin_pose_kernel<<<(int)ints[0], kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// ptrs: plans (R BlasPlan), info, step_first, step_prefix, tri_pos,
// bvh_min, bvh_max. ints: R, K, nodes in the pool, the most rows of a step.
extern "C" int voidin_blas_refit(const void* const* ptrs,
                                 const long long* ints, void* stream) {
  BlasArgs a;
  a.plans = (const BlasPlan*)ptrs[0];
  a.info = (const int*)ptrs[1];
  a.step_first = (const int*)ptrs[2];
  a.step_prefix = (const int*)ptrs[3];
  a.tri_pos = (const float*)ptrs[4];
  a.bmin = (float*)ptrs[5];
  a.bmax = (float*)ptrs[6];
  a.n_plans = (int)ints[0];
  a.n_steps = (int)ints[1];
  a.n_nodes = (int)ints[2];
  return launch_levels(blas_refit_kernel, blas_resident, a, ints[3], stream);
}

// ptrs: order, child, instance, levels, mesh_min, mesh_max, mesh_id,
// transform, tlas_min, tlas_max. ints: levels, the most rows of a level.
extern "C" int voidin_tlas_refit(const void* const* ptrs,
                                 const long long* ints, void* stream) {
  TlasArgs a;
  a.order = (const int*)ptrs[0];
  a.child = (const int*)ptrs[1];
  a.instance = (const int*)ptrs[2];
  a.levels = (const int*)ptrs[3];
  a.mesh_min = (const float*)ptrs[4];
  a.mesh_max = (const float*)ptrs[5];
  a.mesh_id = (const int*)ptrs[6];
  a.transform = (const float*)ptrs[7];
  a.bmin = (float*)ptrs[8];
  a.bmax = (float*)ptrs[9];
  a.n_levels = (int)ints[0];
  return launch_levels(tlas_refit_kernel, tlas_resident, a, ints[1], stream);
}
