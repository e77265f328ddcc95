// Flow-stack backward for Hopper (sm_90a): the gradient of the flow-stack
// forward (flow_stack.cu) with respect to z0 and every per-point flow
// parameter.  One warp per point, one lane per draw, 8 warps a CTA.
//
// Replaces: cfnerf_tpu/ops/pallas/flow_stack.py:_bwd_kernel (launched by
// _fused_bwd, the custom VJP of fused_flow_stack), in both modes
// (compute_log_det = 0: the log-det cotangent is ignored, as there).
//
// What it computes, per point p and draw k, from the cotangents g_z (B,K,Z)
// and g_ldj (B,K), the chain's steps in reverse (flow_stack.py:142-205):
//   g_u = P g_z;  g_t_i = sum_{i'<=i} r1[i',i] g_u_i' [+ log-det terms];
//   g_pre = g_t (1 - t^2);  g_b = g_pre;  g_r1[i,j] += g_u_i t_j;
//   g_r2[i,j] += g_pre_i zp_j;  g_z += P^T (R2^T g_pre)
// g_z0 (B, K, Z) is each draw's own gradient, as _fused_bwd returns it (the
// caller's expand sums it over the points).  The per-point parameter
// gradients are sums over the K draws; their lower triangles are zero.
// With `members` M > 1 (the member axis of flow_stack.cu) point p reads z0
// from member p / (B / M)'s (K, Z) block; g_z0 stays per point, so the
// caller sums each member's block as a launch of that member alone would
// be summed.
//
// What bounds it on an H100.  By chip_smoke.py's bound, bytes: at the
// hierarchical training fine pass (640 rays x 192 samples, K=32, rgb chain)
// it reads the parameters and the cotangents and writes g_z0 and the
// parameter gradients, ~190 MB, ~0.06 ms at 3.35 TB/s, against ~2.4 GFLOP,
// ~0.035 ms at 67 TFLOP/s (chip_smoke.py:flow_stack_bwd_work counts both).
// The card issues more than either: the earlier design took ~2,000 warp
// instructions a point (its recompute of each step's input from z0, and
// 15 butterfly sums of 5 shuffles a step, each added by one lane), ~0.25 ms
// of issue at the fine pass.
//
// What the design does about it:
//   * F = 4 is compile-time: one forward sweep keeps each step's input and
//     tanh in registers (4 step evaluations a draw, not 10), the point's
//     parameters staged once into the warp's shared memory and read back a
//     step at a time as broadcasts (80 registers: three CTAs, 24 warps, an
//     SM; capped at 64 they spill and run slower).
//   * The per-point sums over the draws, for all steps at once: each lane
//     writes its 60 (rgb) or 12 (density) per-draw gradients to its row of
//     a shared-memory table padded to an odd stride, then lane j sums
//     columns j and j + 32 over the 32 rows in a fixed order; lane groups
//     (K > 32) add to a lane's running sums in order.  The sums are written
//     once, with the lower triangles' zeros.  No shuffles, no atomics: two
//     launches give the same bits.
//   * Any other F takes the generic path: each step's input recomputed from
//     z0 (O(F^2) step evaluations a draw), parameters read a step at a time
//     from device memory, and a table of one step's 15 (or 3) gradients,
//     summed and stored (lane groups adding in order) before the step
//     below.  Its shared memory does not grow with F.
// Math is f32 throughout with the accurate libm functions: no fast-math,
// no approximate intrinsic.

#include "flow_stack.cuh"

namespace {

constexpr int kWarps = 8;  // points a CTA, one a warp
constexpr int kThreads = kWarps * 32;

template <int Z>
struct Grads {
  static constexpr int kUpper = Z * (Z + 1) / 2;    // upper-triangle elements
  static constexpr int kStep = 2 * kUpper + Z;      // a step's per-point gradients
  static constexpr int kTrace = 4 * kStep;          // all four steps (F = 4)
  static constexpr int kStride = kTrace | 1;        // odd: rows on distinct banks
  static constexpr int kStepStride = kStep | 1;
  static constexpr int kParams = (2 * Z * Z + Z) * 4;  // a point's parameters, F = 4
};

// Element (i, j) of a Z x Z block, linear index i*Z + j, for the u-th upper
// element (row major) and the u-th lower one.
template <int Z>
__device__ __forceinline__ int upper_elem(int u) {
  return Z == 1 ? 0 : u + (u >= 3) + 2 * (u >= 5);
}
__device__ __forceinline__ int lower_elem3(int u) { return 3 + 3 * (u >= 1) + (u >= 2); }

__device__ __forceinline__ float sign_f(float x) {  // jnp.sign: sign(0) = 0
  return (float)((x > 0.f) - (x < 0.f));
}

// Where column `idx` of step f's gradients goes for point p: r1's upper
// elements, r2's, then b's rows.
template <int Z>
__device__ __forceinline__ float* grad_slot(int idx, int f, int F, long long p,
                                            float* g_r1, float* g_r2, float* g_b) {
  constexpr int U = Grads<Z>::kUpper;
  if (idx < U) return g_r1 + p * (Z * Z * F) + upper_elem<Z>(idx) * F + f;
  if (idx < 2 * U) return g_r2 + p * (Z * Z * F) + upper_elem<Z>(idx - U) * F + f;
  return g_b + p * (Z * F) + (idx - 2 * U) * F + f;
}

// Step f in reverse for one draw.  z is the step's input, t its tanh; gz
// holds the cotangent of the step's output on entry and of its input on
// return.  The step's per-point gradients for this draw go to row[0, kStep):
// r1's upper triangle, r2's, then g_b.
template <int Z>
__device__ __forceinline__ void step_bwd(const Step<Z>& s, int f, const float* z,
                                         const float* t, float* gz, float gl, bool cld,
                                         float* row) {
  constexpr int U = Grads<Z>::kUpper;
  float zp[Z], gu[Z], gt[Z], gzp[Z], gp[Z];
  float g1[Z][Z], g2[Z][Z];  // upper triangles used
#pragma unroll
  for (int i = 0; i < Z; ++i) {
    zp[i] = flipped<Z>(z, i, f);
    gu[i] = flipped<Z>(gz, i, f);
    gt[i] = 0.f;
    gzp[i] = 0.f;
#pragma unroll
    for (int j = 0; j < Z; ++j) g1[i][j] = g2[i][j] = 0.f;
  }
  if (cld) {  // log-det terms
#pragma unroll
    for (int i = 0; i < Z; ++i) {
      const float a = s.a[i][i], c = s.c[i][i];
      const float der = 1.f - t[i] * t[i];
      const float rr = a * c;
      const float dj = der * rr + 1.f;
      const float cc = gl * sign_f(dj) / (fabsf(dj) + kLogdetEps);
      gt[i] = cc * (-2.f * t[i]) * rr;
      g1[i][i] = cc * der * c;
      g2[i][i] = cc * der * a;
    }
  }
  // u_i = sum_{j >= i} r1[i,j] t_j
#pragma unroll
  for (int i = 0; i < Z; ++i) {
#pragma unroll
    for (int j = i; j < Z; ++j) {
      g1[i][j] = g1[i][j] + gu[i] * t[j];
      gt[j] = gt[j] + s.a[i][j] * gu[i];
    }
  }
  // t_i = tanh(pre_i), pre_i = b_i + sum_{j >= i} r2[i,j] zp_j
#pragma unroll
  for (int i = 0; i < Z; ++i) {
    gp[i] = gt[i] * (1.f - t[i] * t[i]);
#pragma unroll
    for (int j = i; j < Z; ++j) {
      g2[i][j] = g2[i][j] + gp[i] * zp[j];
      gzp[j] = gzp[j] + s.c[i][j] * gp[i];
    }
  }
  // zp_j is z_{P(j)}: back through the flip into the identity path
#pragma unroll
  for (int j = 0; j < Z; ++j) add_flipped<Z>(gz, j, f, gzp[j]);
  int u = 0;
#pragma unroll
  for (int i = 0; i < Z; ++i) {
#pragma unroll
    for (int j = i; j < Z; ++j, ++u) {
      row[u] = g1[i][j];
      row[U + u] = g2[i][j];
    }
    row[2 * U + i] = gp[i];
  }
}

// Column c of a warp's table (32 rows, `stride` floats apart) summed in a
// fixed order: four interleaved partial sums, then a tree.
__device__ __forceinline__ float column_sum(const float* table, int stride, int c) {
  float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll
  for (int r = 0; r < 32; r += 4) {
    s0 += table[(r + 0) * stride + c];
    s1 += table[(r + 1) * stride + c];
    s2 += table[(r + 2) * stride + c];
    s3 += table[(r + 3) * stride + c];
  }
  return (s0 + s1) + (s2 + s3);
}

inline size_t bwd_smem_floats(int Z, bool trace) {
  const int per_warp = Z == 1 ? (trace ? Grads<1>::kParams + 32 * Grads<1>::kStride
                                       : 32 * Grads<1>::kStepStride)
                              : (trace ? Grads<3>::kParams + 32 * Grads<3>::kStride
                                       : 32 * Grads<3>::kStepStride);
  return (size_t)kWarps * per_warp;
}

template <int Z, bool TRACE>
__global__ void __launch_bounds__(kThreads, 3)
flow_stack_bwd_kernel(const float* __restrict__ z0, long long z0_stride,
                      int per_member,
                      const float* __restrict__ r1,
                      const float* __restrict__ r2,
                      const float* __restrict__ b,
                      const float* __restrict__ g_z,
                      const float* __restrict__ g_ldj,
                      float* __restrict__ g_z0,
                      float* __restrict__ g_r1,
                      float* __restrict__ g_r2,
                      float* __restrict__ g_b,
                      int B, int K, int F_rt, int compute_log_det) {
  using G = Grads<Z>;
  constexpr int ZZ = Z * Z;
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long p = (long long)blockIdx.x * kWarps + warp;
  if (p >= B) return;  // whole warp leaves together; no block barrier below
  const int F = TRACE ? 4 : F_rt;
  const bool cld = compute_log_det != 0;
  float* wsm = smem + (size_t)warp * (TRACE ? G::kParams + 32 * G::kStride
                                           : 32 * G::kStepStride);
  float* prm = wsm;  // the point's r1 | r2 | b (F = 4)
  float* table = TRACE ? wsm + G::kParams : wsm;
  float* row = table + lane * (TRACE ? G::kStride : G::kStepStride);

  const float* q1 = r1 + p * ZZ * F;
  const float* q2 = r2 + p * ZZ * F;
  const float* qb = b + p * Z * F;
  // per_member is 0 without a member axis (uniform)
  const long long z0_off =
      per_member ? (long long)((int)p / per_member) * (K * Z) : p * z0_stride;
  if constexpr (TRACE) {
    stage(prm, q1, ZZ * 4, lane);
    stage(prm + ZZ * 4, q2, ZZ * 4, lane);
    stage(prm + 2 * ZZ * 4, qb, Z * 4, lane);
    __syncwarp();
  }
  float acc[(G::kTrace + 31) / 32];  // this lane's running column sums (F = 4)
#pragma unroll
  for (int j = 0; j < (G::kTrace + 31) / 32; ++j) acc[j] = 0.f;

  for (int kb = 0; kb < K; kb += 32) {
    const int k = kb + lane;
    const bool active = k < K;
    const float* src = z0 + z0_off + (long long)(active ? k : 0) * Z;
    const long long pk = p * K + k;
    float x0[Z], gz[Z];
    // cotangents of this (point, draw); zero on idle lanes, so every
    // gradient they compute is zero
#pragma unroll
    for (int c = 0; c < Z; ++c) {
      x0[c] = src[c];
      gz[c] = active ? g_z[pk * Z + c] : 0.f;
    }
    const float gl = (active && cld) ? g_ldj[pk] : 0.f;

    if constexpr (TRACE) {
      // one forward sweep: each step's input and tanh kept
      float xs[4][Z], ts[4][Z], z[Z];
#pragma unroll
      for (int c = 0; c < Z; ++c) z[c] = x0[c];
#pragma unroll
      for (int f = 0; f < 4; ++f) {
#pragma unroll
        for (int c = 0; c < Z; ++c) xs[f][c] = z[c];
        step_fwd<Z>(load_step<Z>(prm, prm + ZZ * 4, prm + 2 * ZZ * 4, f, 4), f, z, ts[f]);
      }
#pragma unroll
      for (int f = 3; f >= 0; --f) {
        const Step<Z> s = load_step<Z>(prm, prm + ZZ * 4, prm + 2 * ZZ * 4, f, 4);
        step_bwd<Z>(s, f, xs[f], ts[f], gz, gl, cld, row + f * G::kStep);
      }
      __syncwarp();
#pragma unroll
      for (int j = 0; j < (G::kTrace + 31) / 32; ++j) {
        const int c = lane + 32 * j;
        if (c < G::kTrace) acc[j] += column_sum(table, G::kStride, c);
      }
      __syncwarp();  // the table is read before the next lane group writes
    } else {
      const bool first = kb == 0;
      for (int f = F - 1; f >= 0; --f) {
        float z[Z], t[Z];
#pragma unroll
        for (int c = 0; c < Z; ++c) z[c] = x0[c];
        for (int h = 0; h < f; ++h) step_fwd<Z>(load_step<Z>(q1, q2, qb, h, F), h, z, t);
        const Step<Z> s = load_step<Z>(q1, q2, qb, f, F);
        float y[Z];
#pragma unroll
        for (int c = 0; c < Z; ++c) y[c] = z[c];
        step_fwd<Z>(s, f, y, t);  // step f's tanh
        step_bwd<Z>(s, f, z, t, gz, gl, cld, row);
        __syncwarp();
        if (lane < G::kStep) {
          const float v = column_sum(table, G::kStepStride, lane);
          float* dst = grad_slot<Z>(lane, f, F, p, g_r1, g_r2, g_b);
          *dst = first ? v : *dst + v;
        } else if (Z == 3 && first && lane < G::kStep + 6) {  // the lower triangles
          const int u = lane - G::kStep;
          float* base = u < 3 ? g_r1 : g_r2;
          base[p * ZZ * F + lower_elem3(u % 3) * F + f] = 0.f;
        }
        __syncwarp();
      }
    }
    if (active) {
#pragma unroll
      for (int c = 0; c < Z; ++c) g_z0[pk * Z + c] = gz[c];
    }
  }

  if constexpr (TRACE) {
    // the sums, and the lower triangles' zeros: step f's column idx is
    // f * kStep + idx
#pragma unroll
    for (int j = 0; j < (G::kTrace + 31) / 32; ++j) {
      const int c = lane + 32 * j;
      if (c < G::kTrace) {
        *grad_slot<Z>(c % G::kStep, c / G::kStep, 4, p, g_r1, g_r2, g_b) = acc[j];
      }
    }
    if (Z == 3 && lane < 24) {  // 2 matrices x 3 lower elements x 4 steps
      float* base = lane < 12 ? g_r1 : g_r2;
      const int u = lane % 12;
      base[p * ZZ * 4 + lower_elem3(u / 4) * 4 + u % 4] = 0.f;
    }
  }
}

template <int Z, bool TRACE>
cudaError_t launch_bwd(cudaStream_t st, const float* z0, int z0_stride, int per_member,
                       const float* r1, const float* r2, const float* b, const float* g_z,
                       const float* g_ldj, float* g_z0, float* g_r1, float* g_r2,
                       float* g_b, int B, int K, int F, int compute_log_det) {
  auto kern = flow_stack_bwd_kernel<Z, TRACE>;
  const size_t smem = bwd_smem_floats(Z, TRACE) * sizeof(float);
  const cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const unsigned grid = (unsigned)((B + kWarps - 1) / kWarps);
  kern<<<grid, kThreads, smem, st>>>(z0, z0_stride, per_member, r1, r2, b, g_z, g_ldj,
                                     g_z0, g_r1, g_r2, g_b, B, K, F, compute_log_det);
  return cudaGetLastError();
}

}  // namespace

// C entry point (bound with ctypes).  Pointers are device pointers to f32
// arrays: z0 read through `z0_stride` floats per point (its (K, Z) block
// contiguous), or with `members` M > 1 a contiguous (M, K, Z) block a
// member (z0_stride 0; B a multiple of M, the points member-major); r1, r2 (B, Z, Z, F), b (B, Z, F), g_z (B, K, Z), g_ldj
// (B, K) and the outputs g_z0 (B, K, Z), g_r1, g_r2 (B, Z, Z, F), g_b
// (B, Z, F) contiguous; the caller checks shapes.  F = 4 takes the kernel
// that keeps each step's input, any other F the generic one.  Launches on `stream` and returns
// cudaGetLastError() (0 on success); it never synchronises.
extern "C" int flow_stack_bwd(const float* z0, int z0_stride, const float* r1,
                              const float* r2, const float* b, const float* g_z,
                              const float* g_ldj, float* g_z0, float* g_r1,
                              float* g_r2, float* g_b, int B, int K, int Z,
                              int F, int compute_log_det, int members, void* stream) {
  if (B < 0 || K < 1 || F < 1 || z0_stride < 0 || (Z != 1 && Z != 3) || members < 1 ||
      B % members != 0 || (members > 1 && z0_stride != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  if (B == 0) return 0;
  const int per_member = members > 1 ? B / members : 0;
  const bool trace = F == 4;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto launch = Z == 1 ? (trace ? &launch_bwd<1, true> : &launch_bwd<1, false>)
                             : (trace ? &launch_bwd<3, true> : &launch_bwd<3, false>);
  return (int)launch(st, z0, z0_stride, per_member, r1, r2, b, g_z, g_ldj, g_z0, g_r1,
                     g_r2, g_b, B, K, F, compute_log_det);
}
