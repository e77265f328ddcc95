// Flow-stack backward for Hopper (sm_90a): the gradient of the flow-stack
// forward (flow_stack.cu) with respect to z0 and every per-point flow
// parameter.  One warp per point, one lane per draw.
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
//
// What bounds it on an H100: bytes.  At the hierarchical training fine pass
// (640 rays x 192 samples, K=32, rgb chain) it reads the parameters and the
// cotangents and writes g_z0 and the parameter gradients, ~190 MB, ~0.06 ms
// at 3.35 TB/s, against ~2.4 GFLOP, ~0.035 ms at 67 TFLOP/s
// (chip_smoke.py:flow_stack_bwd_work counts both).
//
// What the design does about it, simply and not yet fast:
//   * A warp owns a point, lane k owns draw k (lane groups of 32 when
//     K > 32, idle lanes with zero cotangents when K < 32).  Every lane reads
//     the point's parameters: one broadcast load per warp.
//   * F is a runtime value, so step f's input z_f is recomputed from z0
//     (O(F^2) step evaluations per draw, 10 for 4 at F=4) instead of kept in
//     a register trace with a compile-time bound on F.  The kernel is bound
//     by bytes, so the extra arithmetic is cheap, and the backward takes every
//     F the forward takes.  The recompute uses the forward's own step
//     functions (flow_stack.cuh), so it reproduces the forward's values.
//   * The per-point gradients are fixed-order butterfly warp sums over the
//     draws; lane 0 adds each into a per-warp accumulator in shared memory,
//     lane groups in order (K > 32).  The accumulator starts at zero, so the
//     lower triangles come out zero, and the warp writes it out once, with
//     coalesced stores.  No atomics: two launches give the same bits.
// Faster work (fewer shuffles, a register trace, several points per warp at
// small K) is later work.

#include "flow_stack.cuh"

namespace {

__device__ __forceinline__ float warp_sum(float v) {
  // butterfly: every lane ends with the same bits (a + b == b + a)
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// The draws' sum of a per-point gradient, added by lane 0 to its slot.
__device__ __forceinline__ void add_sum(float* slot, float v, int lane) {
  v = warp_sum(v);
  if (lane == 0) *slot += v;
}

__device__ __forceinline__ float sign_f(float x) {  // jnp.sign: sign(0) = 0
  return (float)((x > 0.f) - (x < 0.f));
}

// Step f in reverse for one draw.  z is the step's input z_f, t its tanh;
// gz holds the cotangent of the step's output on entry and of its input on
// return.  The step's parameter gradients are summed over the warp's draws
// into s1 / s2 / sb, the warp's (Z, Z, F) / (Z, Z, F) / (Z, F) accumulators.
template <int Z>
__device__ __forceinline__ void step_bwd(const float* z, const float* t, float* gz,
                                         float gl, bool cld, const float* q1,
                                         const float* q2, int f, int F,
                                         float* s1, float* s2, float* sb,
                                         int lane) {
  const bool flip = (f & 1) != 0;
  float zp[Z], gu[Z], gt[Z], gzp[Z], gp[Z];
  float g1[Z][Z], g2[Z][Z];  // upper triangles used
#pragma unroll
  for (int i = 0; i < Z; ++i) {
    const int pi = flip ? Z - 1 - i : i;
    zp[i] = z[pi];
    gu[i] = gz[pi];
    gt[i] = 0.f;
    gzp[i] = 0.f;
#pragma unroll
    for (int j = 0; j < Z; ++j) g1[i][j] = g2[i][j] = 0.f;
  }
  if (cld) {  // log-det terms
#pragma unroll
    for (int i = 0; i < Z; ++i) {
      const int d = (i * Z + i) * F + f;
      const float a = q1[d], c = q2[d];
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
      gt[j] = gt[j] + q1[(i * Z + j) * F + f] * gu[i];
    }
  }
  // t_i = tanh(pre_i), pre_i = b_i + sum_{j >= i} r2[i,j] zp_j
#pragma unroll
  for (int i = 0; i < Z; ++i) {
    gp[i] = gt[i] * (1.f - t[i] * t[i]);
#pragma unroll
    for (int j = i; j < Z; ++j) {
      g2[i][j] = g2[i][j] + gp[i] * zp[j];
      gzp[j] = gzp[j] + q2[(i * Z + j) * F + f] * gp[i];
    }
  }
  // zp_j is z_{P(j)}: back through the flip into the identity path
#pragma unroll
  for (int j = 0; j < Z; ++j) {
    const int pj = flip ? Z - 1 - j : j;
    gz[pj] = gz[pj] + gzp[j];
  }
  // sums over the draws
#pragma unroll
  for (int i = 0; i < Z; ++i) {
#pragma unroll
    for (int j = i; j < Z; ++j) {
      add_sum(s1 + (i * Z + j) * F + f, g1[i][j], lane);
      add_sum(s2 + (i * Z + j) * F + f, g2[i][j], lane);
    }
    add_sum(sb + i * F + f, gp[i], lane);
  }
}

template <int Z>
__global__ void __launch_bounds__(kBwdWarps * 32)
flow_stack_bwd_kernel(const float* __restrict__ z0, long long z0_stride,
                      const float* __restrict__ r1,
                      const float* __restrict__ r2,
                      const float* __restrict__ b,
                      const float* __restrict__ g_z,
                      const float* __restrict__ g_ldj,
                      float* __restrict__ g_z0,
                      float* __restrict__ g_r1,
                      float* __restrict__ g_r2,
                      float* __restrict__ g_b,
                      int B, int K, int F, int compute_log_det) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long p = (long long)blockIdx.x * kBwdWarps + warp;
  if (p >= B) return;  // whole warp leaves together; no block barrier below

  const int nR = Z * Z * F, nB = Z * F;
  float* s1 = smem + (size_t)warp * (2 * nR + nB);  // this warp's accumulators
  float* s2 = s1 + nR;
  float* sb = s2 + nR;
  for (int i = lane; i < 2 * nR + nB; i += 32) s1[i] = 0.f;
  __syncwarp();

  const float* q1 = r1 + p * nR;
  const float* q2 = r2 + p * nR;
  const float* qb = b + p * nB;
  const bool cld = compute_log_det != 0;

  for (int kb = 0; kb < K; kb += 32) {
    const int k = kb + lane;
    const bool active = k < K;
    const float* src = z0 + p * z0_stride + (long long)(active ? k : 0) * Z;
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

    for (int f = F - 1; f >= 0; --f) {
      float z[Z], y[Z], t[Z];
#pragma unroll
      for (int c = 0; c < Z; ++c) z[c] = x0[c];
      for (int h = 0; h < f; ++h) FlowStep<Z>::run(z, t, q1, q2, qb, h, F);  // z_f
#pragma unroll
      for (int c = 0; c < Z; ++c) y[c] = z[c];
      FlowStep<Z>::run(y, t, q1, q2, qb, f, F);  // step f's tanh
      step_bwd<Z>(z, t, gz, gl, cld, q1, q2, f, F, s1, s2, sb, lane);
    }
    if (active) {
#pragma unroll
      for (int c = 0; c < Z; ++c) g_z0[pk * Z + c] = gz[c];
    }
  }

  __syncwarp();  // lane 0's accumulator writes are visible to the warp
  for (int i = lane; i < nR; i += 32) {
    g_r1[p * nR + i] = s1[i];
    g_r2[p * nR + i] = s2[i];
  }
  for (int i = lane; i < nB; i += 32) g_b[p * nB + i] = sb[i];
}

}  // namespace

// C entry point (bound with ctypes).  Pointers are device pointers to f32
// arrays: z0 read through `z0_stride` floats per point (its (K, Z) block
// contiguous); r1, r2 (B, Z, Z, F), b (B, Z, F), g_z (B, K, Z), g_ldj
// (B, K) and the outputs g_z0 (B, K, Z), g_r1, g_r2 (B, Z, Z, F), g_b
// (B, Z, F) contiguous; the caller checks shapes.  Launches on `stream` and
// returns cudaGetLastError() (0 on success); it never synchronises.
extern "C" int flow_stack_bwd(const float* z0, int z0_stride, const float* r1,
                              const float* r2, const float* b, const float* g_z,
                              const float* g_ldj, float* g_z0, float* g_r1,
                              float* g_r2, float* g_b, int B, int K, int Z,
                              int F, int compute_log_det, void* stream) {
  if (B < 0 || K < 1 || F < 1 || z0_stride < 0 || (Z != 1 && Z != 3)) {
    return (int)cudaErrorInvalidValue;
  }
  if (B == 0) return 0;
  const size_t smem = (size_t)kBwdWarps * (2 * Z * Z * F + Z * F) * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;  // F too large
  const dim3 grid((unsigned)((B + kBwdWarps - 1) / kBwdWarps));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Z == 1) {
    flow_stack_bwd_kernel<1><<<grid, kBwdWarps * 32, smem, st>>>(
        z0, z0_stride, r1, r2, b, g_z, g_ldj, g_z0, g_r1, g_r2, g_b, B, K, F,
        compute_log_det);
  } else {
    flow_stack_bwd_kernel<3><<<grid, kBwdWarps * 32, smem, st>>>(
        z0, z0_stride, r1, r2, b, g_z, g_ldj, g_z0, g_r1, g_r2, g_b, B, K, F,
        compute_log_det);
  }
  return (int)cudaGetLastError();
}
