// Shared by the render-core forward (render_core.cu) and backward
// (render_core_bwd.cu): constants, the cut of a ray into segments, the
// scalar activations, the per-warp staging loads (synchronous and by
// cp.async) and one step of each triangular-Sylvester chain.  Both kernels
// compute the forward with these same functions, so the backward
// recomputes exactly the values the forward produced.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kTransEps = 1e-10f;           // reference (1 - alpha + 1e-10)
constexpr float kLogdetEps = 1e-8f;           // reference flows.py:255
constexpr int kSegWarps = 8;                  // segments of a ray at once: a CTA's warps
constexpr int kSegThreads = kSegWarps * 32;
constexpr int kMaxSeg = 16;                   // samples of a segment in one round
constexpr int kMaxDynSmem = 227 * 1024;       // dynamic shared memory a CTA may ask

// The cut of a ray of S samples: rounds of kSegWarps contiguous segments of
// `seg` samples (the last ones shorter or empty), rounds of at most
// kSegWarps * kMaxSeg samples, split evenly.  Warp w's segment in round r
// starts at r * kSegWarps * seg + w * seg.  (render_core.py:kernel_segments
// mirrors it for the tests.)
struct SegPlan {
  int rounds, seg;
};

inline SegPlan seg_plan(int S) {
  const int rounds = (S + kSegWarps * kMaxSeg - 1) / (kSegWarps * kMaxSeg);
  const int per_round = (S + rounds - 1) / rounds;
  return {rounds, (per_round + kSegWarps - 1) / kSegWarps};
}

__device__ __forceinline__ float softplus_f(float x) {
  // max(x, 0) + log1p(exp(-|x|)) == jax.nn.softplus
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ float sigmoid_f(float x) {
  return 1.f / (1.f + expf(-x));
}

__device__ __forceinline__ float logdet_term(float t, float r1ii, float r2ii) {
  const float dj = (1.f - t * t) * (r1ii * r2ii) + 1.f;
  return logf(fabsf(dj) + kLogdetEps);
}

__device__ __forceinline__ void stage(float* dst, const float* __restrict__ src,
                                      int n, int lane) {
  for (int i = lane; i < n; i += 32) dst[i] = __ldg(src + i);
}

// The same copy, asynchronous: each lane's cp.async joins its current group.
// 16 bytes a lane where src is 16-byte aligned and n a multiple of 4 (dst
// always is), else 4.  Visible to the warp after cp_async_wait + __syncwarp.
__device__ __forceinline__ void stage_async(float* dst, const float* src, int n,
                                            int lane) {
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0 && (n & 3) == 0) {
    for (int i = 4 * lane; i < n; i += 128) {
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                       static_cast<uint32_t>(__cvta_generic_to_shared(dst + i))),
                   "l"(src + i)
                   : "memory");
    }
  } else {
    for (int i = lane; i < n; i += 32) {
      asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                       static_cast<uint32_t>(__cvta_generic_to_shared(dst + i))),
                   "l"(src + i)
                   : "memory");
    }
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>  // wait until at most N of this thread's groups are pending
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Density chain (Z = 1, the flip is the identity), step f:
//   z <- z + r1 tanh(b + r2 z).  Returns the tanh.
__device__ __forceinline__ float density_step(float& z, const float* q1,
                                              const float* q2, const float* qb,
                                              int f) {
  const float t = tanhf(qb[f] + q2[f] * z);
  z = z + q1[f] * t;
  return t;
}

// rgb chain (Z = 3), step f: the three tanh of pre = b + R2 P z, with P the
// flip on odd steps.  Rows are r[(i*3+j)*F + f], b[i*F + f].
__device__ __forceinline__ void rgb_tanh(const float* q2, const float* qb, int f,
                                         int F, float z0, float z1, float z2,
                                         float& t0, float& t1, float& t2) {
  const bool flip = (f & 1) != 0;
  const float p0v = flip ? z2 : z0;  // permuted view zp
  const float p1v = z1;
  const float p2v = flip ? z0 : z2;
  float pre0 = qb[0 * F + f];
  pre0 = pre0 + q2[0 * F + f] * p0v;
  pre0 = pre0 + q2[1 * F + f] * p1v;
  pre0 = pre0 + q2[2 * F + f] * p2v;
  float pre1 = qb[1 * F + f];
  pre1 = pre1 + q2[4 * F + f] * p1v;
  pre1 = pre1 + q2[5 * F + f] * p2v;
  const float pre2 = qb[2 * F + f] + q2[8 * F + f] * p2v;
  t0 = tanhf(pre0);
  t1 = tanhf(pre1);
  t2 = tanhf(pre2);
}

// rgb chain, step f: z <- z + P^T R1 t.  The update is in permuted
// coordinates: row i lands on P(i).
__device__ __forceinline__ void rgb_update(const float* q1, int f, int F,
                                           float t0, float t1, float t2,
                                           float& z0, float& z1, float& z2) {
  float u0 = q1[0 * F + f] * t0;
  u0 = u0 + q1[1 * F + f] * t1;
  u0 = u0 + q1[2 * F + f] * t2;
  float u1 = q1[4 * F + f] * t1;
  u1 = u1 + q1[5 * F + f] * t2;
  const float u2 = q1[8 * F + f] * t2;
  if ((f & 1) != 0) {
    z2 = z2 + u0; z1 = z1 + u1; z0 = z0 + u2;
  } else {
    z0 = z0 + u0; z1 = z1 + u1; z2 = z2 + u2;
  }
}

}  // namespace
