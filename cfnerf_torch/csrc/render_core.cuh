// Shared by the render-core forward (render_core.cu) and backward
// (render_core_bwd.cu): constants, the scalar activations, the per-warp
// staging load and one step of each triangular-Sylvester chain.  Both
// kernels compute the forward with these same functions, so the backward
// recomputes exactly the values the forward produced.
#pragma once

#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kMaxChunk = 32;                 // points staged per warp per pass
constexpr int kSmemBudget = 48 * 1024;        // bytes per block, static limit
constexpr float kTransEps = 1e-10f;           // reference (1 - alpha + 1e-10)
constexpr float kLogdetEps = 1e-8f;           // reference flows.py:255

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

// Points staged per warp so that kWarpsPerBlock warps fit kSmemBudget;
// 0 when F is too large to stage one point.
inline int staging_chunk(int S, int F) {
  const int per_point = (24 * F + 2) * (int)sizeof(float);
  const int chunk = kSmemBudget / (kWarpsPerBlock * per_point);
  return chunk < 1 ? 0 : min(chunk, min(kMaxChunk, S));
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
