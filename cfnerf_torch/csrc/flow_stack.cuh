// Shared by the flow-stack forward (flow_stack.cu) and backward
// (flow_stack_bwd.cu): one triangular-Sylvester step of a Z-dimensional
// chain on one draw, built from the render core's step functions
// (render_core.cuh), so that the backward recomputes exactly the values the
// forward produced, and the flip permutation lives in one place.
#pragma once

#include "render_core.cuh"

namespace {

constexpr int kFwdThreads = 256;  // forward: one thread per (point, draw)
constexpr int kBwdWarps = 4;      // backward: one warp per point

// Step f of the chain: t = tanh(b + R2 P z), z <- z + P^T R1 t, with P the
// flip on odd steps.  q1 / q2 point at the point's (Z, Z, F) parameters,
// qb at its (Z, F) biases; element (i, j, f) is at (i*Z + j)*F + f.
template <int Z>
struct FlowStep;

template <>
struct FlowStep<1> {  // the density chain: the flip is the identity
  __device__ __forceinline__ static void run(float* z, float* t, const float* q1,
                                             const float* q2, const float* qb,
                                             int f, int F) {
    t[0] = density_step(z[0], q1, q2, qb, f);
  }
};

template <>
struct FlowStep<3> {  // the rgb chain
  __device__ __forceinline__ static void run(float* z, float* t, const float* q1,
                                             const float* q2, const float* qb,
                                             int f, int F) {
    rgb_tanh(q2, qb, f, F, z[0], z[1], z[2], t[0], t[1], t[2]);
    rgb_update(q1, f, F, t[0], t[1], t[2], z[0], z[1], z[2]);
  }
};

// log|det J| of step f: sum_i log(|1 + (1 - t_i^2) r1_ii r2_ii| + 1e-8),
// summed over i in order, as the plain version does.
template <int Z>
__device__ __forceinline__ float step_logdet(const float* t, const float* q1,
                                             const float* q2, int f, int F) {
  float ld = 0.f;
#pragma unroll
  for (int i = 0; i < Z; ++i) {
    const int d = (i * Z + i) * F + f;
    ld += logdet_term(t[i], q1[d], q2[d]);
  }
  return ld;
}

}  // namespace
