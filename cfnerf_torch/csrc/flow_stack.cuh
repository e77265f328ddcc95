// Shared by the flow-stack forward (flow_stack.cu) and backward
// (flow_stack_bwd.cu): one triangular-Sylvester step of a Z-dimensional
// chain on one draw, its parameters held in registers, and the flip
// permutation in one place.  Both kernels evaluate a step with these
// functions, so the backward recomputes exactly the values the forward
// produced; the arithmetic is in the order of the render core's step
// functions (render_core.cuh) and of the plain version.
#pragma once

#include "render_core.cuh"

namespace {

// Step f of a chain: t = tanh(b + R2 P z), z <- z + P^T R1 t, with P the
// flip on odd steps.  The point's parameters are (Z, Z, F) / (Z, Z, F) /
// (Z, F) arrays, element (i, j, f) at (i*Z + j)*F + f; only the upper
// triangles (j >= i) are read.
template <int Z>
struct Step {
  float a[Z][Z], c[Z][Z], b[Z];  // r1, r2 (upper triangles) and b of one step
};

template <int Z>
__device__ __forceinline__ Step<Z> load_step(const float* q1, const float* q2,
                                             const float* qb, int f, int F) {
  Step<Z> s;
#pragma unroll
  for (int i = 0; i < Z; ++i) {
#pragma unroll
    for (int j = i; j < Z; ++j) {
      s.a[i][j] = q1[(i * Z + j) * F + f];
      s.c[i][j] = q2[(i * Z + j) * F + f];
    }
    s.b[i] = qb[i * F + f];
  }
  return s;
}

// x[P(i)] for the flip P of step f, as a select between two fixed indices
// (a runtime f never indexes the register array: it would go to local
// memory).
template <int Z>
__device__ __forceinline__ float flipped(const float* x, int i, int f) {
  return (f & 1) ? x[Z - 1 - i] : x[i];
}

// x[P(i)] += v.
template <int Z>
__device__ __forceinline__ void add_flipped(float* x, int i, int f, float v) {
  if (f & 1) {
    x[Z - 1 - i] = x[Z - 1 - i] + v;
  } else {
    x[i] = x[i] + v;
  }
}

// One step forward: the tanh into t, z updated in place.  The sums run in
// the order of render_core.cuh's rgb_tanh / rgb_update (density_step at
// Z = 1).
template <int Z>
__device__ __forceinline__ void step_fwd(const Step<Z>& s, int f, float* z, float* t) {
  float zp[Z];
#pragma unroll
  for (int i = 0; i < Z; ++i) zp[i] = flipped<Z>(z, i, f);
#pragma unroll
  for (int i = 0; i < Z; ++i) {
    float pre = s.b[i];
#pragma unroll
    for (int j = i; j < Z; ++j) pre = pre + s.c[i][j] * zp[j];
    t[i] = tanhf(pre);
  }
#pragma unroll
  for (int i = 0; i < Z; ++i) {
    float u = s.a[i][i] * t[i];
#pragma unroll
    for (int j = i + 1; j < Z; ++j) u = u + s.a[i][j] * t[j];
    add_flipped<Z>(z, i, f, u);
  }
}

// log|det J| of a step: sum_i log(|1 + (1 - t_i^2) r1_ii r2_ii| + 1e-8),
// summed over i in order, as the plain version does.
template <int Z>
__device__ __forceinline__ float step_logdet(const Step<Z>& s, const float* t) {
  float ld = 0.f;
#pragma unroll
  for (int i = 0; i < Z; ++i) ld += logdet_term(t[i], s.a[i][i], s.c[i][i]);
  return ld;
}

}  // namespace
