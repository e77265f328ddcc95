// Flow-stack forward for Hopper (sm_90a): F triangular-Sylvester steps over
// (B, K, Z) latents with per-point parameters, flip on odd steps, optional
// summed log-det.  One thread per (point, draw).
//
// Replaces: cfnerf_tpu/ops/pallas/flow_stack.py:_fwd_kernel (with _fwd_tile,
// launched by fused_flow_stack), in both modes (compute_log_det = 0 writes a
// zero log-det, as there).  It runs on the natural (B, K, Z) layout; the TPU
// kernel's transposed (rows, B) layout existed for the TPU's lanes.
//
// What it computes, per point p and draw k, Z in {1, 3} (a template):
//   z = z0[p, k];  for f < F:  t = tanh(b_f + R2_f P z),  z += P^T R1_f t,
//   ldj += sum_i log(|1 + (1 - t_i^2) r1_ii r2_ii| + 1e-8)   (train mode)
// with P the flip on odd f.  z0 is read through a point stride: 0 when the
// model hands over its shared (K, Z) draws expanded over the points (the
// expand is never materialised: 604 MB at the hierarchical serving tile),
// K*Z when z0 is a contiguous (B, K, Z) tensor.
//
// What bounds it on an H100: bytes.  Per point it reads 2 Z^2 F + Z F
// parameters (84 floats for the rgb chain at F=4) and writes K (Z + 1)
// outputs (128 floats at K=32): at the hierarchical serving fine pass (8192
// rays x 192 samples, K=32) the rgb launch moves ~1.3 GB, ~0.4 ms at
// 3.35 TB/s, against ~5.4 GFLOP of arithmetic, ~0.08 ms at 67 TFLOP/s
// (chip_smoke.py:flow_stack_work counts both).
//
// What the design does about it, simply: every thread reads its point's
// parameters straight from device memory; at K=32 the 32 lanes of a warp
// are one point's draws, so each parameter load is one broadcast per warp,
// and consecutive warps walk consecutive points.  z and ldj are written
// once, neighbouring threads on neighbouring addresses.  Nothing
// intermediate touches memory.  Wider loads (parameters staged through
// shared memory, several points per warp at small K) are later work.

#include "flow_stack.cuh"

namespace {

template <int Z>
__global__ void __launch_bounds__(kFwdThreads)
flow_stack_fwd_kernel(const float* __restrict__ z0, long long z0_stride,
                      const float* __restrict__ r1,
                      const float* __restrict__ r2,
                      const float* __restrict__ b,
                      float* __restrict__ z_out,
                      float* __restrict__ ldj_out,
                      long long n, int K, int F, int compute_log_det) {
  const long long i = (long long)blockIdx.x * kFwdThreads + threadIdx.x;
  if (i >= n) return;
  const long long p = i / K;
  const int k = (int)(i - p * K);

  const float* src = z0 + p * z0_stride + (long long)k * Z;
  float z[Z], t[Z];
#pragma unroll
  for (int c = 0; c < Z; ++c) z[c] = src[c];
  const float* q1 = r1 + p * (Z * Z * F);
  const float* q2 = r2 + p * (Z * Z * F);
  const float* qb = b + p * (Z * F);

  const bool cld = compute_log_det != 0;
  float ldj = 0.f;
  for (int f = 0; f < F; ++f) {
    FlowStep<Z>::run(z, t, q1, q2, qb, f, F);
    if (cld) ldj += step_logdet<Z>(t, q1, q2, f, F);
  }
#pragma unroll
  for (int c = 0; c < Z; ++c) z_out[i * Z + c] = z[c];
  ldj_out[i] = ldj;
}

}  // namespace

// C entry point (bound with ctypes).  Pointers are device pointers to f32
// arrays: z0 read through `z0_stride` floats per point (its (K, Z) block
// contiguous), r1, r2 (B, Z, Z, F), b (B, Z, F), z (B, K, Z) and ldj (B, K)
// contiguous; the caller checks shapes.  Launches on `stream` and returns
// cudaGetLastError() (0 on success); it never synchronises.
extern "C" int flow_stack_fwd(const float* z0, int z0_stride, const float* r1,
                              const float* r2, const float* b, float* z,
                              float* ldj, int B, int K, int Z, int F,
                              int compute_log_det, void* stream) {
  if (B < 0 || K < 1 || F < 1 || z0_stride < 0 || (Z != 1 && Z != 3)) {
    return (int)cudaErrorInvalidValue;
  }
  const long long n = (long long)B * K;
  if (n == 0) return 0;
  const dim3 grid((unsigned)((n + kFwdThreads - 1) / kFwdThreads));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (Z == 1) {
    flow_stack_fwd_kernel<1><<<grid, kFwdThreads, 0, st>>>(
        z0, z0_stride, r1, r2, b, z, ldj, n, K, F, compute_log_det);
  } else {
    flow_stack_fwd_kernel<3><<<grid, kFwdThreads, 0, st>>>(
        z0, z0_stride, r1, r2, b, z, ldj, n, K, F, compute_log_det);
  }
  return (int)cudaGetLastError();
}
