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
// A member axis: with `members` M > 1 the B points are M member-major
// blocks of B / M (ensemble members, as the vmap of JAX's ensemble step
// batches the Pallas kernel), and z0 is a contiguous (M, K, Z) tensor:
// point p reads block p / (B / M).  Each (point, draw) does the arithmetic
// of a launch of its member alone, so one launch gives every member's bits.
//
// What bounds it on an H100.  By chip_smoke.py's bound, bytes: per point it
// reads 2 Z^2 F + Z F parameters (84 floats for the rgb chain at F=4) and
// writes K (Z + 1) outputs (128 floats at K=32): at the hierarchical serving
// fine pass (8192 rays x 192 samples, K=32) the rgb launch moves ~1.3 GB,
// ~0.4 ms at 3.35 TB/s, against ~5.4 GFLOP of arithmetic, ~0.08 ms at 67
// TFLOP/s (chip_smoke.py:flow_stack_work counts both).  What the card must
// issue is more: the accurate libm tanhf is a dozen or more instructions,
// and the rgb chain takes 12 of them a (point, draw) at F=4.
//
// What the design does about it.  Measured by ablation on the card
// (scripts/torch_render_core_times.py --kernels flow_stack, PERF.md), the
// earlier design (this one's shape, with F at runtime and 64-bit index
// arithmetic) was held by the instructions it issued, not by its bytes:
// its arithmetic alone took 92% of its time, its loads alone 66%, its
// stores alone 27%.  Designs that staged a CTA's parameters through shared
// memory (cp.async, a ring of tiles, 16-byte stores of z) issued fewer
// instructions a (point, draw) but ran no faster: they held more registers
// and waited at barriers, so fewer warps hid the tanh chains' latency.
// So the thread a (point, draw) stays, at 32 registers (64 warps an SM),
// and what it issues is cut:
//   * F = 4 is compile-time and the steps unroll: each step's 15
//     parameters (rgb chain) are loads at fixed offsets from one pointer,
//     with no index arithmetic, and each step's flip is compile-time.
//     Any other F takes the same code with a runtime F.
//   * The point and draw of a thread come from 32-bit index arithmetic
//     whenever B K < 2^31 (a uniform branch keeps the 64-bit division for
//     larger launches).
//   * At K = 32 the 32 lanes of a warp are one point's draws, so each
//     parameter load is one broadcast a warp; z and ldj are written once,
//     neighbouring threads on neighbouring addresses.
// Math is f32 throughout with the accurate libm functions: no fast-math,
// no approximate intrinsic.

#include "flow_stack.cuh"

namespace {

constexpr int kThreads = 256;

template <int Z, int FC, bool CLD>
__global__ void __launch_bounds__(kThreads)
flow_stack_fwd_kernel(const float* __restrict__ z0, long long z0_stride,
                      long long per_member,
                      const float* __restrict__ r1,
                      const float* __restrict__ r2,
                      const float* __restrict__ b,
                      float* __restrict__ z_out,
                      float* __restrict__ ldj_out,
                      long long n, int K, int F_rt) {
  constexpr int ZZ = Z * Z;
  const int F = FC > 0 ? FC : F_rt;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= n) return;
  long long p, z0_off;
  int k;
  if (n <= 0x7fffffffLL) {  // uniform: 32-bit arithmetic
    const unsigned pu = (unsigned)i / (unsigned)K;
    p = pu;
    k = (int)((unsigned)i - pu * (unsigned)K);
    // per_member is 0 without a member axis (uniform)
    z0_off = per_member ? (long long)(pu / (unsigned)per_member) * (K * Z) : p * z0_stride;
  } else {
    p = i / K;
    k = (int)(i - p * K);
    z0_off = per_member ? (p / per_member) * (K * Z) : p * z0_stride;
  }

  const float* src = z0 + z0_off + k * Z;
  float z[Z], t[Z];
#pragma unroll
  for (int c = 0; c < Z; ++c) z[c] = __ldg(src + c);
  const float* q1 = r1 + p * (ZZ * F);
  const float* q2 = r2 + p * (ZZ * F);
  const float* qb = b + p * (Z * F);
  float ldj = 0.f;
#pragma unroll
  for (int f = 0; f < F; ++f) {
    const Step<Z> s = load_step<Z>(q1, q2, qb, f, F);
    step_fwd<Z>(s, f, z, t);
    if (CLD) ldj += step_logdet<Z>(s, t);
  }
#pragma unroll
  for (int c = 0; c < Z; ++c) z_out[i * Z + c] = z[c];
  ldj_out[i] = ldj;
}

template <int Z, int FC, bool CLD>
cudaError_t launch_fwd(cudaStream_t st, const float* z0, int z0_stride, int per_member,
                       const float* r1, const float* r2, const float* b, float* z,
                       float* ldj, int B, int K, int F) {
  const long long n = (long long)B * K;
  const unsigned grid = (unsigned)((n + kThreads - 1) / kThreads);
  flow_stack_fwd_kernel<Z, FC, CLD><<<grid, kThreads, 0, st>>>(
      z0, z0_stride, per_member, r1, r2, b, z, ldj, n, K, F);
  return cudaGetLastError();
}

template <int Z>
cudaError_t launch_fwd_z(bool f4, bool cld, cudaStream_t st, const float* z0,
                         int z0_stride, int per_member, const float* r1, const float* r2,
                         const float* b, float* z, float* ldj, int B, int K, int F) {
  if (f4) {
    return cld ? launch_fwd<Z, 4, true>(st, z0, z0_stride, per_member, r1, r2, b, z, ldj,
                                        B, K, F)
               : launch_fwd<Z, 4, false>(st, z0, z0_stride, per_member, r1, r2, b, z, ldj,
                                         B, K, F);
  }
  return cld ? launch_fwd<Z, 0, true>(st, z0, z0_stride, per_member, r1, r2, b, z, ldj, B,
                                      K, F)
             : launch_fwd<Z, 0, false>(st, z0, z0_stride, per_member, r1, r2, b, z, ldj, B,
                                       K, F);
}

}  // namespace

// C entry point (bound with ctypes).  Pointers are device pointers to f32
// arrays: z0 read through `z0_stride` floats per point (its (K, Z) block
// contiguous), or with `members` M > 1 a contiguous (M, K, Z) block a
// member (z0_stride 0; B a multiple of M, the points member-major); r1, r2
// (B, Z, Z, F), b (B, Z, F), z (B, K, Z) and ldj (B, K) contiguous; the
// caller checks shapes.  F = 4 takes the compile-time kernel, any other F
// the runtime-F one.  Launches on `stream` and returns cudaGetLastError()
// (0 on success); it never synchronises.
extern "C" int flow_stack_fwd(const float* z0, int z0_stride, const float* r1,
                              const float* r2, const float* b, float* z,
                              float* ldj, int B, int K, int Z, int F,
                              int compute_log_det, int members, void* stream) {
  if (B < 0 || K < 1 || F < 1 || z0_stride < 0 || (Z != 1 && Z != 3) || members < 1 ||
      B % members != 0 || (members > 1 && z0_stride != 0)) {
    return (int)cudaErrorInvalidValue;
  }
  if (B == 0) return 0;
  const bool cld = compute_log_det != 0;
  const int per_member = members > 1 ? B / members : 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      Z == 1 ? launch_fwd_z<1>(F == 4, cld, st, z0, z0_stride, per_member, r1, r2, b, z, ldj,
                               B, K, F)
             : launch_fwd_z<3>(F == 4, cld, st, z0, z0_stride, per_member, r1, r2, b, z, ldj,
                               B, K, F);
  return (int)err;
}
