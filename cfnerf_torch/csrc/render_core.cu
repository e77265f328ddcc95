// Render-core forward for Hopper (sm_90a): both triangular-Sylvester flow
// stacks + the K-sample alpha composite, one warp per ray.
//
// Replaces: cfnerf_tpu/ops/pallas/render_core.py:_fwd_kernel (the Pallas TPU
// kernel launched by _fwd_impl through fused_flow_composite), in both modes
// (compute_log_det = 0 for serving, 1 for the training forward).
//
// What it computes, per ray r, draw k and sample s (point p = r*S + s):
//   density chain (Z=1) and rgb chain (Z=3), F steps each, flip on odd steps:
//     z' = z + P^T R1 tanh(R2 P z + b)
//   alpha = 1 - exp(-softplus(z_density) * d_pts[p]),
//   T_0 = 1, T_{s+1} = T_s * (1 - alpha_s + 1e-10)   (exclusive transmittance)
//   w = alpha * T;  rgb[r,c,k] += w * sigmoid(z_rgb_c);  depth += w * z_pts[p];
//   acc += w;  train mode: ldj[0,r] / ldj[1,r] sum the flow log-dets and the
//   softplus / sigmoid log-det corrections over all (s, k) of the ray.
//
// What bounds it on an H100: bytes.  Each point carries 24F+2 f32 inputs
// (r1/r2/b of both families + depth + interval: 98 floats, 392 B at F=4), read
// once; at the serving tile (8192 rays x 128 samples) that is ~411 MB, ~0.12 ms
// at 3.35 TB/s.  The arithmetic is ~160 f32 operations per (point, draw), about
// 5.3 GFLOP per tile, ~0.08 ms at 67 TFLOP/s, so memory is the roof.
//
// What the design does about it: every input byte is read from device memory
// once and nothing intermediate is written back.  A warp owns one ray; lane k
// owns draw k (loop k += 32 when K > 32, masked lanes when K < 32).  All K
// draws of a ray read the same per-point parameters, so each chunk of points
// is staged into shared memory with coalesced warp loads in the natural
// (B, Z, Z, F) layout and then read as broadcasts.  The sample axis is walked
// in order with the transmittance in a register, so the exclusive product is
// a sequential scan with no extra pass; rgb/depth/acc accumulate in registers.
// The per-ray log-det sum is a fixed-order warp shuffle reduction (no atomics,
// deterministic).  Math is f32 throughout with the accurate libm functions.
// Faster staging (cp.async / TMA, several rays per warp) is later work.

#include "render_core.cuh"

namespace {

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
render_core_fwd_kernel(const float* __restrict__ z0a,
                       const float* __restrict__ r1a,
                       const float* __restrict__ r2a,
                       const float* __restrict__ ba,
                       const float* __restrict__ z0r,
                       const float* __restrict__ r1r,
                       const float* __restrict__ r2r,
                       const float* __restrict__ br,
                       const float* __restrict__ zpts,
                       const float* __restrict__ dpts,
                       float* __restrict__ rgb,
                       float* __restrict__ depth,
                       float* __restrict__ acc,
                       float* __restrict__ ldj,
                       int R, int S, int K, int F, int chunk,
                       int compute_log_det) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int ray = blockIdx.x * kWarpsPerBlock + warp;
  if (ray >= R) return;  // whole warp leaves together; no block barrier below

  // This warp's staging area, one segment per input array:
  //   r1a | r2a | ba : chunk*F each      r1r | r2r : chunk*9F each
  //   br : chunk*3F                      z : chunk          d : chunk
  float* st = smem + (size_t)warp * chunk * (24 * F + 2);
  float* s_r1a = st;
  float* s_r2a = s_r1a + chunk * F;
  float* s_ba = s_r2a + chunk * F;
  float* s_r1r = s_ba + chunk * F;
  float* s_r2r = s_r1r + chunk * 9 * F;
  float* s_br = s_r2r + chunk * 9 * F;
  float* s_z = s_br + chunk * 3 * F;
  float* s_d = s_z + chunk;

  const bool cld = compute_log_det != 0;
  float lane_la = 0.f, lane_lr = 0.f;  // this lane's log-det partials

  for (int kb = 0; kb < K; kb += 32) {
    const int k = kb + lane;
    const bool active = k < K;
    const int kk = active ? k : 0;
    const float za0 = z0a[kk];
    const float zr0 = z0r[kk * 3 + 0];
    const float zr1 = z0r[kk * 3 + 1];
    const float zr2 = z0r[kk * 3 + 2];

    float T = 1.f;
    float out_r = 0.f, out_g = 0.f, out_b = 0.f, out_d = 0.f, out_a = 0.f;
    float la = 0.f, lr = 0.f;

    for (int s0 = 0; s0 < S; s0 += chunk) {
      const int n = min(chunk, S - s0);
      const size_t p0 = (size_t)ray * S + s0;
      __syncwarp();  // the previous chunk is fully consumed
      stage(s_r1a, r1a + p0 * F, n * F, lane);
      stage(s_r2a, r2a + p0 * F, n * F, lane);
      stage(s_ba, ba + p0 * F, n * F, lane);
      stage(s_r1r, r1r + p0 * 9 * F, n * 9 * F, lane);
      stage(s_r2r, r2r + p0 * 9 * F, n * 9 * F, lane);
      stage(s_br, br + p0 * 3 * F, n * 3 * F, lane);
      stage(s_z, zpts + p0, n, lane);
      stage(s_d, dpts + p0, n, lane);
      __syncwarp();

      for (int s = 0; s < n; ++s) {
        // ---- density chain, Z = 1 (the flip is the identity) ----
        const float* q1a = s_r1a + s * F;
        const float* q2a = s_r2a + s * F;
        const float* qba = s_ba + s * F;
        // this sample's log-det terms are summed apart, then added to the
        // running per-lane sums: fewer additions at the large magnitude
        float la_s = 0.f, lr_s = 0.f;
        float za = za0;
        for (int f = 0; f < F; ++f) {
          const float t = density_step(za, q1a, q2a, qba, f);
          if (cld) la_s += logdet_term(t, q1a[f], q2a[f]);
        }

        // ---- rgb chain, Z = 3; r[(i*3+j)*F + f], b[i*F + f] ----
        const float* q1 = s_r1r + s * 9 * F;
        const float* q2 = s_r2r + s * 9 * F;
        const float* qb = s_br + s * 3 * F;
        float z0 = zr0, z1 = zr1, z2 = zr2;
        for (int f = 0; f < F; ++f) {
          float t0, t1, t2;
          rgb_tanh(q2, qb, f, F, z0, z1, z2, t0, t1, t2);
          rgb_update(q1, f, F, t0, t1, t2, z0, z1, z2);
          if (cld) {
            lr_s += logdet_term(t0, q1[0 * F + f], q2[0 * F + f]);
            lr_s += logdet_term(t1, q1[4 * F + f], q2[4 * F + f]);
            lr_s += logdet_term(t2, q1[8 * F + f], q2[8 * F + f]);
          }
        }

        // ---- composite step: sequential exclusive transmittance ----
        const float sp = softplus_f(za);
        const float e = expf(-sp * s_d[s]);   // 1 - alpha
        const float w = (1.f - e) * T;
        T = T * (e + kTransEps);
        out_r += w * sigmoid_f(z0);
        out_g += w * sigmoid_f(z1);
        out_b += w * sigmoid_f(z2);
        out_d += w * s_z[s];
        out_a += w;
        if (cld) {
          la += la_s + (za - sp);
          lr += lr_s + ((z0 - 2.f * softplus_f(z0)) + (z1 - 2.f * softplus_f(z1)) +
                        (z2 - 2.f * softplus_f(z2)));
        }
      }
    }

    if (active) {
      const size_t rk = (size_t)ray * K + k;
      rgb[((size_t)ray * 3 + 0) * K + k] = out_r;
      rgb[((size_t)ray * 3 + 1) * K + k] = out_g;
      rgb[((size_t)ray * 3 + 2) * K + k] = out_b;
      depth[rk] = out_d;
      acc[rk] = out_a;
      lane_la += la;
      lane_lr += lr;
    }
  }

  // per-ray log-det sums over all draws: fixed-order butterfly reduction
  for (int off = 16; off > 0; off >>= 1) {
    lane_la += __shfl_xor_sync(0xffffffffu, lane_la, off);
    lane_lr += __shfl_xor_sync(0xffffffffu, lane_lr, off);
  }
  if (lane == 0) {
    ldj[ray] = cld ? lane_la : 0.f;
    ldj[(size_t)R + ray] = cld ? lane_lr : 0.f;
  }
}

}  // namespace

// C entry point (bound with ctypes).  Pointers are device pointers to
// contiguous f32 arrays; the caller checks shapes.  Launches on `stream` and
// returns cudaGetLastError() (0 on success); it never synchronises.
extern "C" int render_core_fwd(const float* z0a, const float* r1a,
                               const float* r2a, const float* ba,
                               const float* z0r, const float* r1r,
                               const float* r2r, const float* br,
                               const float* zpts, const float* dpts,
                               float* rgb, float* depth, float* acc,
                               float* ldj, int R, int S, int K, int F,
                               int compute_log_det, void* stream) {
  if (R < 0 || S < 1 || K < 1 || F < 1) return (int)cudaErrorInvalidValue;
  if (R == 0) return 0;
  const int chunk = staging_chunk(S, F);
  if (chunk < 1) return (int)cudaErrorInvalidValue;  // F too large to stage
  const size_t smem = (size_t)kWarpsPerBlock * chunk * (24 * F + 2) * sizeof(float);
  const dim3 grid((R + kWarpsPerBlock - 1) / kWarpsPerBlock);
  render_core_fwd_kernel<<<grid, kWarpsPerBlock * 32, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      z0a, r1a, r2a, ba, z0r, r1r, r2r, br, zpts, dpts, rgb, depth, acc, ldj,
      R, S, K, F, chunk, compute_log_det);
  return (int)cudaGetLastError();
}
