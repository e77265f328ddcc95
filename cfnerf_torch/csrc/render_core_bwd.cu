// Render-core backward for Hopper (sm_90a): the gradient of the render-core
// forward (render_core.cu) with respect to the shared base draws and every
// per-point flow parameter, one warp per ray.
//
// Replaces: cfnerf_tpu/ops/pallas/render_core.py:_bwd_kernel (with _flow_bwd,
// launched by _vjp_bwd, the custom VJP of fused_flow_composite), in both modes
// (compute_log_det = 0: the log-det cotangent is ignored, as there).
//
// What it computes, per ray r and draw k, from the cotangents g_rgb (R,3,K),
// g_depth (R,K), g_acc (R,K) and g_ldj (2,R):
//   composite:  g_w = g_acc + g_depth z + sum_c g_rgb_c v_c,   v = sigmoid(z_rgb)
//               g_zrgb_c = g_rgb_c w v_c (1 - v_c)  [+ g_ldj1 (1 - 2 v_c)]
//   transmittance, division-free (render_core.py:31-36, 421-431):
//               C_s = g_T[s+1] + x[s+1] C_{s+1},  C_{S-1} = 0,  g_T = g_w (1-e)
//               dL/dx_s = T_s C_s,   x = e + 1e-10,   e = 1 - alpha
//               g_e = T_s C_s - g_w T_s
//               g_zden = g_e e (-d) sigmoid(zden)  [+ g_ldj0 (1 - sigmoid(zden))]
//   then each flow chain in reverse (render_core.py:_flow_bwd), the log-det
//   terms weighted by g_ldj in train mode.  Per-point gradients of r1/r2/b
//   are sums over the K draws; the z0 gradients are sums over all points.
//   The lower triangles of g_r1_r / g_r2_r are zero.
//
// What bounds it on an H100: operations.  It reads the forward's 24F+2
// floats per point and writes 24F gradients per point: at the flagship train
// tile (640 rays x 128 samples, K=32, F=4) about 64 MB, ~0.02 ms at
// 3.35 TB/s.  It recomputes the forward and runs the reverse sweeps for every
// (point, draw): about 825 f32 operations each at F=4, ~2.2 GFLOP, ~0.03 ms
// at 67 TFLOP/s (chip_smoke.py:render_core_bwd_work counts them).
//
// What the design does about it, simply and not yet fast:
//   * A warp owns a ray and lane k owns draw k (lane groups of 32 when
//     K > 32, idle lanes with zero cotangents when K < 32), as in the forward.
//   * Pass 1 walks the samples in order through the density chain and keeps
//     each sample's exclusive transmittance T_s in a global scratch (R,S,K),
//     each lane writing and later reading only its own draw (coalesced, 10.5
//     MB at the train tile, mostly L2-resident).  Shared memory would need
//     S*32 floats per warp (16 KB at S=128, more for longer rays) on top of
//     the staging; the scratch takes any S, and T_s is never recovered by
//     dividing by x (the closed form that NaN'd at saturated alpha).
//   * Pass 2 walks the samples backwards, staging each chunk of points into
//     shared memory as the forward does.  For each sample it recomputes both
//     flow chains of this lane's draw, runs the composite backward with C in
//     a register, then each chain's reverse sweep.  F is a runtime value, so
//     step f's input z_f is recomputed from z0 (O(F^2) steps per point)
//     instead of being kept in a register array with a compile-time bound.
//   * Per-point gradients are fixed-order butterfly warp sums over the
//     draws; lane 0 stores them, and adds the later lane groups' sums to
//     what it stored (K > 32).  No atomics: the result is the same on every
//     run.
//   * Each lane accumulates its draw's z0 gradient over the ray in registers
//     and writes one row of per-ray partials (R, 4K); a second kernel sums
//     the R rows of each column in a fixed order.
// Faster work (trace in shared memory, several rays per warp, fewer
// shuffles) is later work.

#include "render_core.cuh"

namespace {

constexpr int kReduceThreads = 256;

__device__ __forceinline__ float warp_sum(float v) {
  // butterfly: every lane ends with the same bits (a + b == b + a)
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Per-point gradient summed over this warp's draws.  Lane 0 stores it; for
// a later lane group it adds to what the same lane stored before.
__device__ __forceinline__ void put(float* dst, float v, bool first, int lane) {
  v = warp_sum(v);
  if (lane == 0) *dst = first ? v : *dst + v;
}

__device__ __forceinline__ float sign_f(float x) {  // jnp.sign: sign(0) = 0
  return (float)((x > 0.f) - (x < 0.f));
}

__global__ void __launch_bounds__(kWarpsPerBlock * 32)
render_core_bwd_kernel(const float* __restrict__ z0a,
                       const float* __restrict__ r1a,
                       const float* __restrict__ r2a,
                       const float* __restrict__ ba,
                       const float* __restrict__ z0r,
                       const float* __restrict__ r1r,
                       const float* __restrict__ r2r,
                       const float* __restrict__ br,
                       const float* __restrict__ zpts,
                       const float* __restrict__ dpts,
                       const float* __restrict__ g_rgb,
                       const float* __restrict__ g_depth,
                       const float* __restrict__ g_acc,
                       const float* __restrict__ g_ldj,
                       float* __restrict__ g_r1a,
                       float* __restrict__ g_r2a,
                       float* __restrict__ g_ba,
                       float* __restrict__ g_r1r,
                       float* __restrict__ g_r2r,
                       float* __restrict__ g_br,
                       float* __restrict__ trans,
                       float* __restrict__ z0_part,
                       int R, int S, int K, int F, int chunk,
                       int compute_log_det) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int ray = blockIdx.x * kWarpsPerBlock + warp;
  if (ray >= R) return;  // whole warp leaves together; no block barrier below

  // this warp's staging area, laid out as in the forward
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

  for (int kb = 0; kb < K; kb += 32) {
    const int k = kb + lane;
    const bool active = k < K;
    const bool first = kb == 0;
    const int kk = active ? k : 0;
    const float za0 = z0a[kk];
    const float zr0 = z0r[kk * 3 + 0];
    const float zr1 = z0r[kk * 3 + 1];
    const float zr2 = z0r[kk * 3 + 2];

    // cotangents of this (ray, draw); zero on idle lanes, so every gradient
    // they compute is zero
    float G0 = 0.f, G1 = 0.f, G2 = 0.f, Gd = 0.f, Ga = 0.f, gla = 0.f, glr = 0.f;
    if (active) {
      G0 = g_rgb[((size_t)ray * 3 + 0) * K + k];
      G1 = g_rgb[((size_t)ray * 3 + 1) * K + k];
      G2 = g_rgb[((size_t)ray * 3 + 2) * K + k];
      Gd = g_depth[(size_t)ray * K + k];
      Ga = g_acc[(size_t)ray * K + k];
      if (cld) {
        gla = g_ldj[ray];
        glr = g_ldj[(size_t)R + ray];
      }
    }
    float* T_of = trans + (size_t)ray * S * K + k;  // T_s at T_of[s * K]

    // ---- pass 1: exclusive transmittance, samples in order ----
    float T = 1.f;
    for (int s = 0; s < S; ++s) {
      const size_t p = (size_t)ray * S + s;
      float za = za0;
      for (int f = 0; f < F; ++f) density_step(za, r1a + p * F, r2a + p * F, ba + p * F, f);
      const float e = expf(-softplus_f(za) * dpts[p]);
      if (active) T_of[(size_t)s * K] = T;
      T = T * (e + kTransEps);
    }

    // ---- pass 2: samples in reverse ----
    float C = 0.f;
    float gz0a = 0.f, gz0r0 = 0.f, gz0r1 = 0.f, gz0r2 = 0.f;
    for (int s_end = S; s_end > 0; s_end -= chunk) {
      const int n = min(chunk, s_end);
      const int s0 = s_end - n;
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

      for (int s = n - 1; s >= 0; --s) {
        const size_t p = p0 + s;
        const float* q1a = s_r1a + s * F;
        const float* q2a = s_r2a + s * F;
        const float* qba = s_ba + s * F;
        const float* q1 = s_r1r + s * 9 * F;
        const float* q2 = s_r2r + s * 9 * F;
        const float* qb = s_br + s * 3 * F;

        // recompute this point's forward for this draw
        float za = za0;
        for (int f = 0; f < F; ++f) density_step(za, q1a, q2a, qba, f);
        float z0 = zr0, z1 = zr1, z2 = zr2;
        for (int f = 0; f < F; ++f) {
          float t0, t1, t2;
          rgb_tanh(q2, qb, f, F, z0, z1, z2, t0, t1, t2);
          rgb_update(q1, f, F, t0, t1, t2, z0, z1, z2);
        }
        const float d = s_d[s];
        const float sp = softplus_f(za);
        const float sg = sigmoid_f(za);  // softplus'
        const float e = expf(-sp * d);
        const float x = e + kTransEps;
        const float Ts = active ? T_of[(size_t)(s0 + s) * K] : 0.f;
        const float w = (1.f - e) * Ts;
        const float v0 = sigmoid_f(z0), v1 = sigmoid_f(z1), v2 = sigmoid_f(z2);

        // ---- composite backward ----
        float gw = Ga + Gd * s_z[s];
        gw = gw + G0 * v0;
        gw = gw + G1 * v1;
        gw = gw + G2 * v2;
        float gz0 = G0 * w * v0 * (1.f - v0);
        float gz1 = G1 * w * v1 * (1.f - v1);
        float gz2 = G2 * w * v2 * (1.f - v2);
        const float gx = Ts * C;            // dL/dx_s = T_s C_s
        C = gw * (1.f - e) + x * C;         // C_{s-1}
        const float ge = gx - gw * Ts;
        float gza = ge * e * (-d) * sg;
        if (cld) {
          // corrections: d/dz (z - softplus z) = 1 - sigmoid z;
          //              d/dz (z - 2 softplus z) = 1 - 2 sigmoid z
          gza = gza + gla * (1.f - sg);
          gz0 = gz0 + glr * (1.f - 2.f * v0);
          gz1 = gz1 + glr * (1.f - 2.f * v1);
          gz2 = gz2 + glr * (1.f - 2.f * v2);
        }

        // ---- density chain, reverse ----
        for (int f = F - 1; f >= 0; --f) {
          float zf = za0;  // this step's input, recomputed from z0
          for (int h = 0; h < f; ++h) density_step(zf, q1a, q2a, qba, h);
          const float t = tanhf(qba[f] + q2a[f] * zf);
          const float a = q1a[f], c = q2a[f], der = 1.f - t * t;
          float gt = 0.f, gr1 = 0.f, gr2 = 0.f;
          if (cld) {
            const float rr = a * c;
            const float dj = der * rr + 1.f;
            const float cc = gla * sign_f(dj) / (fabsf(dj) + kLogdetEps);
            gt = cc * (-2.f * t) * rr;
            gr1 = cc * der * c;
            gr2 = cc * der * a;
          }
          gr1 = gr1 + gza * t;
          gt = gt + a * gza;
          const float gp = gt * der;
          gr2 = gr2 + gp * zf;
          gza = gza + c * gp;
          put(g_r1a + p * F + f, gr1, first, lane);
          put(g_r2a + p * F + f, gr2, first, lane);
          put(g_ba + p * F + f, gp, first, lane);
        }
        gz0a += gza;

        // ---- rgb chain, reverse ----
        for (int f = F - 1; f >= 0; --f) {
          float y0 = zr0, y1 = zr1, y2 = zr2;  // this step's input z_f
          for (int h = 0; h < f; ++h) {
            float t0, t1, t2;
            rgb_tanh(q2, qb, h, F, y0, y1, y2, t0, t1, t2);
            rgb_update(q1, h, F, t0, t1, t2, y0, y1, y2);
          }
          float t0, t1, t2;
          rgb_tanh(q2, qb, f, F, y0, y1, y2, t0, t1, t2);
          const bool flip = (f & 1) != 0;
          const float zp0 = flip ? y2 : y0, zp1 = y1, zp2 = flip ? y0 : y2;
          const float gu0 = flip ? gz2 : gz0, gu1 = gz1, gu2 = flip ? gz0 : gz2;
          const float a00 = q1[0 * F + f], a01 = q1[1 * F + f], a02 = q1[2 * F + f];
          const float a11 = q1[4 * F + f], a12 = q1[5 * F + f], a22 = q1[8 * F + f];
          const float c00 = q2[0 * F + f], c01 = q2[1 * F + f], c02 = q2[2 * F + f];
          const float c11 = q2[4 * F + f], c12 = q2[5 * F + f], c22 = q2[8 * F + f];
          const float d0 = 1.f - t0 * t0, d1 = 1.f - t1 * t1, d2 = 1.f - t2 * t2;

          float gt0 = 0.f, gt1 = 0.f, gt2 = 0.f;
          float g1_00 = 0.f, g1_11 = 0.f, g1_22 = 0.f;
          float g2_00 = 0.f, g2_11 = 0.f, g2_22 = 0.f;
          if (cld) {
            float rr = a00 * c00, dj = d0 * rr + 1.f;
            float cc = glr * sign_f(dj) / (fabsf(dj) + kLogdetEps);
            gt0 = cc * (-2.f * t0) * rr; g1_00 = cc * d0 * c00; g2_00 = cc * d0 * a00;
            rr = a11 * c11; dj = d1 * rr + 1.f;
            cc = glr * sign_f(dj) / (fabsf(dj) + kLogdetEps);
            gt1 = cc * (-2.f * t1) * rr; g1_11 = cc * d1 * c11; g2_11 = cc * d1 * a11;
            rr = a22 * c22; dj = d2 * rr + 1.f;
            cc = glr * sign_f(dj) / (fabsf(dj) + kLogdetEps);
            gt2 = cc * (-2.f * t2) * rr; g1_22 = cc * d2 * c22; g2_22 = cc * d2 * a22;
          }
          // u_i = sum_{j >= i} r1[i,j] t_j
          g1_00 = g1_00 + gu0 * t0; gt0 = gt0 + a00 * gu0;
          const float g1_01 = gu0 * t1; gt1 = gt1 + a01 * gu0;
          const float g1_02 = gu0 * t2; gt2 = gt2 + a02 * gu0;
          g1_11 = g1_11 + gu1 * t1; gt1 = gt1 + a11 * gu1;
          const float g1_12 = gu1 * t2; gt2 = gt2 + a12 * gu1;
          g1_22 = g1_22 + gu2 * t2; gt2 = gt2 + a22 * gu2;
          // pre_i = b_i + sum_{j >= i} r2[i,j] zp_j
          const float gp0 = gt0 * d0, gp1 = gt1 * d1, gp2 = gt2 * d2;
          g2_00 = g2_00 + gp0 * zp0; float gzp0 = c00 * gp0;
          const float g2_01 = gp0 * zp1; float gzp1 = c01 * gp0;
          const float g2_02 = gp0 * zp2; float gzp2 = c02 * gp0;
          g2_11 = g2_11 + gp1 * zp1; gzp1 = gzp1 + c11 * gp1;
          const float g2_12 = gp1 * zp2; gzp2 = gzp2 + c12 * gp1;
          g2_22 = g2_22 + gp2 * zp2; gzp2 = gzp2 + c22 * gp2;
          // back through the flip: zp_j is z_{P(j)}
          if (flip) {
            gz2 = gz2 + gzp0; gz1 = gz1 + gzp1; gz0 = gz0 + gzp2;
          } else {
            gz0 = gz0 + gzp0; gz1 = gz1 + gzp1; gz2 = gz2 + gzp2;
          }

          float* o1 = g_r1r + p * 9 * F + f;
          float* o2 = g_r2r + p * 9 * F + f;
          float* ob = g_br + p * 3 * F + f;
          put(o1 + 0 * F, g1_00, first, lane); put(o2 + 0 * F, g2_00, first, lane);
          put(o1 + 1 * F, g1_01, first, lane); put(o2 + 1 * F, g2_01, first, lane);
          put(o1 + 2 * F, g1_02, first, lane); put(o2 + 2 * F, g2_02, first, lane);
          put(o1 + 4 * F, g1_11, first, lane); put(o2 + 4 * F, g2_11, first, lane);
          put(o1 + 5 * F, g1_12, first, lane); put(o2 + 5 * F, g2_12, first, lane);
          put(o1 + 8 * F, g1_22, first, lane); put(o2 + 8 * F, g2_22, first, lane);
          put(ob + 0 * F, gp0, first, lane);
          put(ob + 1 * F, gp1, first, lane);
          put(ob + 2 * F, gp2, first, lane);
          if (first && lane == 0) {  // lower triangles
            o1[3 * F] = 0.f; o1[6 * F] = 0.f; o1[7 * F] = 0.f;
            o2[3 * F] = 0.f; o2[6 * F] = 0.f; o2[7 * F] = 0.f;
          }
        }
        gz0r0 += gz0;
        gz0r1 += gz1;
        gz0r2 += gz2;
      }
    }

    if (active) {  // this ray's z0 partials: columns [a | r0 | r1 | r2] x K
      float* part = z0_part + (size_t)ray * 4 * K + k;
      part[0] = gz0a;
      part[(size_t)K] = gz0r0;
      part[(size_t)2 * K] = gz0r1;
      part[(size_t)3 * K] = gz0r2;
    }
  }
}

// g_z0: column `blockIdx.x` of the (R, 4K) partials summed over the rays in a
// fixed order (strided per thread, then a tree), so every run gives the
// same bits.
__global__ void __launch_bounds__(kReduceThreads)
render_core_bwd_reduce_kernel(const float* __restrict__ z0_part,
                              float* __restrict__ g_z0a,
                              float* __restrict__ g_z0r, int R, int K) {
  __shared__ float buf[kReduceThreads];
  const int col = blockIdx.x;
  float v = 0.f;
  for (int r = threadIdx.x; r < R; r += kReduceThreads) {
    v += z0_part[(size_t)r * 4 * K + col];
  }
  buf[threadIdx.x] = v;
  __syncthreads();
  for (int w = kReduceThreads / 2; w > 0; w >>= 1) {
    if (threadIdx.x < w) buf[threadIdx.x] += buf[threadIdx.x + w];
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    const int c = col / K, k = col % K;
    if (c == 0) {
      g_z0a[k] = buf[0];
    } else {
      g_z0r[k * 3 + (c - 1)] = buf[0];
    }
  }
}

}  // namespace

// C entry point (bound with ctypes).  Pointers are device pointers to
// contiguous f32 arrays; the caller checks shapes and allocates the scratch
// `trans` (R*S*K floats) and `z0_part` (R*4*K floats).  Launches both kernels
// on `stream` and returns the first cudaGetLastError() that is not 0 (0 on
// success); it never synchronises.
extern "C" int render_core_bwd(const float* z0a, const float* r1a,
                               const float* r2a, const float* ba,
                               const float* z0r, const float* r1r,
                               const float* r2r, const float* br,
                               const float* zpts, const float* dpts,
                               const float* g_rgb, const float* g_depth,
                               const float* g_acc, const float* g_ldj,
                               float* g_z0a, float* g_r1a, float* g_r2a,
                               float* g_ba, float* g_z0r, float* g_r1r,
                               float* g_r2r, float* g_br, float* trans,
                               float* z0_part, int R, int S, int K, int F,
                               int compute_log_det, void* stream) {
  if (R < 0 || S < 1 || K < 1 || F < 1) return (int)cudaErrorInvalidValue;
  const int chunk = staging_chunk(S, F);
  if (chunk < 1) return (int)cudaErrorInvalidValue;  // F too large to stage
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (R > 0) {
    const size_t smem = (size_t)kWarpsPerBlock * chunk * (24 * F + 2) * sizeof(float);
    const dim3 grid((R + kWarpsPerBlock - 1) / kWarpsPerBlock);
    render_core_bwd_kernel<<<grid, kWarpsPerBlock * 32, smem, st>>>(
        z0a, r1a, r2a, ba, z0r, r1r, r2r, br, zpts, dpts, g_rgb, g_depth,
        g_acc, g_ldj, g_r1a, g_r2a, g_ba, g_r1r, g_r2r, g_br, trans, z0_part,
        R, S, K, F, chunk, compute_log_det);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  render_core_bwd_reduce_kernel<<<4 * K, kReduceThreads, 0, st>>>(
      z0_part, g_z0a, g_z0r, R, K);
  return (int)cudaGetLastError();
}
