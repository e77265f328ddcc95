// Render-core backward for Hopper (sm_90a): the gradient of the render-core
// forward (render_core.cu) with respect to the shared base draws and every
// per-point flow parameter.  One CTA per ray; its warps split the ray's
// samples into segments and join them with segmented transmittance scans.
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
// Members: as the forward (render_core.cu), a launch may cover M ensemble
// members, member-major rays, rpm a member, each reading its member's z0
// rows; the z0 gradients are then each member's sums over its own points,
// (M, K, 1) and (M, K, 3), reduced in the same fixed order as one member's.
//
// What bounds it on an H100: operations.  It reads the forward's 24F+2
// floats per point and writes 24F gradients per point: at the flagship train
// tile (640 rays x 128 samples, K=32, F=4) about 64 MB, ~0.02 ms at
// 3.35 TB/s.  It recomputes the forward and runs the reverse sweeps for every
// (point, draw): about 825 f32 operations each at F=4, ~2.2 GFLOP, ~0.03 ms
// at 67 TFLOP/s (chip_smoke.py:render_core_bwd_work counts them, each
// transcendental as one).  The card issues more: 2,162 instructions per
// (point, draw) at F=4 in train mode, 98 of them on the multi-function unit
// (phase A 481 / 40, phase B 1,681 / 58; this file's SASS,
// scripts/sass_loops.py), 0.17 ms at the train tile at one warp
// instruction a clock per scheduler and 1.98 GHz.  The earlier design gave
// one warp to a ray and walked its 128 samples in order: 640 warps at the
// train tile, ~5 per SM, each a dependent chain, 58-62x the bound.
//
// What the design does about it:
//   * Segments.  A CTA of kSegWarps warps owns one ray; warp w owns a
//     contiguous segment of at most kMaxSeg samples, lane k owns draw k
//     (lane groups of 32 when K > 32, idle lanes with zero cotangents when
//     K < 32).  At the train tile that is 5,120 warps instead of 640.
//     Longer rays go in rounds of kSegWarps segments, the last first.
//   * Phase A, all segments at once.  Each warp stages its segment's
//     parameters into shared memory (coalesced), recomputes both chains per
//     (point, draw), and keeps per sample the segment-local exclusive
//     transmittance in shared memory.  It forms the segment's product of x
//     (P) and its (M, Y) pair, the affine map C_in = Y + P C_out of the C
//     recurrence across the segment (Y = sum_s g_T[s] T_local[s]; JAX's
//     pairs, render_core.py:421-431).
//   * The join, one warp, fixed order: T at each segment's start is the
//     exclusive product of the earlier P; C at each segment's end is the
//     suffix composition of the later (P, Y).  Rounds carry C backwards
//     and take T at their start from a density-only pre-pass.  No global
//     transmittance scratch: the (R*S*K) `trans` buffer of the earlier
//     design is gone, and T is never recovered by dividing by x.
//   * Phase B, each segment in reverse: T_s = T_start * T_local[s], C in a
//     register, the composite backward, then both chains' reverse sweeps
//     interleaved step by step.  Each step's input and tanh are kept in
//     registers from the recompute (F is a template bound: exact at F = 4,
//     a guarded bound of kMaxF otherwise), not recomputed from z0.
//   * Any F above kMaxF takes a generic path: nothing is staged (each
//     warp reads its segment's parameters from device memory, through L1,
//     so shared memory does not grow with F), and each step's input is
//     recomputed from z0 (O(F^2) step evaluations a draw).  The cut of the
//     ray is the same, so the backward takes every F the forward takes (the
//     forward's bound: one sample a ring stage must fit, F <= 146).
//   * Per-point gradients, summed over the draws through shared memory:
//     each lane writes a step's 18 gradients to its row, then lane j sums
//     column j over the 32 rows in a fixed order and stores it.  Later lane
//     groups add to what the same lane stored.  No atomics, no butterflies:
//     every run gives the same bits.
//   * z0 partials: each warp sums its draws' z0 gradients over its
//     segments; the CTA folds the warps in order into the ray's row of the
//     (R, 4K) partials, and a second kernel sums the R rows of each column
//     in a fixed order.

#include "render_core.cuh"

namespace {

constexpr int kMaxF = 8;           // flow steps the staged path keeps in registers
constexpr int kGradsPerStep = 18;  // density 3 + rgb 15 per flow step
constexpr int kRedStride = kGradsPerStep + 1;  // odd: rows land on distinct banks
constexpr int kReduceThreads = 256;

__device__ __forceinline__ float sign_f(float x) {  // jnp.sign: sign(0) = 0
  return (float)((x > 0.f) - (x < 0.f));
}

// Shared memory, in floats.  Per warp: the staged segment (rounded to 16
// bytes; none on the generic path, F > kMaxF), its local transmittance
// (seg x 32) and the reduction rows (32 x kRedStride).  Per CTA: P, Y,
// T_start, C_end and the z0 fold (kSegWarps x 32 each, the fold x4), and T
// at each round's start.
__host__ __device__ inline int stage_floats(int seg, int F) {
  return F > kMaxF ? 0 : (seg * (24 * F + 2) + 3) & ~3;
}
__host__ __device__ inline int warp_floats(int seg, int F) {
  return stage_floats(seg, F) + seg * 32 + 32 * kRedStride;
}
inline size_t bwd_smem_bytes(int S, int F) {
  const SegPlan pl = seg_plan(S);
  const size_t floats = (size_t)kSegWarps * warp_floats(pl.seg, F) +
                        (size_t)kSegWarps * 32 * 8 + (size_t)(pl.rounds + 1) * 32;
  return floats * sizeof(float);
}

// Steps [0, n) of both chains from (za; z0, z1, z2).  FMAX > 0: unrolled
// to FMAX with a guard; FMAX = 0 (the generic path): a runtime loop.
template <int FMAX>
__device__ __forceinline__ void chain_steps(float& za, float& z0, float& z1, float& z2,
                                            const float* q1a, const float* q2a,
                                            const float* qba, const float* q1,
                                            const float* q2, const float* qb, int F,
                                            int n) {
  if constexpr (FMAX > 0) {
#pragma unroll
    for (int f = 0; f < FMAX; ++f)
      if (f < n) density_step(za, q1a, q2a, qba, f);
#pragma unroll
    for (int f = 0; f < FMAX; ++f) {
      if (f < n) {
        float t0, t1, t2;
        rgb_tanh(q2, qb, f, F, z0, z1, z2, t0, t1, t2);
        rgb_update(q1, f, F, t0, t1, t2, z0, z1, z2);
      }
    }
  } else {
    for (int f = 0; f < n; ++f) density_step(za, q1a, q2a, qba, f);
    for (int f = 0; f < n; ++f) {
      float t0, t1, t2;
      rgb_tanh(q2, qb, f, F, z0, z1, z2, t0, t1, t2);
      rgb_update(q1, f, F, t0, t1, t2, z0, z1, z2);
    }
  }
}

// Where lane j stores the draws' sum of column j of a step's gradients.
struct GradDst {
  float* base;
  int pstride, eoff;
};

// Step f of both chains in reverse for one draw: (zf, t) the density
// step's input and tanh, (y, tr) the rgb step's; gza / gz hold the
// cotangents of the steps' outputs on entry and of their inputs on return.
// The step's 18 per-point gradients are summed over the warp's 32 draws
// through `red` and stored at point p (added to what is there unless
// `first`; lanes 18-23 zero the lower triangles).
__device__ __forceinline__ void reverse_step(
    int f, int F, float zf, float t, const float* y, const float* tr,
    const float* q1a, const float* q2a, const float* q1, const float* q2,
    float gla, float glr, bool cld, float& gza, float& gz0, float& gz1, float& gz2,
    float* red, int lane, GradDst dst, size_t p, bool first) {
  float* row = red + lane * kRedStride;
  {  // density step f
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
    row[0] = gr1; row[1] = gr2; row[2] = gp;
  }
  {  // rgb step f
    const float y0 = y[0], y1 = y[1], y2 = y[2];
    const float t0 = tr[0], t1 = tr[1], t2 = tr[2];
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
    row[3] = g1_00; row[4] = g1_01; row[5] = g1_02;
    row[6] = g1_11; row[7] = g1_12; row[8] = g1_22;
    row[9] = g2_00; row[10] = g2_01; row[11] = g2_02;
    row[12] = g2_11; row[13] = g2_12; row[14] = g2_22;
    row[15] = gp0; row[16] = gp1; row[17] = gp2;
  }
  __syncwarp();
  // the step's per-point gradients, summed over the 32 draws in a fixed
  // order (four interleaved partial sums, then a tree)
  if (lane < kGradsPerStep) {
    float s0 = 0.f, s1 = 0.f, s2 = 0.f, s3 = 0.f;
#pragma unroll
    for (int j = 0; j < 32; j += 4) {
      s0 += red[(j + 0) * kRedStride + lane];
      s1 += red[(j + 1) * kRedStride + lane];
      s2 += red[(j + 2) * kRedStride + lane];
      s3 += red[(j + 3) * kRedStride + lane];
    }
    const float v = (s0 + s1) + (s2 + s3);
    float* out = dst.base + p * dst.pstride + dst.eoff * F + f;
    *out = first ? v : *out + v;
  } else if (lane < 24 && first) {
    dst.base[p * dst.pstride + dst.eoff * F + f] = 0.f;
  }
  __syncwarp();
}

// FMAX > 0: the staged path, F <= FMAX (EXACT: F == FMAX at compile time);
// FMAX = 0: the generic path, any F, nothing staged, step inputs recomputed.
template <int FMAX, bool EXACT>
__global__ void __launch_bounds__(kSegThreads, 2)
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
                       float* __restrict__ z0_part,
                       int R, int rpm, int S, int K, int F_rt, int seg, int rounds,
                       int compute_log_det) {
  constexpr bool kStaged = FMAX > 0;
  extern __shared__ float smem[];
  const int F = EXACT ? FMAX : F_rt;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int ray = blockIdx.x;
  const int RL = kSegWarps * seg;  // samples a round covers
  const bool cld = compute_log_det != 0;
  z0a += (size_t)(ray / rpm) * K;  // this ray's member's draws
  z0r += (size_t)(ray / rpm) * K * 3;

  // this warp's area: the staged segment (staged path), laid out as one
  // run per array, then its local transmittance and reduction rows
  float* st = smem + (size_t)warp * warp_floats(seg, F);
  float* tloc = st + stage_floats(seg, F);  // [seg][32]
  float* red = tloc + seg * 32;             // [32][kRedStride]
  // the CTA's area
  float* cta = smem + (size_t)kSegWarps * warp_floats(seg, F);
  float* segP = cta;
  float* segY = segP + kSegWarps * 32;
  float* Tst = segY + kSegWarps * 32;
  float* Cend = Tst + kSegWarps * 32;
  float* z0f = Cend + kSegWarps * 32;  // [kSegWarps][4][32]
  float* tround = z0f + kSegWarps * 4 * 32;  // [rounds + 1][32]

  // where lane j < 18 stores the sum of column j of a step's gradients:
  // dst = base + p * pstride + eoff * F + f; lanes 18-23 zero the lower
  // triangles of g_r1_r / g_r2_r (elements 3, 6, 7)
  GradDst gdst{nullptr, 0, 0};
  {
    // upper elements 0 1 2 4 5 8 of a 3x3 block, lower ones 3 6 7
    const auto upper = [](int i) { return i + (i >= 3) + 2 * (i >= 5); };
    const auto lower = [](int i) { return 3 + 3 * (i >= 1) + (i >= 2); };
    if (lane == 0) gdst = {g_r1a, F, 0};
    else if (lane == 1) gdst = {g_r2a, F, 0};
    else if (lane == 2) gdst = {g_ba, F, 0};
    else if (lane < 9) gdst = {g_r1r, 9 * F, upper(lane - 3)};
    else if (lane < 15) gdst = {g_r2r, 9 * F, upper(lane - 9)};
    else if (lane < 18) gdst = {g_br, 3 * F, lane - 15};
    else if (lane < 21) gdst = {g_r1r, 9 * F, lower(lane - 18)};
    else if (lane < 24) gdst = {g_r2r, 9 * F, lower(lane - 21)};
  }

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

    // ---- pre-pass (rays longer than one round): T at each round's start,
    // from the density chain alone, rounds in order ----
    if (rounds > 1) {
      if (warp == 0) tround[lane] = 1.f;
      for (int r = 0; r + 1 < rounds; ++r) {
        const int a = min(S, r * RL + warp * seg);
        const int b = min(S, a + seg);
        float P = 1.f;
        for (int s = a; s < b; ++s) {
          const size_t p = (size_t)ray * S + s;
          float za = za0;
          for (int f = 0; f < F; ++f)
            density_step(za, r1a + p * F, r2a + p * F, ba + p * F, f);
          P = P * (expf(-softplus_f(za) * dpts[p]) + kTransEps);
        }
        segP[warp * 32 + lane] = P;
        __syncthreads();
        if (warp == 0) {
          float T = tround[r * 32 + lane];
          for (int w = 0; w < kSegWarps; ++w) T = T * segP[w * 32 + lane];
          tround[(r + 1) * 32 + lane] = T;
        }
        __syncthreads();
      }
    }

    float C_carry = 0.f;  // warp 0: C at the last sample of the round before
    float gz0a = 0.f, gz0r0 = 0.f, gz0r1 = 0.f, gz0r2 = 0.f;

    for (int r = rounds - 1; r >= 0; --r) {
      const int a = min(S, r * RL + warp * seg);
      const int n = min(S, a + seg) - a;  // this segment's samples (may be 0)
      const size_t p0 = (size_t)ray * S + a;

      // the segment's arrays: staged into shared memory, or (generic path)
      // read where they lie
      const float *s_r1a, *s_r2a, *s_ba, *s_r1r, *s_r2r, *s_br, *s_z, *s_d;
      if constexpr (kStaged) {
        float* w_r1a = st;
        float* w_r2a = w_r1a + seg * F;
        float* w_ba = w_r2a + seg * F;
        float* w_r1r = w_ba + seg * F;
        float* w_r2r = w_r1r + seg * 9 * F;
        float* w_br = w_r2r + seg * 9 * F;
        float* w_z = w_br + seg * 3 * F;
        float* w_d = w_z + seg;
        __syncwarp();  // the previous round's phase B is done with the staging
        stage(w_r1a, r1a + p0 * F, n * F, lane);
        stage(w_r2a, r2a + p0 * F, n * F, lane);
        stage(w_ba, ba + p0 * F, n * F, lane);
        stage(w_r1r, r1r + p0 * 9 * F, n * 9 * F, lane);
        stage(w_r2r, r2r + p0 * 9 * F, n * 9 * F, lane);
        stage(w_br, br + p0 * 3 * F, n * 3 * F, lane);
        stage(w_z, zpts + p0, n, lane);
        stage(w_d, dpts + p0, n, lane);
        __syncwarp();
        s_r1a = w_r1a; s_r2a = w_r2a; s_ba = w_ba; s_r1r = w_r1r;
        s_r2r = w_r2r; s_br = w_br; s_z = w_z; s_d = w_d;
      } else {
        s_r1a = r1a + p0 * F; s_r2a = r2a + p0 * F; s_ba = ba + p0 * F;
        s_r1r = r1r + p0 * 9 * F; s_r2r = r2r + p0 * 9 * F; s_br = br + p0 * 3 * F;
        s_z = zpts + p0; s_d = dpts + p0;
      }

      // ---- phase A: the segment's product P and its (P, Y) map ----
      float Tl = 1.f, Y = 0.f;
      for (int i = 0; i < n; ++i) {
        float za = za0, z0 = zr0, z1 = zr1, z2 = zr2;
        chain_steps<FMAX>(za, z0, z1, z2, s_r1a + i * F, s_r2a + i * F, s_ba + i * F,
                          s_r1r + i * 9 * F, s_r2r + i * 9 * F, s_br + i * 3 * F, F, F);
        const float e = expf(-softplus_f(za) * s_d[i]);
        float gw = Ga + Gd * s_z[i];
        gw = gw + G0 * sigmoid_f(z0);
        gw = gw + G1 * sigmoid_f(z1);
        gw = gw + G2 * sigmoid_f(z2);
        tloc[i * 32 + lane] = Tl;
        Y = Y + (gw * (1.f - e)) * Tl;
        Tl = Tl * (e + kTransEps);
      }
      segP[warp * 32 + lane] = Tl;
      segY[warp * 32 + lane] = Y;
      __syncthreads();

      // ---- the join, fixed order: C at each segment's end (suffix), T at
      // each segment's start (exclusive prefix) ----
      if (warp == 0) {
        float C = C_carry;
        for (int w = kSegWarps - 1; w >= 0; --w) {
          Cend[w * 32 + lane] = C;
          C = segY[w * 32 + lane] + segP[w * 32 + lane] * C;
        }
        C_carry = C;
        float T = rounds > 1 ? tround[r * 32 + lane] : 1.f;
        for (int w = 0; w < kSegWarps; ++w) {
          Tst[w * 32 + lane] = T;
          T = T * segP[w * 32 + lane];
        }
      }
      __syncthreads();

      // ---- phase B: the segment in reverse ----
      float C = Cend[warp * 32 + lane];
      const float T0 = Tst[warp * 32 + lane];
      for (int i = n - 1; i >= 0; --i) {
        const size_t p = p0 + i;
        const float* q1a = s_r1a + i * F;
        const float* q2a = s_r2a + i * F;
        const float* qba = s_ba + i * F;
        const float* q1 = s_r1r + i * 9 * F;
        const float* q2 = s_r2r + i * 9 * F;
        const float* qb = s_br + i * 3 * F;

        // this point's forward; the staged path keeps each step's input
        // and tanh in registers
        constexpr int NF = kStaged ? FMAX : 1;
        float xa[NF], ta[NF], xr[3 * NF], tr[3 * NF];
        float za = za0, z0 = zr0, z1 = zr1, z2 = zr2;
        if constexpr (kStaged) {
#pragma unroll
          for (int f = 0; f < FMAX; ++f) {
            if (f < F) {
              xa[f] = za;
              ta[f] = density_step(za, q1a, q2a, qba, f);
            }
          }
#pragma unroll
          for (int f = 0; f < FMAX; ++f) {
            if (f < F) {
              xr[3 * f + 0] = z0; xr[3 * f + 1] = z1; xr[3 * f + 2] = z2;
              float t0, t1, t2;
              rgb_tanh(q2, qb, f, F, z0, z1, z2, t0, t1, t2);
              tr[3 * f + 0] = t0; tr[3 * f + 1] = t1; tr[3 * f + 2] = t2;
              rgb_update(q1, f, F, t0, t1, t2, z0, z1, z2);
            }
          }
        } else {
          chain_steps<0>(za, z0, z1, z2, q1a, q2a, qba, q1, q2, qb, F, F);
        }
        const float d = s_d[i];
        const float sp = softplus_f(za);
        const float sg = sigmoid_f(za);  // softplus'
        const float e = expf(-sp * d);
        const float x = e + kTransEps;
        const float Ts = T0 * tloc[i * 32 + lane];
        const float w = (1.f - e) * Ts;
        const float v0 = sigmoid_f(z0), v1 = sigmoid_f(z1), v2 = sigmoid_f(z2);

        // ---- composite backward ----
        float gw = Ga + Gd * s_z[i];
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

        // ---- both chains in reverse, a step of each at a time ----
        if constexpr (kStaged) {
#pragma unroll
          for (int f = FMAX - 1; f >= 0; --f) {
            if (f >= F) continue;
            reverse_step(f, F, xa[f], ta[f], xr + 3 * f, tr + 3 * f, q1a, q2a, q1, q2,
                         gla, glr, cld, gza, gz0, gz1, gz2, red, lane, gdst, p, first);
          }
        } else {
          for (int f = F - 1; f >= 0; --f) {
            // step f's inputs, recomputed from z0, then its tanh
            float ya = za0, y[3] = {zr0, zr1, zr2}, t[3];
            chain_steps<0>(ya, y[0], y[1], y[2], q1a, q2a, qba, q1, q2, qb, F, f);
            const float yf = ya;
            const float tf = density_step(ya, q1a, q2a, qba, f);
            rgb_tanh(q2, qb, f, F, y[0], y[1], y[2], t[0], t[1], t[2]);
            reverse_step(f, F, yf, tf, y, t, q1a, q2a, q1, q2, gla, glr, cld, gza, gz0,
                         gz1, gz2, red, lane, gdst, p, first);
          }
        }
        gz0a += gza;
        gz0r0 += gz0;
        gz0r1 += gz1;
        gz0r2 += gz2;
      }
    }

    // this ray's z0 partials: the warps' sums folded in order, columns
    // [a | r0 | r1 | r2] x K
    z0f[(warp * 4 + 0) * 32 + lane] = gz0a;
    z0f[(warp * 4 + 1) * 32 + lane] = gz0r0;
    z0f[(warp * 4 + 2) * 32 + lane] = gz0r1;
    z0f[(warp * 4 + 3) * 32 + lane] = gz0r2;
    __syncthreads();
    if (warp == 0 && active) {
      float* part = z0_part + (size_t)ray * 4 * K + k;
      for (int c = 0; c < 4; ++c) {
        float v = 0.f;
        for (int w = 0; w < kSegWarps; ++w) v += z0f[(w * 4 + c) * 32 + lane];
        part[(size_t)c * K] = v;
      }
    }
    __syncthreads();  // the fold is read before the next lane group writes
  }
}


// g_z0: column `blockIdx.x` of member `blockIdx.y`'s rows of the (R, 4K)
// partials, its rpm rays, summed in a fixed order (strided per thread, then
// a tree), so every run gives the same bits, and a member's sums the bits
// of a launch of that member alone.
__global__ void __launch_bounds__(kReduceThreads)
render_core_bwd_reduce_kernel(const float* __restrict__ z0_part,
                              float* __restrict__ g_z0a,
                              float* __restrict__ g_z0r, int rpm, int K) {
  __shared__ float buf[kReduceThreads];
  const int col = blockIdx.x;
  const size_t member = blockIdx.y;
  z0_part += member * rpm * 4 * K;
  g_z0a += member * K;
  g_z0r += member * K * 3;
  float v = 0.f;
  for (int r = threadIdx.x; r < rpm; r += kReduceThreads) {
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

template <int FMAX, bool EXACT>
cudaError_t launch_bwd(size_t smem, cudaStream_t st, const float* z0a,
                       const float* r1a, const float* r2a, const float* ba,
                       const float* z0r, const float* r1r, const float* r2r,
                       const float* br, const float* zpts, const float* dpts,
                       const float* g_rgb, const float* g_depth,
                       const float* g_acc, const float* g_ldj, float* g_r1a,
                       float* g_r2a, float* g_ba, float* g_r1r, float* g_r2r,
                       float* g_br, float* z0_part, int R, int rpm, int S, int K,
                       int F, int compute_log_det) {
  auto kern = render_core_bwd_kernel<FMAX, EXACT>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const SegPlan pl = seg_plan(S);
  kern<<<R, kSegThreads, smem, st>>>(
      z0a, r1a, r2a, ba, z0r, r1r, r2r, br, zpts, dpts, g_rgb, g_depth, g_acc,
      g_ldj, g_r1a, g_r2a, g_ba, g_r1r, g_r2r, g_br, z0_part, R, rpm, S, K, F,
      pl.seg, pl.rounds, compute_log_det);
  return cudaGetLastError();
}

}  // namespace

// C entry point (bound with ctypes).  Pointers are device pointers to
// contiguous f32 arrays; the caller checks shapes and allocates the scratch
// `z0_part` (R*4*K floats).  R rays in all, `members` members of R /
// members rays each; g_z0a and g_z0r hold each member's K rows, in order.
// F = 4 takes the compile-time kernel, F <= 8
// the staged one with a runtime F, any larger F the generic one.  A ray's
// rounds must fit shared memory (S up to ~10^5); otherwise it returns
// cudaErrorInvalidValue.  Launches both kernels on `stream` and returns the
// first error that is not 0 (0 on success); it never synchronises.
extern "C" int render_core_bwd(const float* z0a, const float* r1a,
                               const float* r2a, const float* ba,
                               const float* z0r, const float* r1r,
                               const float* r2r, const float* br,
                               const float* zpts, const float* dpts,
                               const float* g_rgb, const float* g_depth,
                               const float* g_acc, const float* g_ldj,
                               float* g_z0a, float* g_r1a, float* g_r2a,
                               float* g_ba, float* g_z0r, float* g_r1r,
                               float* g_r2r, float* g_br, float* z0_part,
                               int R, int S, int K, int F, int compute_log_det,
                               int members, void* stream) {
  if (R < 0 || S < 1 || K < 1 || F < 1 || members < 1 || R % members != 0)
    return (int)cudaErrorInvalidValue;
  const int rpm = R / members;
  const size_t smem = bwd_smem_bytes(S, F);
  if (smem > (size_t)kMaxDynSmem) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (R > 0) {
    const auto launch = F == 4 ? &launch_bwd<4, true>
                        : F <= kMaxF ? &launch_bwd<kMaxF, false>
                                     : &launch_bwd<0, false>;
    const cudaError_t err = launch(smem, st, z0a, r1a, r2a, ba, z0r, r1r, r2r, br, zpts,
                                   dpts, g_rgb, g_depth, g_acc, g_ldj, g_r1a, g_r2a, g_ba,
                                   g_r1r, g_r2r, g_br, z0_part, R, rpm, S, K, F,
                                   compute_log_det);
    if (err != cudaSuccess) return (int)err;
  }
  render_core_bwd_reduce_kernel<<<dim3(4 * K, members), kReduceThreads, 0, st>>>(
      z0_part, g_z0a, g_z0r, rpm, K);
  return (int)cudaGetLastError();
}
