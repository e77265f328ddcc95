// Render-core forward for Hopper (sm_90a): both triangular-Sylvester flow
// stacks + the K-sample alpha composite.  One CTA per ray; its warps split
// the ray's samples into segments, composite each from T = 1, and join them.
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
// Members: a launch may cover M ensemble members, as the vmap of JAX's
// ensemble step gives the Pallas kernel a leading member axis in its grid.
// Rays are member-major, `rpm` rays a member (rpm = R: one member), and ray
// r draws from member r / rpm's z0 rows (z0_a (M, K, 1), z0_r (M, K, 3)).
// Nothing else in a ray's arithmetic depends on its member.
//
// What bounds it on an H100.  By chip_smoke.py's bound, bytes: each point
// carries 24F+2 f32 inputs (r1/r2/b of both families + depth + interval:
// 98 floats, 392 B at F=4), read once; at the serving tile (8192 rays x 128
// samples) ~416 MB, 0.124 ms at 3.35 TB/s, against ~160 f32 operations per
// (point, draw) (each transcendental counted as one), ~0.08 ms at 67
// TFLOP/s.  What the card must issue is more.  The accurate libm tanhf /
// expf and the sigmoid's division take, per (point, draw) in test mode at
// F=4, 40 multi-function-unit (MUFU) instructions (16 tanh and 3 sigmoids,
// an ex2 and a rcp each; an ex2 each for softplus and alpha) among 480
// instructions in all (this file's SASS, scripts/sass_loops.py; train mode
// 43 among 1,048).  At 16 MUFU results a clock per SM and 1.98 GHz the
// MUFU work alone is 0.32 ms at the serving tile; issuing 480 warp
// instructions a (point, draw), one a clock per scheduler, is 0.48 ms.
// So the instructions, not the bytes, set the floor.
//
// What the design does about it:
//   * Segments, as in the backward (render_core_bwd.cu): a CTA of kSegWarps
//     warps owns a ray, warp w a contiguous segment of at most kMaxSeg
//     samples, lane k draw k (lane groups of 32 when K > 32, idle lanes when
//     K < 32).  Each warp composites its segment from T = 1 and keeps its
//     product P of x = 1 - alpha + 1e-10.  At the training tile that is
//     5,120 warps instead of 640.  Longer rays go in rounds, in order.
//   * The join, one warp, fixed order: out = sum_w T_start,w * out_w with
//     T_start the exclusive product of the earlier P (and of the earlier
//     rounds); the log-det sums add the warps' in order, then a fixed
//     butterfly over the draws.  No atomics: every run gives the same bits.
//   * Loads overlap the flows: each warp stages its segment through a ring
//     of two stages of kChunk samples, filled by cp.async (16 bytes a lane
//     where aligned), one group per stage, so chunk c+1 lands while chunk c
//     is computed.  Each input array is contiguous per segment, so every
//     copy is a plain run of bytes.  ~3 KB of shared memory a warp at F=4
//     (the earlier design's 12 KB held an SM to 16 warps), so registers
//     set the warps an SM holds: 128 a thread, 16 warps, measured faster
//     than 80 (24 warps, spills) or 64 (32 warps, more spills).
//   * F = 4 and the mode are compile-time in the kernel the flagship
//     launches, so each sample's chains unroll into straight-line code; any
//     other F takes the same kernel with a runtime F.
// Math is f32 throughout with the accurate libm functions: no fast-math,
// no approximate intrinsic.

#include "render_core.cuh"

namespace {

constexpr int kChunk = 4;   // samples a ring stage holds, at most
constexpr int kStages = 2;  // the ring: chunk c+1 loads while chunk c computes
constexpr int kOuts = 6;    // a warp's partials per draw: rgb, depth, acc, P

// Floats of one ring stage for `ch` samples: each array's run rounded to 4
// floats, so every run starts 16-byte aligned.
__host__ __device__ inline int run4(int n) { return (n + 3) & ~3; }
__host__ __device__ inline int stage_floats(int ch, int F) {
  return 3 * run4(ch * F) + 2 * run4(ch * 9 * F) + run4(ch * 3 * F) + 2 * run4(ch);
}
inline size_t fwd_smem_bytes(int ch, int F) {
  return ((size_t)kSegWarps * kStages * stage_floats(ch, F) +
          (size_t)kSegWarps * kOuts * 32) * sizeof(float);
}

struct Stage {  // one ring stage's arrays
  float *r1a, *r2a, *ba, *r1r, *r2r, *br, *z, *d;
};

__device__ __forceinline__ Stage stage_at(float* base, int ch, int F) {
  Stage s;
  s.r1a = base;
  s.r2a = s.r1a + run4(ch * F);
  s.ba = s.r2a + run4(ch * F);
  s.r1r = s.ba + run4(ch * F);
  s.r2r = s.r1r + run4(ch * 9 * F);
  s.br = s.r2r + run4(ch * 9 * F);
  s.z = s.br + run4(ch * 3 * F);
  s.d = s.z + run4(ch);
  return s;
}

template <int FC, bool CLD>
__global__ void __launch_bounds__(kSegThreads, 2)
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
                       int R, int rpm, int S, int K, int F_rt, int seg, int rounds, int ch) {
  extern __shared__ __align__(16) float smem[];
  const int F = FC > 0 ? FC : F_rt;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int ray = blockIdx.x;
  const int RL = kSegWarps * seg;  // samples a round covers
  const int sf = stage_floats(ch, F);
  float* ring = smem + (size_t)warp * kStages * sf;
  float* part = smem + (size_t)kSegWarps * kStages * sf;  // [kSegWarps][kOuts][32]

  float lane_la = 0.f, lane_lr = 0.f;  // warp 0: this lane's log-det sums
  z0a += (size_t)(ray / rpm) * K;  // this ray's member's draws
  z0r += (size_t)(ray / rpm) * K * 3;

  for (int kb = 0; kb < K; kb += 32) {
    const int k = kb + lane;
    const bool active = k < K;
    const int kk = active ? k : 0;
    const float za0 = z0a[kk];
    const float zr0 = z0r[kk * 3 + 0];
    const float zr1 = z0r[kk * 3 + 1];
    const float zr2 = z0r[kk * 3 + 2];

    // warp 0: the ray's maps so far and T at the next round's start
    float o_r = 0.f, o_g = 0.f, o_b = 0.f, o_d = 0.f, o_a = 0.f;
    float T_round = 1.f;
    float o_la = 0.f, o_lr = 0.f;  // this warp's log-det sums, all its segments

    for (int r = 0; r < rounds; ++r) {
      const int a = min(S, r * RL + warp * seg);
      const int n = min(S, a + seg) - a;  // this segment's samples (may be 0)
      const int nch = (n + ch - 1) / ch;

      // stage chunk c (samples a + c*ch ...) into ring slot c % kStages; one
      // cp.async group per call, empty past the segment's end
      auto issue = [&](int c) {
        if (c < nch) {
          const int m = min(ch, n - c * ch);
          const size_t p0 = (size_t)ray * S + a + c * ch;
          const Stage st = stage_at(ring + (c % kStages) * sf, ch, F);
          stage_async(st.r1a, r1a + p0 * F, m * F, lane);
          stage_async(st.r2a, r2a + p0 * F, m * F, lane);
          stage_async(st.ba, ba + p0 * F, m * F, lane);
          stage_async(st.r1r, r1r + p0 * 9 * F, m * 9 * F, lane);
          stage_async(st.r2r, r2r + p0 * 9 * F, m * 9 * F, lane);
          stage_async(st.br, br + p0 * 3 * F, m * 3 * F, lane);
          stage_async(st.z, zpts + p0, m, lane);
          stage_async(st.d, dpts + p0, m, lane);
        }
        cp_async_commit();
      };

      float T = 1.f;
      float out_r = 0.f, out_g = 0.f, out_b = 0.f, out_d = 0.f, out_a = 0.f;
      float la = 0.f, lr = 0.f;

      __syncwarp();  // the previous round's chunks are fully consumed
      issue(0);
      issue(1);
      for (int c = 0; c < nch; ++c) {
        cp_async_wait<kStages - 1>();  // chunk c has landed (this lane's copies)
        __syncwarp();                  // ... and every lane's
        const Stage st = stage_at(ring + (c % kStages) * sf, ch, F);
        const int m = min(ch, n - c * ch);
        for (int i = 0; i < m; ++i) {
          // ---- density chain, Z = 1 (the flip is the identity) ----
          const float* q1a = st.r1a + i * F;
          const float* q2a = st.r2a + i * F;
          const float* qba = st.ba + i * F;
          // this sample's log-det terms are summed apart, then added to the
          // running per-lane sums: fewer additions at the large magnitude
          float la_s = 0.f, lr_s = 0.f;
          float za = za0;
#pragma unroll
          for (int f = 0; f < F; ++f) {
            const float t = density_step(za, q1a, q2a, qba, f);
            if (CLD) la_s += logdet_term(t, q1a[f], q2a[f]);
          }

          // ---- rgb chain, Z = 3; r[(i*3+j)*F + f], b[i*F + f] ----
          const float* q1 = st.r1r + i * 9 * F;
          const float* q2 = st.r2r + i * 9 * F;
          const float* qb = st.br + i * 3 * F;
          float z0 = zr0, z1 = zr1, z2 = zr2;
#pragma unroll
          for (int f = 0; f < F; ++f) {
            float t0, t1, t2;
            rgb_tanh(q2, qb, f, F, z0, z1, z2, t0, t1, t2);
            rgb_update(q1, f, F, t0, t1, t2, z0, z1, z2);
            if (CLD) {
              lr_s += logdet_term(t0, q1[0 * F + f], q2[0 * F + f]);
              lr_s += logdet_term(t1, q1[4 * F + f], q2[4 * F + f]);
              lr_s += logdet_term(t2, q1[8 * F + f], q2[8 * F + f]);
            }
          }

          // ---- composite step: the segment's exclusive transmittance ----
          const float sp = softplus_f(za);
          const float e = expf(-sp * st.d[i]);  // 1 - alpha
          const float w = (1.f - e) * T;
          T = T * (e + kTransEps);
          out_r += w * sigmoid_f(z0);
          out_g += w * sigmoid_f(z1);
          out_b += w * sigmoid_f(z2);
          out_d += w * st.z[i];
          out_a += w;
          if (CLD) {
            la += la_s + (za - sp);
            lr += lr_s + ((z0 - 2.f * softplus_f(z0)) + (z1 - 2.f * softplus_f(z1)) +
                          (z2 - 2.f * softplus_f(z2)));
          }
        }
        __syncwarp();   // every lane is done with the slot
        issue(c + kStages);
      }
      cp_async_wait<0>();  // no copy outlives the round (the empty groups)

      float* mine = part + warp * kOuts * 32 + lane;
      mine[0 * 32] = out_r;
      mine[1 * 32] = out_g;
      mine[2 * 32] = out_b;
      mine[3 * 32] = out_d;
      mine[4 * 32] = out_a;
      mine[5 * 32] = T;  // the segment's product of x
      __syncthreads();
      // ---- the join, fixed order ----
      if (warp == 0) {
        for (int w = 0; w < kSegWarps; ++w) {
          const float* q = part + w * kOuts * 32 + lane;
          o_r += T_round * q[0 * 32];
          o_g += T_round * q[1 * 32];
          o_b += T_round * q[2 * 32];
          o_d += T_round * q[3 * 32];
          o_a += T_round * q[4 * 32];
          T_round = T_round * q[5 * 32];
        }
      }
      __syncthreads();  // the partials are read before the next round writes
      o_la += la;  // the log-det sums need no T
      o_lr += lr;
    }

    if (CLD) {  // the warps' log-det sums, folded in order
      float* mine = part + warp * kOuts * 32 + lane;
      mine[0 * 32] = o_la;
      mine[1 * 32] = o_lr;
      __syncthreads();
      if (warp == 0) {
        float sa = 0.f, sr = 0.f;
        for (int w = 0; w < kSegWarps; ++w) {
          sa += part[(w * kOuts + 0) * 32 + lane];
          sr += part[(w * kOuts + 1) * 32 + lane];
        }
        if (active) {
          lane_la += sa;
          lane_lr += sr;
        }
      }
      __syncthreads();
    }
    if (warp == 0 && active) {
      const size_t rk = (size_t)ray * K + k;
      rgb[((size_t)ray * 3 + 0) * K + k] = o_r;
      rgb[((size_t)ray * 3 + 1) * K + k] = o_g;
      rgb[((size_t)ray * 3 + 2) * K + k] = o_b;
      depth[rk] = o_d;
      acc[rk] = o_a;
    }
  }

  if (warp == 0) {
    // per-ray log-det sums over all draws: fixed-order butterfly reduction
    for (int off = 16; off > 0; off >>= 1) {
      lane_la += __shfl_xor_sync(0xffffffffu, lane_la, off);
      lane_lr += __shfl_xor_sync(0xffffffffu, lane_lr, off);
    }
    if (lane == 0) {
      ldj[ray] = CLD ? lane_la : 0.f;
      ldj[(size_t)R + ray] = CLD ? lane_lr : 0.f;
    }
  }
}

template <int FC, bool CLD>
cudaError_t launch_fwd(size_t smem, cudaStream_t st, const float* z0a,
                       const float* r1a, const float* r2a, const float* ba,
                       const float* z0r, const float* r1r, const float* r2r,
                       const float* br, const float* zpts, const float* dpts,
                       float* rgb, float* depth, float* acc, float* ldj, int R,
                       int rpm, int S, int K, int F, int ch) {
  auto kern = render_core_fwd_kernel<FC, CLD>;
  const cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const SegPlan pl = seg_plan(S);
  kern<<<R, kSegThreads, smem, st>>>(z0a, r1a, r2a, ba, z0r, r1r, r2r, br, zpts,
                                     dpts, rgb, depth, acc, ldj, R, rpm, S, K, F, pl.seg,
                                     pl.rounds, ch);
  return cudaGetLastError();
}

}  // namespace

// C entry point (bound with ctypes).  Pointers are device pointers to
// contiguous f32 arrays; the caller checks shapes.  R rays in all, `members`
// members of R / members rays each (1: z0 is (K, .)).  Launches on `stream`
// and returns cudaGetLastError() (0 on success); it never synchronises.
// Returns cudaErrorInvalidValue when F is too large to stage one sample a
// stage, or the rays do not split evenly over the members.
extern "C" int render_core_fwd(const float* z0a, const float* r1a,
                               const float* r2a, const float* ba,
                               const float* z0r, const float* r1r,
                               const float* r2r, const float* br,
                               const float* zpts, const float* dpts,
                               float* rgb, float* depth, float* acc,
                               float* ldj, int R, int S, int K, int F,
                               int compute_log_det, int members, void* stream) {
  if (R < 0 || S < 1 || K < 1 || F < 1 || members < 1 || R % members != 0)
    return (int)cudaErrorInvalidValue;
  const int rpm = R / members;
  if (R == 0) return 0;
  int ch = kChunk;  // the largest stage that fits
  while (ch > 1 && fwd_smem_bytes(ch, F) > (size_t)kMaxDynSmem) --ch;
  const size_t smem = fwd_smem_bytes(ch, F);
  if (smem > (size_t)kMaxDynSmem) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (F == 4) {
    err = compute_log_det
              ? launch_fwd<4, true>(smem, st, z0a, r1a, r2a, ba, z0r, r1r, r2r, br,
                                    zpts, dpts, rgb, depth, acc, ldj, R, rpm, S, K, F, ch)
              : launch_fwd<4, false>(smem, st, z0a, r1a, r2a, ba, z0r, r1r, r2r, br,
                                     zpts, dpts, rgb, depth, acc, ldj, R, rpm, S, K, F, ch);
  } else {
    err = compute_log_det
              ? launch_fwd<0, true>(smem, st, z0a, r1a, r2a, ba, z0r, r1r, r2r, br,
                                    zpts, dpts, rgb, depth, acc, ldj, R, rpm, S, K, F, ch)
              : launch_fwd<0, false>(smem, st, z0a, r1a, r2a, ba, z0r, r1r, r2r, br,
                                     zpts, dpts, rgb, depth, acc, ldj, R, rpm, S, K, F, ch);
  }
  return (int)err;
}
