// NeRF trunk backward for Hopper (sm_90a): the weight and bias gradients of
// the trunk forward (trunk.cu) from the cotangents of h_alpha and h_rgb, on
// bf16 tensor cores with f32 accumulators.
//
// Replaces: cfnerf_tpu/ops/pallas/trunk.py:_bwd_top_kernel and
// cfnerf_tpu/ops/pallas/trunk.py:_bwd_bottom_kernel (both launched by
// _trunk_bwd, the custom VJP of pallas_encode).  Same arithmetic: the
// forward recomputed as trunk.cu computes it; both operands of every
// product rounded to bf16 (the cotangents too) and summed in f32; the relu
// mask taken from the bf16 activation; bias gradients summed from the f32
// gradient; the skip layer's gradient split between wsx and wsh, the views
// layer's between wvf and wvv; no gradient for the input.  dW comes out in f32 in the packed (out,
// in_padded) layout of the forward's weights (trunk.py:_layout), db in f32.
//
// What bounds it on an H100: operations.  At D8/W512 a point costs
// 4,626,176 multiply-adds (the weight gradients 2,348,800, the gradients
// through every layer but the x and view inputs 2,277,376): the flat
// training tile (640 rays x 128 samples = 81,920 points) is 758 GFLOP,
// 0.77 ms at the 989 TFLOP/s bf16 dense peak, against ~86 MB moved
// (chip_smoke.py:trunk_bwd_work counts both).  The recompute of the forward
// is this design's own cost, not the function's.
//
// What the design does about it, simply and not yet fast.  The TPU kernels
// keep a tile's activations in VMEM and add every tile's dW into resident
// accumulators across a sequential grid; an H100 block has 227 KB of shared
// memory and a grid in no order, so the work splits in two:
//   * trunk_bwd_data: one CTA of 16 warps per 64 rows, as trunk.cu.  It
//     recomputes the forward with trunk.cu's layer routine (trunk.cuh) and
//     writes every bf16 activation (the inputs, h_0..h_{D-1}, f, hv) to a
//     global scratch; then walks back through the heads and the layers, each
//     step one product on the tensor cores (g W, the B operand row-major),
//     with an epilogue that applies the relu mask, writes the bf16 gradient
//     to shared memory (the next step's A operand) and to a second scratch,
//     and sums each column's 64 f32 values for db in a fixed order (per
//     lane, then a butterfly), one row of partials per CTA.  Three (64, W)
//     bf16 buffers in shared memory, 216 KB at W=512.
//   * trunk_bwd_wgrad: dW = G^T H_in for every matrix at once.  A CTA owns a
//     128 x 128 tile of one dW and a contiguous range of rows: 8 warps of
//     64 x 32, 32-row chunks of G and H_in staged by cp.async into two
//     shared-memory stages.  The rows split into a few ranges (set by the
//     shape alone) so that the grid fills the card; each range writes its
//     own f32 partial.
//   * two reductions add the partials, dW over the row ranges and db over
//     the CTAs, in a fixed order.  No atomics: two launches give the same
//     bits.
// The scratch is ~19.5 KB a row at D8/W512 (2.4 GB at 122,880 rows), one
// workspace the caller allocates (trunk_bwd_workspace says its size).
// What a later PR would change: wgmma and TMA, keeping the forward's
// activations from the forward launch instead of recomputing them, and the
// weight gradient fused into the data pass where a tile's rows allow it.

#include <algorithm>

#include "trunk.cuh"

namespace {

constexpr int kMaxDepth = 32;
constexpr int kMaxJobs = kMaxDepth + 6;  // D + 6 weight matrices
constexpr int kWgradTile = 128;          // dW tile (out x in) per CTA
constexpr int kWgradChunk = 32;          // rows per cp.async stage
constexpr int kWgradLd = kWgradTile + kPad;
constexpr int kWgradThreads = 256;
constexpr int kTargetCtas = 528;  // ~4 per SM on 132 SMs: the row ranges fill the card

long long align256(long long n) { return (n + 255) / 256 * 256; }

// Where each weight matrix and bias sits in the packed buffers (elements),
// as trunk.py:_layout orders them.  w[i] is layer i's weight on the
// previous activation: w0, w_i, or wsh at the skip layer.
struct Layout {
  long long w[kMaxDepth];
  long long wsx, wha, wf, wvf, wvv, whr, w_total;
  int b[kMaxDepth];
  int bha, bf, bv, bhr, b_total;

  __host__ __device__ Layout(int depth, int width, int in_pad, int v_pad, int ha, int hr) {
    const int skip = depth / 2, half = width / 2;
    long long at = 0;
    w[0] = at;
    at += (long long)width * in_pad;
    for (int i = 1; i < depth; ++i) {
      if (i == skip + 1) {
        wsx = at;
        at += (long long)width * in_pad;
      }
      w[i] = at;
      at += (long long)width * width;
    }
    wha = at;
    at += (long long)ha * width;
    wf = at;
    at += (long long)width * width;
    wvf = at;
    at += (long long)half * width;
    wvv = at;
    at += (long long)half * v_pad;
    whr = at;
    at += (long long)hr * half;
    w_total = at;
    for (int i = 0; i < depth; ++i) b[i] = i * width;
    bha = depth * width;
    bf = bha + ha;
    bv = bf + width;
    bhr = bv + half;
    b_total = bhr + hr;
  }
};

// The scratch: bf16 activations and gradients, rows_pad rows each, then the
// f32 partials.  Offsets in bytes from the workspace's start, 256-aligned.
struct Plan {
  int rows_pad, n_ctas, splits, rows_per_split;
  long long x, v, h, f, hv, g, gf, gv, ga, gr, db_part, dw_part, bytes;

  Plan(int B, int depth, int width, int in_pad, int v_pad, int ha, int hr, int n_tiles,
       long long w_total, int b_total) {
    rows_pad = (B + kRows - 1) / kRows * kRows;
    n_ctas = rows_pad / kRows;
    const int chunks = std::max(1, rows_pad / kWgradChunk);
    const int want = std::max(1, std::min(chunks, (kTargetCtas + n_tiles - 1) / n_tiles));
    const int per = (chunks + want - 1) / want;  // chunks per row range
    splits = (chunks + per - 1) / per;
    rows_per_split = per * kWgradChunk;
    const long long R = rows_pad, half = width / 2;
    long long at = 0;
    auto take = [&at](long long n) {
      const long long o = at;
      at += align256(n);
      return o;
    };
    x = take(R * in_pad * 2);
    v = take(R * v_pad * 2);
    h = take((long long)depth * R * width * 2);
    f = take(R * width * 2);
    hv = take(R * half * 2);
    g = take((long long)depth * R * width * 2);
    gf = take(R * width * 2);
    gv = take(R * half * 2);
    ga = take(R * ha * 2);
    gr = take(R * hr * 2);
    db_part = take((long long)n_ctas * b_total * 4);
    dw_part = take((long long)splits * w_total * 4);
    bytes = at;
  }
};

// ---------------------------------------------------------------------------
// the data pass
// ---------------------------------------------------------------------------

// Shared memory: three activation buffers (kRows x (width + kPad)); the x
// and v tiles in the third one while the forward runs (they are not needed
// after it) when they fit there, else after it; then the staging tiles.
struct DataSmem {
  int ldh, ldx, ldv;
  int off_x, off_v, off_stage, bytes;
  __host__ __device__ DataSmem(int width, int in_pad, int v_pad) {
    ldh = width + kPad;
    ldx = in_pad + kPad;
    ldv = v_pad + kPad;
    const int buf = kRows * ldh * 2;
    const bool alias = ldx + ldv <= ldh;
    off_x = alias ? 2 * buf : 3 * buf;
    off_v = off_x + kRows * ldx * 2;
    off_stage = alias ? 3 * buf : off_v + kRows * ldv * 2;
    bytes = off_stage + kStageBytes;
  }
};

// The recomputed forward's epilogue: + bias, relu unless linear, round to
// bf16, write to shared memory and to the activation scratch (the CTA's
// rows, leading dimension n).
struct ActEpi {
  const float* bias;
  bool relu;
  bf16* out_s;
  int ldo;
  bf16* out_g;
  int n;

  __device__ __forceinline__ void apply(int row, int col, float (&v)[8]) const {
    const float4 b0 = *reinterpret_cast<const float4*>(bias + col);
    const float4 b1 = *reinterpret_cast<const float4*>(bias + col + 4);
    v[0] += b0.x; v[1] += b0.y; v[2] += b0.z; v[3] += b0.w;
    v[4] += b1.x; v[5] += b1.y; v[6] += b1.z; v[7] += b1.w;
    if (relu) {
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = fmaxf(v[e], 0.f);
    }
    const uint4 packed = pack_bf16x8(v);
    *reinterpret_cast<uint4*>(out_s + row * ldo + col) = packed;
    *reinterpret_cast<uint4*>(out_g + (size_t)row * n + col) = packed;
  }
  __device__ __forceinline__ void finish(int) const {}
};

// A gradient step's epilogue: times the relu mask of `mask` (the layer's
// bf16 output, from the activation scratch, leading dimension n; none for
// the feature layer), summed per column into `db` (the CTA's partials),
// rounded to bf16 into shared memory and the gradient scratch.
struct GradEpi {
  const bf16* mask;
  bf16* out_s;
  int ldo;
  bf16* out_g;
  float* db;
  int n;
  float sum[8];

  __device__ __forceinline__ void apply(int row, int col, float (&v)[8]) {
    if (mask != nullptr) {
      const uint4 m = *reinterpret_cast<const uint4*>(mask + (size_t)row * n + col);
      const __nv_bfloat162* m2 = reinterpret_cast<const __nv_bfloat162*>(&m);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 mf = __bfloat1622float2(m2[e]);
        v[2 * e] *= mf.x > 0.f ? 1.f : 0.f;
        v[2 * e + 1] *= mf.y > 0.f ? 1.f : 0.f;
      }
    }
#pragma unroll
    for (int e = 0; e < 8; ++e) sum[e] += v[e];
    const uint4 packed = pack_bf16x8(v);
    *reinterpret_cast<uint4*>(out_s + row * ldo + col) = packed;
    *reinterpret_cast<uint4*>(out_g + (size_t)row * n + col) = packed;
  }

  // the 64 rows of a 16-column tile: each lane summed rows lane/2 + 16 i in
  // order; the 16 lanes of a half-tile add theirs in a butterfly
  __device__ __forceinline__ void finish(int col) {
    const int lane = threadIdx.x & 31;
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      float s = sum[e];
      for (int off = 2; off < 32; off <<= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      if (lane < 2) db[col + e] = s;
      sum[e] = 0.f;
    }
  }
};

__device__ __forceinline__ void grad_layer(Operand op0, Operand op1, int n, const bf16* mask,
                                           bf16* out_s, int ldo, bf16* out_g, float* db,
                                           float* stage) {
  GradEpi epi{mask, out_s, ldo, out_g, db, n, {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f}};
  layer<false>(op0, op1, n, stage, epi);
}

// A (kRows x cols) bf16 tile from shared memory to the scratch, 16 bytes a
// thread.
__device__ __forceinline__ void copy_out(const bf16* src, int lds, bf16* dst, int cols) {
  const int per_row = cols / 8;
  for (int idx = threadIdx.x; idx < kRows * per_row; idx += kThreads) {
    const int r = idx / per_row, c = (idx - r * per_row) * 8;
    *reinterpret_cast<uint4*>(dst + (size_t)r * cols + c) =
        *reinterpret_cast<const uint4*>(src + r * lds + c);
  }
}

// A head's cotangent (B, n) f32: its rows of this tile (zero past the end
// of the batch) rounded to bf16 into shared memory and the scratch; each
// column's f32 sum, rows in order, into db.
__device__ __forceinline__ void stage_cotangent(const float* __restrict__ g, int n,
                                                long long row0, int rows_valid, bf16* out_s,
                                                int ldo, bf16* out_g, float* db) {
  for (int c = threadIdx.x; c < n; c += kThreads) {
    float s = 0.f;
    for (int r = 0; r < kRows; ++r) {
      const float val = r < rows_valid ? g[(row0 + r) * n + c] : 0.f;
      s += val;
      const bf16 b = __float2bfloat16(val);
      out_s[r * ldo + c] = b;
      out_g[(size_t)r * n + c] = b;
    }
    db[c] = s;
  }
}

struct Scratch {
  bf16 *x, *v, *h, *f, *hv, *g, *gf, *gv, *ga, *gr;
  float* db_part;
  long long rows_pad;
};

__global__ void __launch_bounds__(kThreads, 1)
trunk_bwd_data(const float* __restrict__ emb, int emb_stride, int B,
               const bf16* __restrict__ w, const float* __restrict__ bias,
               const float* __restrict__ g_ha, const float* __restrict__ g_hr, Scratch S,
               const __grid_constant__ Layout L, int depth, int width, int input_ch,
               int views_ch, int ha, int hr) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int in_pad = round16(input_ch), v_pad = round16(views_ch);
  const int half = width / 2, skip = depth / 2;
  const DataSmem M(width, in_pad, v_pad);
  const int ldh = M.ldh;
  bf16* buf[3];
  for (int k = 0; k < 3; ++k) buf[k] = reinterpret_cast<bf16*>(smem) + k * kRows * ldh;
  bf16* xs = reinterpret_cast<bf16*>(smem + M.off_x);
  bf16* vs = reinterpret_cast<bf16*>(smem + M.off_v);
  float* stage = reinterpret_cast<float*>(smem + M.off_stage) + (threadIdx.x >> 5) * 256;

  const long long row0 = (long long)blockIdx.x * kRows;
  const int rows_valid = (int)min((long long)kRows, (long long)B - row0);
  const long long R = S.rows_pad;
  auto act = [&](bf16* base, int cols) { return base + row0 * cols; };  // this tile's rows
  auto layer_h = [&](int i) { return S.h + (long long)i * R * width + row0 * width; };
  auto layer_g = [&](int i) { return S.g + (long long)i * R * width + row0 * width; };
  float* db = S.db_part + (long long)blockIdx.x * L.b_total;
  const Operand none{nullptr, 0, 0, nullptr};

  // ---- the forward, recomputed: every activation to the scratch ----
  stage_inputs(emb, emb_stride, row0, rows_valid, input_ch, views_ch, xs, M.ldx, vs, M.ldv);
  __syncthreads();
  copy_out(xs, M.ldx, act(S.x, in_pad), in_pad);
  copy_out(vs, M.ldv, act(S.v, v_pad), v_pad);
  bf16* cur = buf[0];
  bf16* nxt = buf[1];
  {
    ActEpi epi{bias + L.b[0], true, cur, ldh, layer_h(0), width};
    layer<true>(Operand{xs, M.ldx, in_pad, w + L.w[0]}, none, width, stage, epi);
  }
  __syncthreads();
  for (int i = 1; i < depth; ++i) {
    ActEpi epi{bias + L.b[i], true, nxt, ldh, layer_h(i), width};
    const Operand op_h{cur, ldh, width, w + L.w[i]};
    if (i == skip + 1)
      layer<true>(Operand{xs, M.ldx, in_pad, w + L.wsx}, op_h, width, stage, epi);
    else
      layer<true>(op_h, none, width, stage, epi);
    __syncthreads();
    bf16* t = cur;
    cur = nxt;
    nxt = t;
  }
  {  // f (linear), then hv; cur holds h_{D-1}
    ActEpi epi_f{bias + L.bf, false, nxt, ldh, act(S.f, width), width};
    layer<true>(Operand{cur, ldh, width, w + L.wf}, none, width, stage, epi_f);
    __syncthreads();
    ActEpi epi_v{bias + L.bv, true, cur, ldh, act(S.hv, half), half};
    layer<true>(Operand{nxt, ldh, width, w + L.wvf}, Operand{vs, M.ldv, v_pad, w + L.wvv}, half,
                stage, epi_v);
  }
  __syncthreads();

  // ---- the backward: heads, views, feature, then the layers in reverse ----
  stage_cotangent(g_hr, hr, row0, rows_valid, buf[0], ldh, act(S.gr, hr), db + L.bhr);
  stage_cotangent(g_ha, ha, row0, rows_valid, buf[1], ldh, act(S.ga, ha), db + L.bha);
  __syncthreads();
  // g_hv = (g_hr Whr) [hv > 0]
  grad_layer(Operand{buf[0], ldh, hr, w + L.whr}, none, half, act(S.hv, half), buf[2], ldh,
             act(S.gv, half), db + L.bv, stage);
  __syncthreads();
  // g_f = g_hv Wvf (the feature layer is linear)
  grad_layer(Operand{buf[2], ldh, half, w + L.wvf}, none, width, nullptr, buf[0], ldh,
             act(S.gf, width), db + L.bf, stage);
  __syncthreads();
  // g_{D-1} = (g_f Wf + g_ha Wha) [h_{D-1} > 0]
  grad_layer(Operand{buf[0], ldh, width, w + L.wf}, Operand{buf[1], ldh, ha, w + L.wha}, width,
             layer_h(depth - 1), buf[2], ldh, layer_g(depth - 1), db + L.b[depth - 1], stage);
  __syncthreads();
  cur = buf[2];
  nxt = buf[0];
  for (int i = depth - 1; i >= 1; --i) {
    // g_{i-1} = (g_i W_i) [h_{i-1} > 0]; W_i is wsh at the skip layer (x
    // gets no gradient)
    grad_layer(Operand{cur, ldh, width, w + L.w[i]}, none, width, layer_h(i - 1), nxt, ldh,
               layer_g(i - 1), db + L.b[i - 1], stage);
    __syncthreads();
    bf16* t = cur;
    cur = nxt;
    nxt = t;
  }
}

// ---------------------------------------------------------------------------
// the weight-gradient pass
// ---------------------------------------------------------------------------

// dW (n_out x n_in) = G^T H: G (rows, n_out) and H (rows, n_in) bf16 in the
// scratch, row-major.
struct Job {
  const bf16* g;
  const bf16* h;
  long long out;  // dW's offset in the packed layout
  int n_out, n_in, tiles_in, first_tile;
};

struct Jobs {
  Job job[kMaxJobs];
  int n_jobs;
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

using FragAT = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>;
using FragBR = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;

// One CTA: a 128 x 128 tile of one dW over one range of rows, into that
// range's partial.  Warp w computes out rows (w / 4) * 64 .. + 64 and in
// columns (w % 4) * 32 .. + 32 of the tile; fragments past the matrix's edge
// (every width is a multiple of 16) are skipped.
__global__ void __launch_bounds__(kWgradThreads)
trunk_bwd_wgrad(const __grid_constant__ Jobs jobs, int rows_pad, int rows_per_split,
                float* __restrict__ dw_part, long long w_total) {
  __shared__ __align__(128) bf16 gs[2][kWgradChunk][kWgradLd];
  __shared__ __align__(128) bf16 hs[2][kWgradChunk][kWgradLd];
  int j = 0;
  while (j + 1 < jobs.n_jobs && jobs.job[j + 1].first_tile <= (int)blockIdx.x) ++j;
  const Job& job = jobs.job[j];
  const int tile = blockIdx.x - job.first_tile;
  const int o0 = (tile / job.tiles_in) * kWgradTile;
  const int i0 = (tile % job.tiles_in) * kWgradTile;
  const int no = min(kWgradTile, job.n_out - o0);
  const int ni = min(kWgradTile, job.n_in - i0);
  const int r_begin = blockIdx.y * rows_per_split;
  const int r_end = min(rows_pad, r_begin + rows_per_split);
  const int n_chunks = max(0, (r_end - r_begin) / kWgradChunk);

  const int warp = threadIdx.x >> 5;
  const int wo = (warp / 4) * 64;
  const int wi = (warp % 4) * 32;
  FragC acc[4][2];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b) wmma::fill_fragment(acc[a][b], 0.f);

  // a chunk: 32 rows x 128 columns of G and of H, 16 bytes per copy; pieces
  // past the matrix's edge are left alone (their fragments are skipped)
  auto load = [&](int chunk, int st) {
    const long long r0 = r_begin + (long long)chunk * kWgradChunk;
    for (int idx = threadIdx.x; idx < kWgradChunk * (kWgradTile / 8); idx += kWgradThreads) {
      const int r = idx / (kWgradTile / 8), c = (idx % (kWgradTile / 8)) * 8;
      if (c < no) cp_async16(&gs[st][r][c], job.g + (r0 + r) * job.n_out + o0 + c);
      if (c < ni) cp_async16(&hs[st][r][c], job.h + (r0 + r) * job.n_in + i0 + c);
    }
    cp_async_commit();
  };

  if (n_chunks > 0) load(0, 0);
  for (int ch = 0; ch < n_chunks; ++ch) {
    if (ch + 1 < n_chunks) {
      load(ch + 1, (ch + 1) & 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int st = ch & 1;
#pragma unroll
    for (int kk = 0; kk < kWgradChunk; kk += 16) {
      FragBR b[2];
#pragma unroll
      for (int fi = 0; fi < 2; ++fi)
        if (wi + fi * 16 < ni) wmma::load_matrix_sync(b[fi], &hs[st][kk][wi + fi * 16], kWgradLd);
#pragma unroll
      for (int fo = 0; fo < 4; ++fo) {
        if (wo + fo * 16 >= no) continue;
        FragAT a;  // G^T: element (o, r) at gs[r][o]
        wmma::load_matrix_sync(a, &gs[st][kk][wo + fo * 16], kWgradLd);
#pragma unroll
        for (int fi = 0; fi < 2; ++fi)
          if (wi + fi * 16 < ni) wmma::mma_sync(acc[fo][fi], a, b[fi], acc[fo][fi]);
      }
    }
    __syncthreads();  // the stage is refilled next
  }

  float* out = dw_part + blockIdx.y * w_total + job.out;
#pragma unroll
  for (int fo = 0; fo < 4; ++fo)
#pragma unroll
    for (int fi = 0; fi < 2; ++fi) {
      const int o = o0 + wo + fo * 16, i = i0 + wi + fi * 16;
      if (wo + fo * 16 < no && wi + fi * 16 < ni)
        wmma::store_matrix_sync(out + (long long)o * job.n_in + i, acc[fo][fi], job.n_in,
                                wmma::mem_row_major);
    }
}

// dW = the row ranges' partials added in order.
__global__ void trunk_bwd_reduce_dw(const float* __restrict__ part, int splits,
                                    long long w_total, float* __restrict__ dw) {
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < w_total;
       e += (long long)gridDim.x * blockDim.x) {
    float s = 0.f;
    for (int k = 0; k < splits; ++k) s += part[k * w_total + e];
    dw[e] = s;
  }
}

// db = the CTAs' partials added in a fixed order: lane = column, warp k
// adds CTAs k, k + 8, ..., then the 8 warps' sums in order.
__global__ void __launch_bounds__(256)
trunk_bwd_reduce_db(const float* __restrict__ part, int n_ctas, int b_total,
                    float* __restrict__ db) {
  __shared__ float sums[8][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int col = blockIdx.x * 32 + lane;
  float s = 0.f;
  if (col < b_total)
    for (int k = warp; k < n_ctas; k += 8) s += part[(long long)k * b_total + col];
  sums[warp][lane] = s;
  __syncthreads();
  if (warp == 0 && col < b_total) {
    float t = 0.f;
    for (int k = 0; k < 8; ++k) t += sums[k][lane];
    db[col] = t;
  }
}

bool shape_ok(int B, int depth, int width, int input_ch, int views_ch, int ha, int hr) {
  return B >= 0 && depth >= 3 && depth <= kMaxDepth && width >= 32 && width % 32 == 0 &&
         input_ch >= 1 && views_ch >= 1 && ha >= 16 && ha % 16 == 0 && ha <= width &&
         hr >= 16 && hr % 16 == 0 && hr <= width;
}

// The weight-gradient jobs: every matrix with its G and H_in in the
// scratch, and the tiles before it.
int make_jobs(Jobs& jobs, const Layout& L, const Plan& P, unsigned char* ws, int depth,
              int width, int in_pad, int v_pad, int ha, int hr) {
  auto at = [ws](long long off) { return reinterpret_cast<bf16*>(ws + off); };
  const long long R = P.rows_pad;
  const int skip = depth / 2, half = width / 2;
  bf16* h = at(P.h);
  bf16* g = at(P.g);
  int n = 0, tiles = 0;
  auto add = [&](const bf16* gp, const bf16* hp, long long out, int n_out, int n_in) {
    Job& j = jobs.job[n++];
    j.g = gp;
    j.h = hp;
    j.out = out;
    j.n_out = n_out;
    j.n_in = n_in;
    j.tiles_in = (n_in + kWgradTile - 1) / kWgradTile;
    j.first_tile = tiles;
    tiles += ((n_out + kWgradTile - 1) / kWgradTile) * j.tiles_in;
  };
  add(g, at(P.x), L.w[0], width, in_pad);
  for (int i = 1; i < depth; ++i) {
    bf16* gi = g + (long long)i * R * width;
    if (i == skip + 1) add(gi, at(P.x), L.wsx, width, in_pad);
    add(gi, h + (long long)(i - 1) * R * width, L.w[i], width, width);
  }
  bf16* h_last = h + (long long)(depth - 1) * R * width;
  add(at(P.ga), h_last, L.wha, ha, width);
  add(at(P.gf), h_last, L.wf, width, width);
  add(at(P.gv), at(P.f), L.wvf, half, width);
  add(at(P.gv), at(P.v), L.wvv, half, v_pad);
  add(at(P.gr), at(P.hv), L.whr, hr, half);
  jobs.n_jobs = n;
  return tiles;
}

int count_tiles(int depth, int width, int in_pad, int v_pad, int ha, int hr) {
  auto t = [](int a, int b) {
    return ((a + kWgradTile - 1) / kWgradTile) * ((b + kWgradTile - 1) / kWgradTile);
  };
  const int half = width / 2;
  return t(width, in_pad) * 2 + (depth - 1) * t(width, width) + t(ha, width) +
         t(width, width) + t(half, width) + t(half, v_pad) + t(hr, half);
}

Plan plan_for(int B, int depth, int width, int input_ch, int views_ch, int ha, int hr) {
  const int in_pad = round16(input_ch), v_pad = round16(views_ch);
  const Layout L(depth, width, in_pad, v_pad, ha, hr);
  return Plan(B, depth, width, in_pad, v_pad, ha, hr,
              count_tiles(depth, width, in_pad, v_pad, ha, hr), L.w_total, L.b_total);
}

}  // namespace

// The bytes of workspace trunk_bwd needs for B rows of this trunk; -1 for
// a shape it does not take.
extern "C" long long trunk_bwd_workspace(int B, int depth, int width, int input_ch,
                                         int views_ch, int ha, int hr) {
  if (!shape_ok(B, depth, width, input_ch, views_ch, ha, hr)) return -1;
  return plan_for(B, depth, width, input_ch, views_ch, ha, hr).bytes;
}

// C entry point (bound with ctypes).  emb: device f32 (B, input_ch +
// views_ch) with row stride `emb_stride` floats, columns contiguous; w:
// device bf16 weights and bias: device f32 biases, as trunk.cu reads them;
// g_ha (B, ha), g_hr (B, hr): device f32 cotangents, contiguous; dw, db:
// device f32 outputs laid out as w and bias; workspace: device memory of
// trunk_bwd_workspace's bytes.  The caller checks shapes and types; this
// checks what the kernels' layout needs.  Launches the four kernels on
// `stream` and returns the first CUDA error (0 on success); it never
// synchronises.
extern "C" int trunk_bwd(const float* emb, int emb_stride, const void* w, const float* bias,
                         const float* g_ha, const float* g_hr, float* dw, float* db,
                         void* workspace, long long workspace_bytes, int B, int depth,
                         int width, int input_ch, int views_ch, int ha, int hr,
                         void* stream) {
  if (!shape_ok(B, depth, width, input_ch, views_ch, ha, hr) ||
      emb_stride < input_ch + views_ch) {
    return (int)cudaErrorInvalidValue;
  }
  const int in_pad = round16(input_ch), v_pad = round16(views_ch);
  const DataSmem M(width, in_pad, v_pad);
  const Plan P = plan_for(B, depth, width, input_ch, views_ch, ha, hr);
  if (M.bytes > kMaxSmem || workspace_bytes < P.bytes) return (int)cudaErrorInvalidValue;
  const Layout L(depth, width, in_pad, v_pad, ha, hr);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0) {
    cudaError_t e = cudaMemsetAsync(dw, 0, L.w_total * sizeof(float), s);
    if (e == cudaSuccess) e = cudaMemsetAsync(db, 0, L.b_total * sizeof(float), s);
    return (int)e;
  }
  unsigned char* ws = static_cast<unsigned char*>(workspace);
  auto at = [ws](long long off) { return reinterpret_cast<bf16*>(ws + off); };
  const Scratch S{at(P.x),  at(P.v),  at(P.h),  at(P.f),  at(P.hv),
                  at(P.g),  at(P.gf), at(P.gv), at(P.ga), at(P.gr),
                  reinterpret_cast<float*>(ws + P.db_part), P.rows_pad};

  cudaError_t e = cudaFuncSetAttribute(trunk_bwd_data,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, M.bytes);
  if (e != cudaSuccess) return (int)e;
  trunk_bwd_data<<<P.n_ctas, kThreads, M.bytes, s>>>(
      emb, emb_stride, B, static_cast<const bf16*>(w), bias, g_ha, g_hr, S, L, depth, width,
      input_ch, views_ch, ha, hr);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  Jobs jobs;
  const int tiles = make_jobs(jobs, L, P, ws, depth, width, in_pad, v_pad, ha, hr);
  float* dw_part = reinterpret_cast<float*>(ws + P.dw_part);
  trunk_bwd_wgrad<<<dim3(tiles, P.splits), kWgradThreads, 0, s>>>(
      jobs, P.rows_pad, P.rows_per_split, dw_part, L.w_total);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  trunk_bwd_reduce_dw<<<1024, 256, 0, s>>>(dw_part, P.splits, L.w_total, dw);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  trunk_bwd_reduce_db<<<(L.b_total + 31) / 32, 256, 0, s>>>(
      reinterpret_cast<const float*>(ws + P.db_part), P.n_ctas, L.b_total, db);
  return (int)cudaGetLastError();
}
