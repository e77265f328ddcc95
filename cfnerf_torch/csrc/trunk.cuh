// What the trunk's forward (trunk.cu) and backward (trunk_bwd.cu) kernels
// share: the CTA's rows and padding, `ActPlan`, the layout of the
// activations the training forward saves and the backward reads, and
// `copy_out`; and the forward's own pieces: the tensor-core fragment types,
// the embedding's staging into shared memory, and `layer`, one layer's
// products for a tile of kRows rows with a caller-given epilogue.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>

namespace {

using namespace nvcuda;
using bf16 = __nv_bfloat16;

constexpr int kRows = 64;              // rows (points) per CTA
constexpr int kRowTiles = kRows / 16;  // 16-row tiles a warp covers
constexpr int kColTiles = 2;           // 16-column tiles a warp unit covers
constexpr int kWarps = 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kPad = 8;        // bf16 row padding in shared memory (16 bytes)
constexpr int kMaxSmem = 232448;  // a block's dynamic shared memory on sm_90
constexpr int kStageBytes = kWarps * 256 * 4;  // one 16x16 f32 staging tile per warp

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
// B: the weights' (n x k) nn.Linear matrix read as W^T (out = A W^T), each
// fragment's k pairs one 32-bit load
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__host__ __device__ inline int round16(int n) { return (n + 15) / 16 * 16; }
__host__ __device__ inline long long align256(long long n) { return (n + 255) / 256 * 256; }

// The training forward's saved activations, bf16, row-major, rows_pad rows
// each (the batch rounded up to whole CTAs): x (in_pad columns), v (v_pad),
// h_0..h_{D-1} then f, one (D + 1) x rows_pad x width block (so that the
// weight-gradient pass reads them as one matrix), hv (width / 2).  Offsets
// in bytes from the workspace's start, 256-aligned.
struct ActPlan {
  long long rows_pad, x, v, h, f, hv, bytes;
  __host__ __device__ ActPlan(int B, int depth, int width, int in_pad, int v_pad) {
    rows_pad = ((long long)B + kRows - 1) / kRows * kRows;
    const long long R = rows_pad;
    x = 0;
    v = x + align256(R * in_pad * 2);
    h = v + align256(R * v_pad * 2);
    f = h + (long long)depth * R * width * 2;
    hv = h + align256((long long)(depth + 1) * R * width * 2);
    bytes = hv + align256(R * (width / 2) * 2);
  }
};

// One operand of a layer: A (kRows x k, bf16, row-major in shared memory,
// leading dimension lda) times the weights in global memory (see FragB).
// k = 0 marks an absent second operand.
struct Operand {
  const bf16* a;
  int lda;
  int k;
  const bf16* w;
};

// Stages the tile's embedding as bf16: x's input_ch columns into xs, the
// views_ch after them into vs, zero-filling the padded columns and the rows
// past the end of the batch.  emb is read through its row stride.
__device__ __forceinline__ void stage_inputs(const float* __restrict__ emb, int emb_stride,
                                             long long row0, int rows_valid, int input_ch,
                                             int views_ch, bf16* xs, int ldx, bf16* vs,
                                             int ldv) {
  const int in_pad = round16(input_ch), v_pad = round16(views_ch);
  const float* src = emb + row0 * emb_stride;
  for (int idx = threadIdx.x; idx < kRows * in_pad; idx += kThreads) {
    const int r = idx / in_pad, c = idx - r * in_pad;
    const float val = (r < rows_valid && c < input_ch) ? src[(size_t)r * emb_stride + c] : 0.f;
    xs[r * ldx + c] = __float2bfloat16(val);
  }
  for (int idx = threadIdx.x; idx < kRows * v_pad; idx += kThreads) {
    const int r = idx / v_pad, c = idx - r * v_pad;
    const float val =
        (r < rows_valid && c < views_ch) ? src[(size_t)r * emb_stride + input_ch + c] : 0.f;
    vs[r * ldv + c] = __float2bfloat16(val);
  }
}

// acc = A0 B0 [+ A1 B1] for n output columns, then the epilogue: for each
// 16x16 tile, each lane hands epi.apply(row, col, v) the tile's row
// lane / 2, columns col .. col + 7 (lane % 2 picks the half).  Each warp
// owns kRows rows x 32 columns at a time: per k-step of 16 it loads two B fragments straight from global
// memory (the weights stay in L2) and four A fragments from shared memory,
// and runs eight 16x16x16 bf16 products into f32 accumulators.  Called by
// every warp of the CTA; no barrier inside.
template <typename Epi>
__device__ __forceinline__ void layer(Operand op0, Operand op1, int n, float* stage, Epi& epi) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int n_tiles = n / 16;
  const int n_units = (n_tiles + kColTiles - 1) / kColTiles;
  for (int u = warp; u < n_units; u += kWarps) {
    const int t0 = u * kColTiles;
    const int nt = min(kColTiles, n_tiles - t0);
    FragC acc[kRowTiles][kColTiles];
#pragma unroll
    for (int i = 0; i < kRowTiles; ++i)
#pragma unroll
      for (int j = 0; j < kColTiles; ++j) wmma::fill_fragment(acc[i][j], 0.f);

#pragma unroll
    for (int o = 0; o < 2; ++o) {
      const Operand op = o == 0 ? op0 : op1;
      for (int k0 = 0; k0 < op.k; k0 += 16) {
        FragB b[kColTiles];
#pragma unroll
        for (int j = 0; j < kColTiles; ++j)
          if (j < nt) wmma::load_matrix_sync(b[j], op.w + (size_t)(t0 + j) * 16 * op.k + k0, op.k);
#pragma unroll
        for (int i = 0; i < kRowTiles; ++i) {
          FragA a;
          wmma::load_matrix_sync(a, op.a + i * 16 * op.lda + k0, op.lda);
#pragma unroll
          for (int j = 0; j < kColTiles; ++j)
            if (j < nt) wmma::mma_sync(acc[i][j], a, b[j], acc[i][j]);
        }
      }
    }

    // epilogue: lane l takes row l/2, columns (l%2)*8 .. +8 of each tile,
    // through the warp's 16x16 f32 staging tile (the accumulator layout is
    // opaque)
    const int r = lane >> 1;
    const int c = (lane & 1) * 8;
#pragma unroll
    for (int j = 0; j < kColTiles; ++j) {
      if (j >= nt) continue;
      const int col = (t0 + j) * 16 + c;
#pragma unroll
      for (int i = 0; i < kRowTiles; ++i) {
        wmma::store_matrix_sync(stage, acc[i][j], 16, wmma::mem_row_major);
        __syncwarp();
        const float4 s0 = *reinterpret_cast<const float4*>(stage + r * 16 + c);
        const float4 s1 = *reinterpret_cast<const float4*>(stage + r * 16 + c + 4);
        float v[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
        epi.apply(i * 16 + r, col, v);
        __syncwarp();
      }
    }
  }
}

// A (kRows x cols) bf16 tile from shared memory (leading dimension lds) to
// global memory (leading dimension cols), 16 bytes a thread, by threads
// 0 .. threads - 1.
__device__ __forceinline__ void copy_out(const bf16* src, int lds, bf16* dst, int cols,
                                         int threads = kThreads) {
  const int per_row = cols / 8;
  for (int idx = threadIdx.x; idx < kRows * per_row; idx += threads) {
    const int r = idx / per_row, c = (idx - r * per_row) * 8;
    *reinterpret_cast<uint4*>(dst + (size_t)r * cols + c) =
        *reinterpret_cast<const uint4*>(src + r * lds + c);
  }
}

// Eight f32 values rounded to bf16, as one 16-byte word.
__device__ __forceinline__ uint4 pack_bf16x8(const float (&v)[8]) {
  uint4 packed;
  __nv_bfloat162* p2 = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
  for (int e = 0; e < 4; ++e) p2[e] = __floats2bfloat162_rn(v[2 * e], v[2 * e + 1]);
  return packed;
}

}  // namespace
