// What the trunk's forward (trunk.cu) and backward (trunk_bwd.cu) kernels
// share: the CTA's rows, `Layout`, where each weight matrix and bias sits in
// the packed buffers, `ActPlan`, the layout of the activations the training
// forward saves and the backward reads, and the backward's padded tiles
// (`kPad`, `copy_out`).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kRows = 64;         // rows (points) per CTA
constexpr int kPad = 8;           // bf16 row padding of the backward's tiles (16 bytes)
constexpr int kMaxSmem = 232448;  // a block's dynamic shared memory on sm_90
constexpr int kMaxDepth = 32;

__host__ __device__ inline int round16(int n) { return (n + 15) / 16 * 16; }
__host__ __device__ inline long long align256(long long n) { return (n + 255) / 256 * 256; }

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

// A (kRows x cols) bf16 tile from shared memory (leading dimension lds) to
// global memory (leading dimension cols), 16 bytes a thread, by threads
// 0 .. threads - 1.
__device__ __forceinline__ void copy_out(const bf16* src, int lds, bf16* dst, int cols,
                                         int threads) {
  const int per_row = cols / 8;
  for (int idx = threadIdx.x; idx < kRows * per_row; idx += threads) {
    const int r = idx / per_row, c = (idx - r * per_row) * 8;
    *reinterpret_cast<uint4*>(dst + (size_t)r * cols + c) =
        *reinterpret_cast<const uint4*>(src + r * lds + c);
  }
}

}  // namespace
