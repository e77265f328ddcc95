// NeRF trunk forward for Hopper (sm_90a): the D-layer ReLU MLP with its skip
// layer, then the density head, the feature layer, the views layer and the
// rgb head, on bf16 tensor cores with f32 accumulators.
//
// Replaces: cfnerf_tpu/ops/pallas/trunk.py:_fwd_kernel (with _fwd_mlp,
// launched by pallas_encode).  Same arithmetic: the inputs and every
// activation are rounded to bf16, every product is bf16 x bf16 summed in
// f32, the f32 bias is added, then relu (not on the feature layer and the
// heads), then the next activation is rounded to bf16.  The skip layer sums
// x Wsx + h Wsh and the views layer f Wvf + v Wvv into the same
// accumulators before the bias.  h_alpha and h_rgb come out in f32.
//
// Inputs, as cfnerf_torch/ops/kernels/trunk.py:pack_trunk_weights lays them
// out: the f32 embedding (B, input_ch + views_ch) read through its row
// stride; one bf16 buffer holding every weight matrix in nn.Linear's
// (out, in) layout (K-major: each tensor-core fragment's pair along k is one
// 32-bit load), the odd input widths zero-padded to the k-step of 16, in the
// order w0, w1.., [wsx, wsh] at layer D/2 + 1, .., wha, wf, wvf, wvv, whr;
// one f32 buffer with the biases b0..b{D-1}, bha, bf, bv, bhr.
//
// What bounds it on an H100: operations.  At D8/W512 a point costs
// 2,348,800 multiply-adds; a flat serving tile (8192 rays x 128 samples =
// 1,048,576 points) is 4.93 TFLOP, 4.98 ms at the 989 TFLOP/s bf16 dense
// peak, and moves ~0.92 GB (0.27 ms at 3.35 TB/s): the embedding in and the
// two heads out (chip_smoke.py:trunk_work counts both).
//
// What the design does about it, simply: one CTA of 16 warps per tile of 64
// rows.  The tile's activation ping-pongs between two bf16 buffers in shared
// memory (2 x 65 KB at W=512) beside the bf16 x and v tiles, so no
// activation touches device memory.  Each warp owns 64 rows x 32 output
// columns of a layer: per k-step of 16 it loads two weight fragments
// straight from global memory (all weights, ~4.7 MB, stay in the 50 MB L2)
// and four activation fragments from shared memory, and runs eight
// nvcuda::wmma 16x16x16 bf16 products.  The epilogue goes through a per-warp
// 16x16 f32 staging tile (the accumulator layout is opaque): bias, relu,
// round to bf16, write to the next buffer, or f32 to the heads' outputs at
// their true widths.  The embedding is rounded to bf16 while it is staged,
// padded columns and the ragged last tile's rows are zero-filled there.
// Depth, width and the head widths are runtime values.
//
// Training: the kernel is a template on kSave.  The serving entry
// (trunk_fwd) runs kSave = false, the code path above.  The training entry
// (trunk_fwd_save) runs kSave = true: the same products and epilogues, and
// every bf16 activation also goes to a workspace (x, v, h_0..h_{D-1}, f,
// hv; trunk.cuh's ActPlan, whose bytes trunk_fwd_workspace returns), which
// trunk_bwd.cu reads instead of recomputing the forward.  That adds ~9.9 KB a row of writes at D8/W512
// (0.81 GB at the flat training step's 81,920 rows, ~0.24 ms at 3.35 TB/s)
// and no arithmetic: each activation is copied out of shared memory once a
// barrier has completed it, coalesced, while the next layer runs; the
// values are the ones the backward used to recompute, bit for bit.
//
// What a later PR would change: wgmma on 64-row warpgroup tiles instead of
// mma.sync, weights staged through shared memory by TMA (each CTA now reads
// every weight from L2 once per tile: ~77 GB of L2 traffic a flat serving
// tile), and a persistent grid so that one tile's epilogue overlaps the
// next one's products.

#include "trunk.cuh"

namespace {

// Shared memory: two activation buffers (kRows x (width + kPad)), the x and
// v tiles, then one 16x16 f32 staging tile per warp.  Every piece is
// kRows * 2 * (a multiple of 8) bytes: 128-byte aligned.
struct Smem {
  int ldh, ldx, ldv;
  int off_buf1, off_x, off_v, off_stage, bytes;
  __host__ __device__ Smem(int width, int in_pad, int v_pad) {
    ldh = width + kPad;
    ldx = in_pad + kPad;
    ldv = v_pad + kPad;
    off_buf1 = kRows * ldh * 2;
    off_x = 2 * off_buf1;
    off_v = off_x + kRows * ldx * 2;
    off_stage = off_v + kRows * ldv * 2;
    bytes = off_stage + kStageBytes;
  }
};

enum Epilogue { kRelu, kLinear, kGlobal };

// The forward's epilogue: + bias, then kRelu and kLinear write bf16 to
// `out_s` (leading dimension ldo); kGlobal writes f32 rows < rows_valid to
// `out_g` (leading dimension n).
struct FwdEpi {
  const float* bias;
  Epilogue kind;
  bf16* out_s;
  int ldo;
  float* out_g;
  int n;
  int rows_valid;

  __device__ __forceinline__ void apply(int row, int col, float (&v)[8]) const {
    const float4 b0 = *reinterpret_cast<const float4*>(bias + col);
    const float4 b1 = *reinterpret_cast<const float4*>(bias + col + 4);
    v[0] += b0.x; v[1] += b0.y; v[2] += b0.z; v[3] += b0.w;
    v[4] += b1.x; v[5] += b1.y; v[6] += b1.z; v[7] += b1.w;
    if (kind == kGlobal) {
      if (row < rows_valid) {
        float4* dst = reinterpret_cast<float4*>(out_g + (size_t)row * n + col);
        dst[0] = make_float4(v[0], v[1], v[2], v[3]);
        dst[1] = make_float4(v[4], v[5], v[6], v[7]);
      }
      return;
    }
    if (kind == kRelu) {
#pragma unroll
      for (int e = 0; e < 8; ++e) v[e] = fmaxf(v[e], 0.f);
    }
    *reinterpret_cast<uint4*>(out_s + row * ldo + col) = pack_bf16x8(v);
  }
};

// out = epilogue(A0 W0^T [+ A1 W1^T] + bias), n output columns.
__device__ __forceinline__ void fwd_layer(Operand op0, Operand op1, int n,
                                          const float* __restrict__ bias, Epilogue kind,
                                          bf16* out_s, int ldo, float* out_g, int rows_valid,
                                          float* stage) {
  FwdEpi epi{bias, kind, out_s, ldo, out_g, n, rows_valid};
  layer(op0, op1, n, stage, epi);
}

// The saved activations' base pointers (ActPlan's layout); unused when
// kSave is false.
struct Acts {
  bf16 *x, *v, *h, *f, *hv;
  long long rows_pad;
};

template <bool kSave>
__global__ void __launch_bounds__(kThreads, 1)
trunk_fwd_kernel(const float* __restrict__ emb, int emb_stride, int B,
                 const bf16* __restrict__ w, const float* __restrict__ bias,
                 float* __restrict__ h_alpha, float* __restrict__ h_rgb, Acts A,
                 int depth, int width, int input_ch, int views_ch, int ha, int hr) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int in_pad = round16(input_ch);
  const int v_pad = round16(views_ch);
  const Smem L(width, in_pad, v_pad);
  bf16* cur = reinterpret_cast<bf16*>(smem);
  bf16* nxt = reinterpret_cast<bf16*>(smem + L.off_buf1);
  bf16* xs = reinterpret_cast<bf16*>(smem + L.off_x);
  bf16* vs = reinterpret_cast<bf16*>(smem + L.off_v);
  float* stage = reinterpret_cast<float*>(smem + L.off_stage) + (threadIdx.x >> 5) * 256;

  const long long row0 = (long long)blockIdx.x * kRows;
  const int rows_valid = (int)min((long long)kRows, (long long)B - row0);

  stage_inputs(emb, emb_stride, row0, rows_valid, input_ch, views_ch, xs, L.ldx, vs, L.ldv);
  __syncthreads();
  // kSave: each bf16 activation, once a barrier has completed it in shared
  // memory, is copied out to this tile's rows of the workspace, 16 bytes a
  // thread; the next layer only reads that buffer, so no barrier waits for
  // the copy
  auto save = [&](const bf16* src, bf16* base, int cols) {
    if constexpr (kSave) copy_out(src, L.ldh, base + row0 * cols, cols);
  };
  auto h_of = [&](int i) { return A.h + (long long)i * A.rows_pad * width; };
  if constexpr (kSave) {
    copy_out(xs, L.ldx, A.x + row0 * in_pad, in_pad);
    copy_out(vs, L.ldv, A.v + row0 * v_pad, v_pad);
  }

  const Operand none{nullptr, 0, 0, nullptr};
  const bf16* pw = w;
  const float* pb = bias;
  auto take = [&pw](int rows, int cols) {
    const bf16* m = pw;
    pw += (size_t)rows * cols;
    return m;
  };

  const int skip = depth / 2;
  const int half = width / 2;
  fwd_layer(Operand{xs, L.ldx, in_pad, take(width, in_pad)}, none, width, pb, kRelu,
        cur, L.ldh, nullptr, 0, stage);
  pb += width;
  __syncthreads();
  save(cur, h_of(0), width);
  for (int i = 1; i < depth; ++i) {
    if (i == skip + 1) {
      const bf16* wsx = take(width, in_pad);
      const bf16* wsh = take(width, width);
      fwd_layer(Operand{xs, L.ldx, in_pad, wsx}, Operand{cur, L.ldh, width, wsh}, width, pb,
            kRelu, nxt, L.ldh, nullptr, 0, stage);
    } else {
      fwd_layer(Operand{cur, L.ldh, width, take(width, width)}, none, width, pb, kRelu,
            nxt, L.ldh, nullptr, 0, stage);
    }
    pb += width;
    __syncthreads();
    bf16* t = cur;
    cur = nxt;
    nxt = t;
    save(cur, h_of(i), width);
  }

  // heads: cur holds the trunk output h
  const bf16* wha = take(ha, width);
  const bf16* wf = take(width, width);
  const bf16* wvf = take(half, width);
  const bf16* wvv = take(half, v_pad);
  const bf16* whr = take(hr, half);
  const float* bha = pb;
  const float* bf = bha + ha;
  const float* bv = bf + width;
  const float* bhr = bv + half;
  fwd_layer(Operand{cur, L.ldh, width, wha}, none, ha, bha, kGlobal, nullptr, 0,
        h_alpha + row0 * ha, rows_valid, stage);
  fwd_layer(Operand{cur, L.ldh, width, wf}, none, width, bf, kLinear, nxt, L.ldh, nullptr, 0,
        stage);
  __syncthreads();
  save(nxt, A.f, width);
  fwd_layer(Operand{nxt, L.ldh, width, wvf}, Operand{vs, L.ldv, v_pad, wvv}, half, bv, kRelu,
        cur, L.ldh, nullptr, 0, stage);
  __syncthreads();
  save(cur, A.hv, half);
  fwd_layer(Operand{cur, L.ldh, half, whr}, none, hr, bhr, kGlobal, nullptr, 0,
        h_rgb + row0 * hr, rows_valid, stage);
}

bool shape_ok(int B, int depth, int width, int input_ch, int views_ch, int ha, int hr) {
  return B >= 0 && depth >= 3 && width >= 32 && width % 32 == 0 && input_ch >= 1 &&
         views_ch >= 1 && ha >= 16 && ha % 16 == 0 && hr >= 16 && hr % 16 == 0;
}

template <bool kSave>
int launch(const float* emb, int emb_stride, const void* w, const float* bias, float* h_alpha,
           float* h_rgb, Acts A, int B, int depth, int width, int input_ch, int views_ch,
           int ha, int hr, void* stream) {
  const Smem L(width, round16(input_ch), round16(views_ch));
  if (L.bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  const cudaError_t attr = cudaFuncSetAttribute(
      trunk_fwd_kernel<kSave>, cudaFuncAttributeMaxDynamicSharedMemorySize, L.bytes);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((unsigned)((B + kRows - 1) / kRows));
  trunk_fwd_kernel<kSave><<<grid, kThreads, L.bytes, static_cast<cudaStream_t>(stream)>>>(
      emb, emb_stride, B, static_cast<const bf16*>(w), bias, h_alpha, h_rgb, A, depth, width,
      input_ch, views_ch, ha, hr);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry points (bound with ctypes).  emb: device f32 (B, input_ch +
// views_ch) with row stride `emb_stride` floats, columns contiguous; w:
// device bf16 weights and bias: device f32 biases, as laid out above;
// h_alpha (B, ha) and h_rgb (B, hr): device f32, contiguous.  The caller
// checks shapes and types; these check what the kernel's layout needs.
// Each launches on `stream` and returns the CUDA error of the launch (0 on
// success); none synchronises.

// The serving forward: h_alpha and h_rgb only.
extern "C" int trunk_fwd(const float* emb, int emb_stride, const void* w,
                         const float* bias, float* h_alpha, float* h_rgb, int B,
                         int depth, int width, int input_ch, int views_ch, int ha,
                         int hr, void* stream) {
  if (!shape_ok(B, depth, width, input_ch, views_ch, ha, hr) ||
      emb_stride < input_ch + views_ch) {
    return (int)cudaErrorInvalidValue;
  }
  return launch<false>(emb, emb_stride, w, bias, h_alpha, h_rgb, Acts{}, B, depth, width,
                       input_ch, views_ch, ha, hr, stream);
}

// The bytes of activations trunk_fwd_save writes for B rows of this trunk
// (ActPlan); -1 for a shape it does not take.
extern "C" long long trunk_fwd_workspace(int B, int depth, int width, int input_ch,
                                         int views_ch) {
  if (!shape_ok(B, depth, width, input_ch, views_ch, 16, 16)) return -1;
  return ActPlan(B, depth, width, round16(input_ch), round16(views_ch)).bytes;
}

// The training forward: as trunk_fwd, and every bf16 activation into
// `acts` (device memory of trunk_fwd_workspace's bytes, ActPlan's layout),
// which trunk_bwd reads.
extern "C" int trunk_fwd_save(const float* emb, int emb_stride, const void* w,
                              const float* bias, float* h_alpha, float* h_rgb, void* acts,
                              long long acts_bytes, int B, int depth, int width,
                              int input_ch, int views_ch, int ha, int hr, void* stream) {
  if (!shape_ok(B, depth, width, input_ch, views_ch, ha, hr) ||
      emb_stride < input_ch + views_ch) {
    return (int)cudaErrorInvalidValue;
  }
  const ActPlan P(B, depth, width, round16(input_ch), round16(views_ch));
  if (acts_bytes < P.bytes) return (int)cudaErrorInvalidValue;
  unsigned char* base = static_cast<unsigned char*>(acts);
  auto at = [base](long long off) { return reinterpret_cast<bf16*>(base + off); };
  const Acts A{at(P.x), at(P.v), at(P.h), at(P.f), at(P.hv), P.rows_pad};
  return launch<true>(emb, emb_stride, w, bias, h_alpha, h_rgb, A, B, depth, width, input_ch,
                      views_ch, ha, hr, stream);
}
