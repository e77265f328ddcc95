// NeRF trunk forward for Hopper (sm_90a): the D-layer ReLU MLP with its skip
// layer, then the density head, the feature layer, the views layer and the
// rgb head, on bf16 tensor cores (wgmma) with f32 accumulators.
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
// (out, in) layout (K-major: wgmma's B operand without a transpose), the
// odd input widths zero-padded to the k-step of 16, in the order w0, w1..,
// [wsx, wsh] at layer D/2 + 1, .., wha, wf, wvf, wvv, whr (trunk.cuh's
// Layout); one f32 buffer with the biases b0..b{D-1}, bha, bf, bv, bhr.
//
// What bounds it on an H100: operations.  At D8/W512 a point costs
// 2,348,800 multiply-adds; a flat serving tile (8192 rays x 128 samples =
// 1,048,576 points) is 4.93 TFLOP, 4.98 ms at the 989 TFLOP/s bf16 dense
// peak, and moves ~0.92 GB (0.27 ms at 3.35 TB/s): the embedding in and the
// two heads out (chip_smoke.py:trunk_work counts both).  Behind that sits
// the weight stream: each CTA of 64 rows reads the whole packed weight
// buffer once, ~4.7 MB, so a flat tile asks the L2 for 77 GB of weights
// (by this count; no counter has measured it).
//
// What the design does about it.  One CTA per 64 rows, two consumer
// warpgroups and a producer warpgroup (setmaxnreg: 232 registers for the
// consumers, 40 for the producer, of which one thread works):
//   * Activations never leave shared memory.  One bf16 activation buffer,
//     beside the x and v tiles, each in wgmma's canonical K-major layout:
//     boxes of 64 rows x 64 columns (128 bytes a row, 8 KB), 128-byte
//     swizzle, 1024-byte aligned.  A layer's A operand is read from there
//     by descriptor: no ldmatrix, no registers.  Every layer reads the
//     buffer and overwrites it: once both warpgroups' products are done
//     (a barrier), the epilogue writes its output in place.
//   * The weights stream by TMA.  The producer thread walks every matrix in
//     the order the layers multiply them, 64 k-columns at a time: a stage
//     holds a 64-column slice of up to 512 output rows in 64-row boxes
//     (128-byte rows: whole L2 lines; 128-byte swizzle; 64 KB), the two
//     warpgroups' rows side by side.  It completes on the stage's `full`
//     mbarrier and is refilled once the consumers' eight warps have
//     arrived on its `empty` one.  TMA's zero fill covers the columns and
//     rows past a matrix's edge.  At W=512 the buffer (64 KB) and the x and
//     v tiles (16 KB) leave room for two stages; narrower trunks get up to
//     four.
//   * A layer's n output columns split into 64-column blocks, the first
//     half of the blocks to warpgroup 0, the rest to warpgroup 1; each runs
//     one wgmma.mma_async m64nNk16 per k-step (N = 64..256, its blocks), the
//     f32 accumulators in registers, and waits for a stage's products
//     before releasing it.
//   * The epilogue works straight from the accumulator fragments: + bias,
//     relu (not on the feature layer), rounded to bf16 pairs, stored at the
//     buffer's swizzled address; then every consumer fences the async proxy
//     (wgmma reads shared memory through it) and the consumers meet before
//     the next layer's products.  The heads go from the accumulators to
//     h_alpha / h_rgb in f32, rows < B only.
//   * The embedding is staged by the consumer threads through its row
//     stride, rounded to bf16, padded columns and rows past B zero-filled,
//     into the swizzled x and v tiles (TMA cannot convert f32 to bf16).
// Depth, width and the head widths are runtime values.  What the choices
// rest on (H100 SXM, a flat tile): two activation buffers left room for two
// 32-column stages only, 64-byte TMA rows, ~20.3 ms; one buffer and
// 64-column stages, ~17.1 ms; four 32-column stages were no faster than
// two, 16-column stages twice as slow, and a cluster of two CTAs sharing
// each weight box by TMA multicast slower in both widths (28.1 and 21.4
// ms): the time followed the TMA rows' width, not the ring's depth, and
// halving the weight bytes each CTA fetched did not lower it.
//
// Training: the kernel is a template on kSave.  The serving entry
// (trunk_fwd) runs kSave = false.  The training entry (trunk_fwd_save)
// runs kSave = true: the same products and epilogues, and every bf16
// activation also goes to a workspace (x, v, h_0..h_{D-1}, f, hv;
// trunk.cuh's ActPlan, whose bytes trunk_fwd_workspace returns), which
// trunk_bwd.cu reads instead of recomputing the forward.  Once the
// consumers have met after an epilogue, one thread copies the buffer's
// boxes out by TMA stores (cp.async.bulk.tensor, shared to global, the same
// 128-byte swizzle, so the workspace comes out row-major) in one bulk
// group, and goes on: the copy runs behind the next layer's products, and
// before that layer's epilogue overwrites the buffer the thread waits for
// it to have read its source (cp.async.bulk.wait_group.read).  That adds
// ~9.9 KB a row of writes at D8/W512 (0.81 GB at the flat training step's
// 81,920 rows, ~0.24 ms at 3.35 TB/s) and no arithmetic; measured, it
// costs ~0.45 ms over the serving variant at that step.
//
// Members: one launch may run M ensemble members' trunks, as the vmap of
// JAX's ensemble step gives the Pallas kernel a leading member axis in its
// grid.  The grid is (row tiles, M); member m's weights and biases are the
// m-th copies in the packed buffers (M x w_total, M x b_total), its rows
// B of the embedding after the earlier members' (B a member), its saved
// activations the m-th ActPlan block of the workspace.  Every tensor map
// holds all M copies, addressed by a member coordinate (hopper.cuh's
// encode_members), so the kernel's parameters do not grow with M.  A
// member's arithmetic is that of a launch of it alone.
//
// What is left: each CTA reads all the weights from L2 for its 64 rows,
// and a layer's epilogue does not overlap the next layer's products (a
// persistent grid would); the saves cost twice their bytes' time.

#include <cstdint>

#include "hopper.cuh"
#include "trunk.cuh"

namespace {

constexpr int kConsumers = 256;             // two consumer warpgroups
constexpr int kThreads = kConsumers + 128;  // and the producer warpgroup
constexpr int kBox = 64;                    // columns of an activation box: 128 bytes
constexpr int kBoxBytes = kRows * kBox * 2;  // 8 KB
constexpr int kChunk = 64;                  // k-columns of a weight stage: 128-byte rows
constexpr int kBlock = 64;                  // output rows of a weight box
constexpr int kWBoxBytes = kBlock * kChunk * 2;         // 8 KB
constexpr int kMaxBlocks = 4;               // a warpgroup's blocks: up to 256 columns
constexpr int kWgStageBytes = kMaxBlocks * kWBoxBytes;  // 32 KB
constexpr int kStageBytes = 2 * kWgStageBytes;         // 64 KB
constexpr int kMaxStages = 4;
constexpr int kMaxOps = kMaxDepth + 6;

__host__ __device__ inline int boxes(int cols) { return (cols + kBox - 1) / kBox; }

// The tensor maps, all with the 128-byte swizzle and a member coordinate:
// the weights, read in kChunk x kBlock boxes (w0, wsx, every W-wide matrix
// from w1 through wvf as one (rows, W) matrix, wvv, whr); the saved
// activations, written in kBox x kRows boxes (x, v, h_0..h_{D-1} and f as
// one matrix, hv).
enum MapId { kMapW0, kMapWsx, kMapW, kMapWvv, kMapWhr, kMapX, kMapV, kMapH, kMapHv, kMaps };

// A product's operand B: rows [row0, row0 + n) and columns [0, k) of
// tensor map `map`, i.e. n output columns of a layer with k inputs.
struct Op {
  int map, row0, k, n;
};

// The operands in the order the layers multiply them, and the ring's depth.
struct alignas(64) FwdParams {
  CUtensorMap map[kMaps];
  Op op[kMaxOps];
  int n_ops, stages;
};

// Shared memory (offsets from a 1024-aligned base): the activation buffer,
// the x and v tiles, the weight stages, their full and empty barriers.
struct FwdSmem {
  int off_x, off_v, off_stage, off_bar, stages, bytes;
  __host__ __device__ FwdSmem(int width, int in_pad, int v_pad) {
    off_x = boxes(width) * kBoxBytes;
    off_v = off_x + boxes(in_pad) * kBoxBytes;
    off_stage = off_v + boxes(v_pad) * kBoxBytes;
    const int room = kMaxSmem - 1024 - off_stage - 2 * kMaxStages * 8;
    stages = room < 0 ? 0 : room / kStageBytes;
    if (stages > kMaxStages) stages = kMaxStages;
    off_bar = off_stage + stages * kStageBytes;
    bytes = off_bar + 2 * kMaxStages * 8 + 1024;  // + the base's alignment
  }
};

// Byte offset of (row, col) in an activation tile: 64-column boxes of 64
// rows, 128 bytes a row, the 16-byte chunks of row r permuted by r % 8 (the
// 128-byte swizzle TMA and wgmma use).
__device__ __forceinline__ uint32_t swz(int row, int col) {
  return (col / kBox) * kBoxBytes + row * 128 + ((((col % kBox) >> 3) ^ (row & 7)) << 4) +
         (col & 7) * 2;
}

// Stages the tile's embedding as bf16: n columns of emb from column
// `first` into `tile`, zero-filling the padded columns and the rows past
// the end of the batch; emb is read through its row stride.  By the
// consumer threads, 8 columns (16 bytes) a thread.
__device__ __forceinline__ void stage_inputs(const float* __restrict__ emb, int emb_stride,
                                             long long row0, int rows_valid, int first, int n,
                                             unsigned char* tile) {
  const int per_row = round16(n) / 8;
  const float* src = emb + row0 * emb_stride + first;
  for (int idx = threadIdx.x; idx < kRows * per_row; idx += kConsumers) {
    const int r = idx / per_row, c = (idx - r * per_row) * 8;
    uint4 packed;
    __nv_bfloat162* p2 = reinterpret_cast<__nv_bfloat162*>(&packed);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c0 = c + 2 * e;
      const bool row_ok = r < rows_valid;
      const float a = row_ok && c0 < n ? src[(size_t)r * emb_stride + c0] : 0.f;
      const float b = row_ok && c0 + 1 < n ? src[(size_t)r * emb_stride + c0 + 1] : 0.f;
      p2[e] = __floats2bfloat162_rn(a, b);
    }
    *reinterpret_cast<uint4*>(tile + swz(r, c)) = packed;
  }
}

// The producer thread: every operand's k-chunks in the order the consumers
// take them, each into the next stage of the ring once the consumers have
// freed it.  A stage holds warpgroup 0's blocks (the first half, rounded
// up) at its start and warpgroup 1's at kWgStageBytes.
__device__ __forceinline__ void produce(const FwdParams& P, unsigned char* stages, uint64_t* full,
                                        uint64_t* empty) {
  const int member = blockIdx.y;
  int c = 0;
  for (int i = 0; i < P.n_ops; ++i) {
    const Op& o = P.op[i];
    const int nb = (o.n + kBlock - 1) / kBlock, nb0 = (nb + 1) / 2;
    for (int k0 = 0; k0 < o.k; k0 += kChunk, ++c) {
      const int st = c % P.stages;
      if (c >= P.stages) mbar_wait(&empty[st], (c / P.stages - 1) & 1);
      mbar_expect_tx(&full[st], nb * kWBoxBytes);
      unsigned char* s = stages + st * kStageBytes;
      for (int b = 0; b < nb; ++b) {
        unsigned char* dst =
            b < nb0 ? s + b * kWBoxBytes : s + kWgStageBytes + (b - nb0) * kWBoxBytes;
        tma_load(dst, &P.map[o.map], k0, o.row0 + b * kBlock, member, &full[st]);
      }
    }
  }
}

enum Epilogue { kRelu, kLinear, kGlobal };

// One consumer warpgroup: its products and epilogues, in the order of the
// producer's stream.
struct Consumer {
  const FwdParams& P;
  unsigned char* stages;
  uint64_t* full;
  uint64_t* empty;
  int wg, warp, lane;
  int chunk = 0, op = 0;  // stages and operands consumed

  __device__ Consumer(const FwdParams& p, unsigned char* s, uint64_t* f, uint64_t* e)
      : P(p), stages(s), full(f), empty(e) {
    wg = threadIdx.x / 128;
    warp = (threadIdx.x / 32) & 3;
    lane = threadIdx.x & 31;
  }

  // acc += A B for the next operand of the stream: A (64 x k, bf16, an
  // activation tile at shared address `a`), B this warpgroup's blocks of
  // the stage.  NB blocks are computed; only this warpgroup's own are
  // stored by the epilogue.  A warpgroup with no block only keeps the
  // ring's count.
  template <int NB>
  __device__ __forceinline__ void product(float (&acc)[NB * 32], uint32_t a) {
    const Op& o = P.op[op++];
    const int nb = (o.n + kBlock - 1) / kBlock;
    const bool mine = wg == 0 || nb > (nb + 1) / 2;
    for (int k0 = 0; k0 < o.k; k0 += kChunk, ++chunk) {
      const int st = chunk % P.stages;
      mbar_wait(&full[st], (chunk / P.stages) & 1);
      if (mine) {
        const uint32_t b = smem_u32(stages + st * kStageBytes + wg * kWgStageBytes);
        fence_acc<NB * 64>(acc);
        asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
        for (int ks = 0; ks < kChunk / 16; ++ks) {
          const int k = k0 + 16 * ks;
          if (k < o.k)
            wgmma_ss<NB * 64>(acc, wgmma_desc_k(a + (k / kBox) * kBoxBytes + (k % kBox) * 2),
                              wgmma_desc_k(b + ks * 32));
        }
        asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
        asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
        fence_acc<NB * 64>(acc);
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
    }
  }

  // The epilogue on this warpgroup's columns [col0, col0 + 64 NB) of an
  // n-column layer, straight from the accumulator layout (row warp*16 +
  // lane/4 (+8), columns 8j + 2 (lane % 4) (+1)): + bias, then kGlobal
  // writes f32 rows < rows_valid to out_g (leading dimension n); kRelu and
  // kLinear round to bf16 into the activation tile `out`.
  template <int NB>
  __device__ __forceinline__ void epilogue(const float (&acc)[NB * 32], int col0, int n,
                                           const float* __restrict__ bias, Epilogue kind,
                                           unsigned char* out, float* out_g,
                                           int rows_valid) const {
    const int r0 = warp * 16 + (lane >> 2);
#pragma unroll
    for (int j = 0; j < NB * 8; ++j) {
      const int col = col0 + 8 * j + 2 * (lane & 3);
      if (col >= n) continue;
      const float2 bc = *reinterpret_cast<const float2*>(bias + col);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = r0 + 8 * h;
        float v0 = acc[4 * j + 2 * h] + bc.x, v1 = acc[4 * j + 2 * h + 1] + bc.y;
        if (kind == kGlobal) {
          if (row < rows_valid)
            *reinterpret_cast<float2*>(out_g + (size_t)row * n + col) = make_float2(v0, v1);
        } else {
          if (kind == kRelu) {
            v0 = fmaxf(v0, 0.f);
            v1 = fmaxf(v1, 0.f);
          }
          *reinterpret_cast<__nv_bfloat162*>(out + swz(row, col)) = __floats2bfloat162_rn(v0, v1);
        }
      }
    }
  }

  template <int NB, typename Before>
  __device__ __forceinline__ void layer_nb(uint32_t a0, uint32_t a1, bool two, const float* bias,
                                           Epilogue kind, unsigned char* out, float* out_g,
                                           int rows_valid, Before& before) {
    const int n = P.op[op].n;
    const int nb = (n + kBlock - 1) / kBlock, nb0 = (nb + 1) / 2;
    float acc[NB * 32];
#pragma unroll
    for (int e = 0; e < NB * 32; ++e) acc[e] = 0.f;
    product<NB>(acc, a0);
    if (two) product<NB>(acc, a1);
    before();
    if (wg == 0 || nb > nb0)
      epilogue<NB>(acc, wg * nb0 * kBlock, n, bias, kind, out, out_g, rows_valid);
  }

  // out = epilogue(A0 B0 [+ A1 B1] + bias) for the next one or two operands
  // of the stream, `before()` between the products and the epilogue; the
  // accumulators sized by the warpgroups' share of the columns.
  template <typename Before>
  __device__ __forceinline__ void layer(uint32_t a0, uint32_t a1, bool two, const float* bias,
                                        Epilogue kind, unsigned char* out, float* out_g,
                                        int rows_valid, Before&& before) {
    const int nb0 = ((P.op[op].n + kBlock - 1) / kBlock + 1) / 2;
    if (nb0 == 1) layer_nb<1>(a0, a1, two, bias, kind, out, out_g, rows_valid, before);
    else if (nb0 == 2) layer_nb<2>(a0, a1, two, bias, kind, out, out_g, rows_valid, before);
    else if (nb0 == 3) layer_nb<3>(a0, a1, two, bias, kind, out, out_g, rows_valid, before);
    else layer_nb<4>(a0, a1, two, bias, kind, out, out_g, rows_valid, before);
  }
};

// The consumers' part of the kernel: the embedding staged, the layers and
// heads in order, and (kSave) the activations saved.  Every layer reads
// the activation buffer and overwrites it: its epilogue waits until both
// warpgroups' products are done.  The consumers meet at named barrier 1.
// Pointers and B are the CTA's member's (trunk_fwd_kernel offsets them).
template <bool kSave>
__device__ __forceinline__ void consume(const FwdParams& P, unsigned char* smem, const FwdSmem& M,
                                        uint64_t* full, uint64_t* empty,
                                        const float* __restrict__ emb, int emb_stride, int B,
                                        const float* __restrict__ bias, float* __restrict__ h_alpha,
                                        float* __restrict__ h_rgb, int rows_pad, int depth,
                                        int width, int input_ch, int views_ch, int ha, int hr) {
  const int member = blockIdx.y;
  auto consumers_sync = [] { asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumers) : "memory"); };
  Consumer C(P, smem + M.off_stage, full, empty);
  const int in_pad = round16(input_ch), v_pad = round16(views_ch);
  unsigned char* buf = smem;
  unsigned char* xs = smem + M.off_x;
  unsigned char* vs = smem + M.off_v;
  const uint32_t ba = smem_u32(buf), xa = smem_u32(xs), va = smem_u32(vs);
  const long long row0 = (long long)blockIdx.x * kRows;
  const int rows_valid = (int)min((long long)kRows, (long long)B - row0);
  const int r0 = (int)row0;
  const bool saver = kSave && threadIdx.x == 0;  // one thread saves

  stage_inputs(emb, emb_stride, row0, rows_valid, 0, input_ch, xs);
  stage_inputs(emb, emb_stride, row0, rows_valid, input_ch, views_ch, vs);
  // Before an epilogue overwrites the buffer: both warpgroups' products
  // have read it, and (kSave) its copy out, issued a layer ago, has read it.
  auto overwrite = [&] {
    if (saver) bulk_wait_read<0>();
    consumers_sync();
  };
  auto nothing = [] {};
  // After an epilogue has written the buffer: every writer fences the async
  // proxy, they meet; kSave: one thread copies the buffer's boxes to rows
  // `row` of map `m` by TMA, one bulk group, and goes on.
  auto publish = [&](int cols, int m, int row) {
    fence_proxy_async();
    consumers_sync();
    if (saver) {
      for (int b = 0; b < boxes(cols); ++b)
        tma_store(&P.map[m], b * kBox, row, member, buf + b * kBoxBytes);
      bulk_commit();
    }
  };
  fence_proxy_async();
  consumers_sync();
  if (saver) {
    for (int b = 0; b < boxes(in_pad); ++b)
      tma_store(&P.map[kMapX], b * kBox, r0, member, xs + b * kBoxBytes);
    for (int b = 0; b < boxes(v_pad); ++b)
      tma_store(&P.map[kMapV], b * kBox, r0, member, vs + b * kBoxBytes);
    bulk_commit();
  }

  const int skip = depth / 2, half = width / 2;
  C.layer(xa, 0, false, bias, kRelu, buf, nullptr, 0, nothing);  // nothing read the buffer yet
  publish(width, kMapH, r0);
  for (int i = 1; i < depth; ++i) {
    const float* b = bias + i * width;
    if (i == skip + 1) C.layer(xa, ba, true, b, kRelu, buf, nullptr, 0, overwrite);  // x Wsx + h Wsh
    else C.layer(ba, 0, false, b, kRelu, buf, nullptr, 0, overwrite);
    publish(width, kMapH, i * rows_pad + r0);
  }

  // heads: the buffer holds the trunk output h
  const float* bha = bias + depth * width;
  const float* bf = bha + ha;
  const float* bv = bf + width;
  const float* bhr = bv + half;
  C.layer(ba, 0, false, bha, kGlobal, nullptr, h_alpha + row0 * ha, rows_valid, nothing);
  C.layer(ba, 0, false, bf, kLinear, buf, nullptr, 0, overwrite);
  publish(width, kMapH, depth * rows_pad + r0);
  C.layer(ba, va, true, bv, kRelu, buf, nullptr, 0, overwrite);  // f Wvf + v Wvv
  publish(half, kMapHv, r0);
  C.layer(ba, 0, false, bhr, kGlobal, nullptr, h_rgb + row0 * hr, rows_valid, nothing);
  if (saver) bulk_wait_all();
}

// Grid (row tiles, members); B rows a member, bias_stride floats of biases
// a member.
template <bool kSave>
__global__ void __launch_bounds__(kThreads, 1)
trunk_fwd_kernel(const __grid_constant__ FwdParams P, const float* __restrict__ emb,
                 int emb_stride, int B, const float* __restrict__ bias, int bias_stride,
                 float* __restrict__ h_alpha, float* __restrict__ h_rgb, int rows_pad, int depth,
                 int width, int input_ch, int views_ch, int ha, int hr) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int in_pad = round16(input_ch), v_pad = round16(views_ch);
  const FwdSmem M(width, in_pad, v_pad);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + M.off_bar);
  uint64_t* empty = full + kMaxStages;
  if (threadIdx.x == 0) {
    for (int i = 0; i < P.stages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], kConsumers / 32);  // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= kConsumers) {  // the producer warpgroup: one thread streams
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == kConsumers) produce(P, smem + M.off_stage, full, empty);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const long long rows_before = (long long)blockIdx.y * B;  // the earlier members' rows
    consume<kSave>(P, smem, M, full, empty, emb + rows_before * emb_stride, emb_stride, B,
                   bias + (size_t)blockIdx.y * bias_stride, h_alpha + rows_before * ha,
                   h_rgb + rows_before * hr, rows_pad, depth, width, input_ch, views_ch, ha, hr);
  }
}

bool shape_ok(int B, int depth, int width, int input_ch, int views_ch, int ha, int hr) {
  return B >= 0 && depth >= 3 && depth <= kMaxDepth && width >= 32 && width % 32 == 0 &&
         input_ch >= 1 && views_ch >= 1 && ha >= 16 && ha % 16 == 0 && hr >= 16 &&
         hr % 16 == 0;
}

// The kernel's parameters: the weights' tensor maps and the operands in the
// order the layers multiply them; with `acts` (kSave) the saved
// activations' tensor maps; every map over the `members` copies.  false if
// a tensor map cannot be made.
bool make_params(FwdParams& p, const bf16* w, const unsigned char* acts, const ActPlan& A,
                 int members, int depth, int width, int in_pad, int v_pad, int ha, int hr,
                 int stages) {
  const Layout L(depth, width, in_pad, v_pad, ha, hr);
  const int half = width / 2;
  const long long base = L.w[1];
  auto wmap = [&](int id, long long off, long long rows, int cols) {
    return encode_members(&p.map[id], w + off, members, L.w_total * 2, rows, cols, kChunk,
                          kBlock);
  };
  if (!wmap(kMapW0, L.w[0], width, in_pad) || !wmap(kMapWsx, L.wsx, width, in_pad) ||
      !wmap(kMapW, base, (L.wvv - base) / width, width) || !wmap(kMapWvv, L.wvv, half, v_pad) ||
      !wmap(kMapWhr, L.whr, hr, half)) {
    return false;
  }
  if (acts != nullptr) {
    const long long R = A.rows_pad;
    auto amap = [&](int id, long long off, long long rows, int cols) {
      return encode_members(&p.map[id], acts + off, members, A.bytes, rows, cols, kBox, kRows);
    };
    if (!amap(kMapX, A.x, R, in_pad) || !amap(kMapV, A.v, R, v_pad) ||
        !amap(kMapH, A.h, (depth + 1) * R, width) || !amap(kMapHv, A.hv, R, half)) {
      return false;
    }
  }
  auto row = [&](long long off) { return (int)((off - base) / width); };
  p.n_ops = 0;
  auto add = [&](int map, int row0, int k, int n) { p.op[p.n_ops++] = Op{map, row0, k, n}; };
  add(kMapW0, 0, in_pad, width);
  for (int i = 1; i < depth; ++i) {
    if (i == depth / 2 + 1) add(kMapWsx, 0, in_pad, width);
    add(kMapW, row(L.w[i]), width, width);
  }
  add(kMapW, row(L.wha), width, ha);
  add(kMapW, row(L.wf), width, width);
  add(kMapW, row(L.wvf), width, half);
  add(kMapWvv, 0, v_pad, half);
  add(kMapWhr, 0, half, hr);
  p.stages = stages;
  return true;
}

template <bool kSave>
int launch(const float* emb, int emb_stride, const void* w, const float* bias, float* h_alpha,
           float* h_rgb, unsigned char* acts, int B, int members, int depth, int width,
           int input_ch, int views_ch, int ha, int hr, void* stream) {
  const int in_pad = round16(input_ch), v_pad = round16(views_ch);
  const FwdSmem M(width, in_pad, v_pad);
  if (M.stages < 2 || M.bytes > kMaxSmem) return (int)cudaErrorInvalidValue;
  if (B == 0) return 0;
  // a runtime call first: it makes the device's context current on this
  // thread, which cuTensorMapEncodeTiled needs
  const cudaError_t attr = cudaFuncSetAttribute(
      trunk_fwd_kernel<kSave>, cudaFuncAttributeMaxDynamicSharedMemorySize, M.bytes);
  if (attr != cudaSuccess) return (int)attr;
  const ActPlan A(B, depth, width, in_pad, v_pad);
  FwdParams p;
  if (!make_params(p, static_cast<const bf16*>(w), acts, A, members, depth, width, in_pad, v_pad,
                   ha, hr, M.stages)) {
    return (int)cudaErrorInvalidValue;
  }
  const Layout L(depth, width, in_pad, v_pad, ha, hr);
  const dim3 grid((unsigned)((B + kRows - 1) / kRows), (unsigned)members);
  trunk_fwd_kernel<kSave><<<grid, kThreads, M.bytes, static_cast<cudaStream_t>(stream)>>>(
      p, emb, emb_stride, B, bias, L.b_total, h_alpha, h_rgb, (int)A.rows_pad, depth, width,
      input_ch, views_ch, ha, hr);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry points (bound with ctypes).  `members` trunks of B rows each (1:
// one trunk).  emb: device f32 (members x B, input_ch + views_ch), a
// member's rows after the earlier members', row stride `emb_stride` floats,
// columns contiguous; w: device bf16 weights and bias: device f32 biases, as
// laid out above, the members' copies back to back; h_alpha (members x B,
// ha) and h_rgb (members x B, hr): device f32, contiguous.  The caller
// checks shapes and types; these check what the kernel's layout needs.
// Each launches on `stream` and returns the CUDA error of the launch (0 on
// success); none synchronises.

// The serving forward: h_alpha and h_rgb only.
extern "C" int trunk_fwd(const float* emb, int emb_stride, const void* w,
                         const float* bias, float* h_alpha, float* h_rgb, int B,
                         int depth, int width, int input_ch, int views_ch, int ha,
                         int hr, int members, void* stream) {
  if (!shape_ok(B, depth, width, input_ch, views_ch, ha, hr) ||
      emb_stride < input_ch + views_ch || members < 1) {
    return (int)cudaErrorInvalidValue;
  }
  return launch<false>(emb, emb_stride, w, bias, h_alpha, h_rgb, nullptr, B, members, depth,
                       width, input_ch, views_ch, ha, hr, stream);
}

// The bytes of activations trunk_fwd_save writes for B rows of this trunk
// (ActPlan), a member's; -1 for a shape it does not take.
extern "C" long long trunk_fwd_workspace(int B, int depth, int width, int input_ch,
                                         int views_ch) {
  if (!shape_ok(B, depth, width, input_ch, views_ch, 16, 16)) return -1;
  return ActPlan(B, depth, width, round16(input_ch), round16(views_ch)).bytes;
}

// Where trunk_fwd_save puts each activation for B rows of this trunk:
// ActPlan's rows_pad, x, v, h, f, hv and bytes, in that order, into
// out[0..6].  0, or -1 (out untouched) for a shape it does not take.
extern "C" int trunk_fwd_act_plan(int B, int depth, int width, int input_ch, int views_ch,
                                  long long* out) {
  if (!shape_ok(B, depth, width, input_ch, views_ch, 16, 16)) return -1;
  const ActPlan P(B, depth, width, round16(input_ch), round16(views_ch));
  const long long fields[7] = {P.rows_pad, P.x, P.v, P.h, P.f, P.hv, P.bytes};
  for (int i = 0; i < 7; ++i) out[i] = fields[i];
  return 0;
}

// The training forward: as trunk_fwd, and every bf16 activation into
// `acts` (device memory of members x trunk_fwd_workspace's bytes, a
// member's ActPlan block after another), which trunk_bwd reads.
extern "C" int trunk_fwd_save(const float* emb, int emb_stride, const void* w,
                              const float* bias, float* h_alpha, float* h_rgb, void* acts,
                              long long acts_bytes, int B, int depth, int width,
                              int input_ch, int views_ch, int ha, int hr, int members,
                              void* stream) {
  if (!shape_ok(B, depth, width, input_ch, views_ch, ha, hr) ||
      emb_stride < input_ch + views_ch || members < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const ActPlan P(B, depth, width, round16(input_ch), round16(views_ch));
  if (acts_bytes < members * P.bytes) return (int)cudaErrorInvalidValue;
  return launch<true>(emb, emb_stride, w, bias, h_alpha, h_rgb,
                      static_cast<unsigned char*>(acts), B, members, depth, width, input_ch,
                      views_ch, ha, hr, stream);
}
