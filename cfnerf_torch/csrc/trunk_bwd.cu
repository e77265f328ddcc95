// NeRF trunk backward for Hopper (sm_90a): the weight and bias gradients of
// the trunk forward (trunk.cu) from the cotangents of h_alpha and h_rgb, on
// bf16 tensor cores with f32 accumulators.
//
// Replaces: cfnerf_tpu/ops/pallas/trunk.py:_bwd_top_kernel and
// cfnerf_tpu/ops/pallas/trunk.py:_bwd_bottom_kernel (both launched by
// _trunk_bwd, the custom VJP of pallas_encode).  Same arithmetic: the
// forward's activations as trunk.cu computes them; both operands of every
// product rounded to bf16 (the cotangents too) and summed in f32; the relu
// mask taken from the bf16 activation; bias gradients summed from the f32
// gradient; the skip layer's gradient split between wsx and wsh, the views
// layer's between wvf and wvv; no gradient for the input.  dW comes out in
// f32 in the packed (out, in_padded) layout of the forward's weights
// (trunk.py:_layout), db in f32.  The TPU kernels recompute the forward in
// VMEM; here trunk.cu's training variant (trunk_fwd_save) writes every
// bf16 activation once, into a workspace in trunk.cuh's ActPlan layout,
// and this backward reads it: the same values, none of the recompute.
//
// What bounds it on an H100: operations.  At D8/W512 a point costs
// 4,626,176 multiply-adds (the weight gradients 2,348,800, the gradients
// through every layer but the x and view inputs 2,277,376): the flat
// training tile (640 rays x 128 samples = 81,920 points) is 758 GFLOP,
// 0.766 ms at the 989 TFLOP/s bf16 dense peak, the weight-gradient pass
// alone 385 GFLOP, 0.389 ms; the bytes (the saved activations, 0.81 GB, the
// cotangents, weights and outputs) take 0.26 ms at 3.35 TB/s
// (chip_smoke.py:trunk_bwd_work counts both).
//
// What the design does about it.  An H100 block has 227 KB of shared
// memory and a grid in no order, so the work splits in two:
//   * trunk_bwd_data: one CTA per 64 rows, two consumer warpgroups and a
//     producer warp, walks back through the heads and the layers, each step
//     one product g W on wgmma (m64n64k16): A, the gradient tile in shared
//     memory, loaded by ldmatrix into registers; B, the weight matrix as
//     stored ((out, in), MN-major), streamed by TMA in 32-row x 64-column
//     boxes (128-byte swizzle) through four stages per warpgroup, which the
//     producer refills once the warpgroup's four warps have arrived on the
//     stage's `empty` mbarrier; one wgmma group stays in flight.  A product
//     runs in passes of 256 columns, each warpgroup owning two 64-column
//     blocks (64 f32 accumulator registers).  The epilogue, straight from
//     the accumulator layout: the relu mask read from the saved activations
//     (fetched into L2 while the pass's products run), the bf16 gradient
//     into shared memory (the next step's A operand), each column's 64 f32
//     values summed in a fixed order (per thread, a butterfly over the
//     warp's rows, the four warps in order) for db, one row of partials
//     per CTA; after a barrier the step's tile is copied out, coalesced, to
//     the scratch for the weight-gradient pass.  Two (64, W) bf16 buffers,
//     the g_ha tile and 64 KB of stages: 207 KB of shared memory at W=512.
//   * trunk_bwd_wgrad: dW = G^T H for every matrix in one launch, a
//     textbook GEMM with K = the rows.  A CTA owns a 128 x N tile of one dW
//     (N = 64, 128 or 256, the wgmma width that covers the matrix) and a
//     contiguous range of rows.  One producer thread keeps four stages of
//     64 rows in flight by TMA (cp.async.bulk.tensor, 64-column boxes in
//     the 128-byte swizzle, completing on mbarriers); two consumer
//     warpgroups each run wgmma.mma_async m64nNk16 on their 64 rows, both
//     operands MN-major in shared memory (G read as G^T, H as it is,
//     through the transpose immediates), f32 accumulators in registers.
//     The rows split into a few ranges, set by the shape alone, so that the
//     grid fills the card; each range writes its own f32 partial.
//   * two reductions add the partials, dW over the row ranges and db over
//     the CTAs, in a fixed order.  No atomics: two launches give the same
//     bits.
// Members: one call may run M ensemble members' backwards, as the vmap of
// JAX's ensemble step gives the Pallas kernels a leading member axis in
// their grids.  Every kernel's grid gains a member axis (the data pass
// (CTAs, M), the weight-gradient pass (tiles, row ranges, M), both
// reductions); member m reads its copy of the weights, its rows of the
// cotangents and its ActPlan block of the saved activations, and writes
// its block of the scratch (a member's Plan, the same as a launch of it
// alone: the same row ranges, the same sums in the same order) and its
// rows of dW (M x w_total) and db (M x b_total).  The tensor maps hold
// every member's copy, addressed by a member coordinate.
// The tensor maps come from cuTensorMapEncodeTiled, fetched through
// cudaGetDriverEntryPoint (no libcuda link), and ride in the kernels'
// __grid_constant__ parameters.  A barrier wait that lasts ~10 s traps, so
// a lost transaction fails the launch instead of hanging the card.  These
// Hopper pieces (mbarriers, TMA, wgmma, the encoder) live in hopper.cuh,
// shared with the forward.  The
// scratch is ~10 KB a row at D8/W512 beside the forward's ~9.9 KB
// (trunk_bwd_workspace and trunk.cu's trunk_fwd_workspace say their sizes).
// What is left: every 64-row CTA streams all the weights from L2 (a
// cluster of two sharing them by TMA multicast would halve that); the
// epilogue's uncoalesced mask reads and the copy-out are not overlapped
// with the next step's products; the weight-gradient consumers wait for
// each chunk's wgmma before freeing its stage; the weight gradient is not
// fused into the data pass.

#include <algorithm>
#include <cstdint>

#include "hopper.cuh"
#include "trunk.cuh"

namespace {

constexpr int kMaxJobs = kMaxDepth + 6;  // D + 6 weight matrices
// the weight-gradient pass: a CTA owns kWgradM dW rows (two consumer
// warpgroups of 64) x n_tile columns (64, 128 or 256) over a range of rows,
// kWgradChunk rows a pipeline stage; TMA copies 64-column boxes (128 bytes
// wide, the 128-byte swizzle's span)
constexpr int kWgradM = 128;
constexpr int kWgradChunk = 64;
constexpr int kWgradStages = 4;
constexpr int kBox = 64;
constexpr int kBoxBytes = kBox * kWgradChunk * 2;           // 8 KB
constexpr int kStageGBytes = (kWgradM / kBox) * kBoxBytes;  // G: 2 boxes
constexpr int kStageHBytes = (256 / kBox) * kBoxBytes;      // H: up to 4 boxes
constexpr int kWgradStageBytes = kStageGBytes + kStageHBytes;
constexpr int kWgradSmem = kWgradStages * kWgradStageBytes + 1024 + 2 * kWgradStages * 8;
constexpr int kWgradThreads = 384;  // one producer warpgroup, two consumer warpgroups
constexpr int kTargetCtas = 528;    // ~4 per SM on 132 SMs: the row ranges fill the card

// The backward's own scratch: the bf16 gradients, rows_pad rows each (g_0..
// g_{D-1} then g_f, one (D + 1) x rows_pad x width block, as ActPlan keeps
// h_0..h_{D-1} then f), then the f32 partials.  Offsets in bytes from the
// workspace's start, 256-aligned.  The activations are the forward's
// (ActPlan, in trunk.cuh).
struct Plan {
  int rows_pad, n_ctas, splits, rows_per_split;
  long long g, gf, gv, ga, gr, db_part, dw_part, bytes;

  Plan(int B, int depth, int width, int ha, int hr, int n_tiles, long long w_total,
       int b_total) {
    rows_pad = (B + kRows - 1) / kRows * kRows;
    n_ctas = rows_pad / kRows;
    const int chunks = std::max(1, rows_pad / kWgradChunk);
    const int want = std::max(1, std::min(chunks, (kTargetCtas + n_tiles - 1) / n_tiles));
    const int per = (chunks + want - 1) / want;  // chunks per row range
    splits = (chunks + per - 1) / per;
    rows_per_split = per * kWgradChunk;
    const long long R = rows_pad, half = width / 2;
    g = 0;
    gf = g + (long long)depth * R * width * 2;
    gv = g + align256((long long)(depth + 1) * R * width * 2);
    ga = gv + align256(R * half * 2);
    gr = ga + align256(R * ha * 2);
    db_part = gr + align256(R * hr * 2);
    dw_part = db_part + align256((long long)n_ctas * b_total * 4);
    bytes = dw_part + align256((long long)splits * w_total * 4);
  }
};

// the data pass
// ---------------------------------------------------------------------------

// One CTA per kRows rows: two consumer warpgroups and a producer warp.  A
// gradient step's product (64 x n) = A (64 x k, bf16 in shared memory) B
// (k x n, a weight matrix as stored: (out, in), k = its out, n = its in)
// runs in passes of at most kDataPass columns, each split into 64-column
// blocks, block j to warpgroup j % 2: up to kDataBlocks wgmma m64n64k16
// accumulators a warpgroup.  The producer streams each warpgroup's blocks
// of B by TMA, kDataChunk rows at a time, through a ring of kDataStages
// stages per warpgroup, and refills a stage once that warpgroup's four
// warps have arrived on its `empty` barrier.
constexpr int kDataConsumers = 256;
constexpr int kDataThreads = kDataConsumers + 32;
constexpr int kDataChunk = 32;
constexpr int kDataStages = 4;
constexpr int kDataBlocks = 2;
constexpr int kDataPass = 2 * kDataBlocks * kBox;              // 256 columns
constexpr int kDataBoxBytes = kBox * kDataChunk * 2;           // 4 KB
constexpr int kDataStageBytes = kDataBlocks * kDataBoxBytes;  // 8 KB
constexpr int kMaxOps = 2 * (kMaxDepth + 3);

// A pass's operand B: rows [row0, row0 + k) and columns [col0, col0 + n)
// of tensor map `map`.
enum DataMapId { kDMapW, kDMapHr, kDMaps };
struct DOp {
  int map, row0, k, col0, n;
};

// The operands in the order the data pass multiplies them, pass by pass:
// Whr, Wvf, Wf with Wha, then W_{D-1} .. W_1 (wsh at the skip layer).
struct alignas(64) DataParams {
  CUtensorMap map[kDMaps];
  DOp op[kMaxOps];
  int n_ops, n_chunks;
};

// Shared memory (offsets from a 1024-aligned base): two (kRows x (width +
// kPad)) bf16 buffers (a step's A operand and its output, in turn), the
// g_ha tile, each consumer warp's column partials (two sets, by pass
// parity), the stages' full and empty barriers, the stages.
struct DataSmem {
  int ldh, ldga;
  int off_buf1, off_ga, off_red, off_bar, off_stage, bytes;
  __host__ __device__ DataSmem(int width, int ha) {
    ldh = width + kPad;
    ldga = ha + kPad;
    off_buf1 = kRows * ldh * 2;
    off_ga = 2 * off_buf1;
    off_red = off_ga + kRows * ldga * 2;
    off_bar = off_red + 2 * (kDataConsumers / 32) * kDataPass / 2 * 4;
    off_stage = (off_bar + 4 * kDataStages * 8 + 1023) / 1024 * 1024;
    bytes = off_stage + 2 * kDataStages * kDataStageBytes + 1024;  // + the base's alignment
  }
};

// The stream's chunks of a k-row operand (the last may hold 16 rows).
__host__ __device__ inline int chunks_of(int k) { return (k + kDataChunk - 1) / kDataChunk; }

// The 64-column blocks of an n-column product that warpgroup wg owns.
__host__ __device__ inline int data_blocks(int n, int wg) {
  return ((n + kBox - 1) / kBox - wg + 1) / 2;
}

// A head's cotangent (B, n) f32: its rows of this tile (zero past the end
// of the batch) rounded to bf16 into shared memory and the scratch; each
// column's f32 sum into db, in a fixed order: four groups of 16 rows, each
// in order, then the groups in order (`part`: 4 x n f32 of shared memory).
// Called by the consumers; ends with their barrier.
template <typename Sync>
__device__ __forceinline__ void stage_cotangent(const float* __restrict__ g, int n,
                                                long long row0, int rows_valid, bf16* out_s,
                                                int ldo, bf16* out_g, float* db, float* part,
                                                Sync consumers_sync) {
  constexpr int kGroups = 4, kPer = kRows / kGroups;
  for (int idx = threadIdx.x; idx < kGroups * n; idx += kDataConsumers) {
    const int grp = idx / n, c = idx - grp * n;
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kPer; ++i) {
      const int r = grp * kPer + i;
      const float val = r < rows_valid ? g[(row0 + r) * n + c] : 0.f;
      s += val;
      const bf16 b = __float2bfloat16(val);
      out_s[r * ldo + c] = b;
      out_g[(size_t)r * n + c] = b;
    }
    part[grp * n + c] = s;
  }
  consumers_sync();
  for (int c = threadIdx.x; c < n; c += kDataConsumers)
    db[c] = ((part[c] + part[n + c]) + part[2 * n + c]) + part[3 * n + c];
}

// A member's scratch; `member_bytes` apart from the next member's.
struct Scratch {
  bf16 *g, *gf, *gv, *ga, *gr;
  float* db_part;
  long long member_bytes;

  __device__ Scratch member(int m) const {
    const long long off = m * member_bytes;
    auto at = [off](auto* p) { return reinterpret_cast<decltype(p)>(
                                   reinterpret_cast<unsigned char*>(p) + off); };
    return Scratch{at(g), at(gf), at(gv), at(ga), at(gr), at(db_part), member_bytes};
  }
};

// The saved activations the data pass reads: the relu masks, a member's;
// `member_bytes` apart from the next member's.
struct SavedActs {
  const bf16 *h, *hv;
  long long rows_pad, member_bytes;

  __device__ SavedActs member(int m) const {
    const long long off = m * member_bytes;
    auto at = [off](const bf16* p) { return reinterpret_cast<const bf16*>(
                                         reinterpret_cast<const unsigned char*>(p) + off); };
    return SavedActs{at(h), at(hv), rows_pad, member_bytes};
  }
};

// The producer warp's lane 0: the whole stream of B chunks, in the order
// the consumers take them, each chunk into both warpgroups' rings (a
// warpgroup's share of a pass: its 64-column blocks).  `stages` holds the
// two rings one after the other, full and empty their barriers likewise.
__device__ __forceinline__ void data_produce(const DataParams& P, unsigned char* stages,
                                             uint64_t* full, uint64_t* empty) {
  const int member = blockIdx.y;
  int c = 0;
  for (int i = 0; i < P.n_ops; ++i) {
    const DOp& o = P.op[i];
    for (int kc = 0; kc < chunks_of(o.k); ++kc, ++c) {
      const int st = c % kDataStages;
      for (int wg = 0; wg < 2; ++wg) {
        const int bar = wg * kDataStages + st;
        if (c >= kDataStages) mbar_wait(&empty[bar], (c / kDataStages - 1) & 1);
        const int nb = data_blocks(o.n, wg);
        mbar_expect_tx(&full[bar], nb * kDataBoxBytes);
        for (int b = 0; b < nb; ++b)
          tma_load(stages + bar * kDataStageBytes + b * kDataBoxBytes, &P.map[o.map],
                   o.col0 + (wg + 2 * b) * kBox, o.row0 + kc * kDataChunk, member, &full[bar]);
      }
    }
  }
}

// One consumer warpgroup's share of the data pass: its accumulators, its
// products, its epilogues.
struct DataWarpgroup {
  const DataParams& P;
  unsigned char* stages;  // this warpgroup's kDataStages stages
  uint64_t* full;         // and their barriers
  uint64_t* empty;
  float* red;             // its four warps' column partials, two sets
  int wg, warp, lane;
  int chunk = 0, op = 0, pass = 0;  // chunks, operands and passes consumed
  float acc[kDataBlocks][32];

  __device__ DataWarpgroup(const DataParams& p, unsigned char* st, uint64_t* f, uint64_t* e,
                           float* r)
      : P(p), stages(st), full(f), empty(e), red(r) {
    wg = threadIdx.x / 128;
    warp = (threadIdx.x / 32) & 3;
    lane = threadIdx.x & 31;
  }

  __device__ __forceinline__ void named_sync() const {
    asm volatile("bar.sync %0, 128;\n" ::"r"(1 + wg) : "memory");
  }

  __device__ __forceinline__ void zero() {
#pragma unroll
    for (int b = 0; b < kDataBlocks; ++b)
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[b][e] = 0.f;
  }

  __device__ __forceinline__ void fence_all() {
#pragma unroll
    for (int b = 0; b < kDataBlocks; ++b) fence_acc<64>(acc[b]);
  }

  // This warp is done with a stage: its arrival on the stage's empty
  // barrier (the producer refills it once all four warps have arrived).
  __device__ __forceinline__ void release(int st) {
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  }

  // One chunk of a product: wait for its B stage, its A fragments (rows of
  // this warp, columns kc * kDataChunk ..) from shared memory by ldmatrix
  // into `frag`, its wgmma group issued; then wait for the previous chunk's
  // group (one stays in flight) and release that chunk's stage.
  __device__ __forceinline__ void chunk_step(uint32_t (&frag)[kDataChunk / 16][4],
                                             uint32_t a_row, int kc, int k, int nb,
                                             int& pending) {
    const int st = chunk % kDataStages;
    const int ksteps = min(kDataChunk, k - kc * kDataChunk) / 16;  // a tail of 16 rows
    mbar_wait(&full[st], (chunk / kDataStages) & 1);
#pragma unroll
    for (int ks = 0; ks < kDataChunk / 16; ++ks)
      if (ks < ksteps)
        asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
                     : "=r"(frag[ks][0]), "=r"(frag[ks][1]), "=r"(frag[ks][2]),
                       "=r"(frag[ks][3])
                     : "r"(a_row + (kc * kDataChunk + ks * 16) * 2));
    const uint32_t b0 = smem_u32(stages + st * kDataStageBytes);
    asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
    for (int ks = 0; ks < kDataChunk / 16; ++ks)  // 16 rows of a box = 2048 bytes
#pragma unroll
      for (int b = 0; b < kDataBlocks; ++b)
        if (ks < ksteps && b < nb)
          wgmma_m64n64k16_rt(acc[b], frag[ks],
                             wgmma_desc(b0 + b * kDataBoxBytes + ks * 2048, kDataBoxBytes));
    asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    if (pending >= 0) release(pending);
    pending = st;
    ++chunk;
  }

  // acc += A (kRows x k, bf16 in shared memory, leading dimension lda) B,
  // the next operand of the stream.  The A fragments alternate between two
  // register sets, so that a chunk's loads never touch the registers of the
  // group still in flight.
  __device__ __forceinline__ void product(const bf16* a, int lda) {
    const DOp& o = P.op[op++];
    const int nb = data_blocks(o.n, wg);
    const int n_kc = chunks_of(o.k);
    const uint32_t a_row = smem_u32(a + (warp * 16 + (lane & 15)) * lda + (lane >> 4) * 8);
    uint32_t f0[kDataChunk / 16][4], f1[kDataChunk / 16][4];
    int pending = -1;
    fence_all();
    for (int kc = 0; kc < n_kc; kc += 2) {
      chunk_step(f0, a_row, kc, o.k, nb, pending);
      if (kc + 1 < n_kc) chunk_step(f1, a_row, kc + 1, o.k, nb, pending);
    }
    asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
    fence_all();
    release(pending);
  }

  // A pass's epilogue on this warpgroup's blocks of columns [col0, col0 +
  // kDataPass) of an n-column step: times the relu mask of `mask` (the
  // layer's saved bf16 output, this tile's rows, leading dimension n; none
  // for the feature layer), rounded to bf16 into `out` (leading dimension
  // ldo); each column's 64 f32 values summed in a fixed order (per thread
  // its two rows, a butterfly over the warp's 16 rows, then the four warps
  // in order) into db.
  __device__ __forceinline__ void epilogue(int col0, int n, const bf16* mask, bf16* out,
                                           int ldo, float* db) {
    const int nb = data_blocks(min(kDataPass, n - col0), wg);
    float* part = red + (pass++ & 1) * 4 * kDataBlocks * kBox;  // [warp][block][64]
#pragma unroll
    for (int b = 0; b < kDataBlocks; ++b) {
      if (b >= nb) continue;
      const int c0 = col0 + (wg + 2 * b) * kBox;
      // the block's relu masks first, all loads in flight together (the
      // lines are in L2 already: prefetch_mask)
      __nv_bfloat162 m[8][2];
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = warp * 16 + (lane >> 2) + 8 * h;
          const int col = c0 + 8 * j + 2 * (lane & 3);
          m[j][h] = __floats2bfloat162_rn(1.f, 1.f);
          if (mask != nullptr && col < n)
            m[j][h] = *reinterpret_cast<const __nv_bfloat162*>(mask + (size_t)row * n + col);
        }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = c0 + 8 * j + 2 * (lane & 3);
        float s0 = 0.f, s1 = 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int row = warp * 16 + (lane >> 2) + 8 * h;
          float v0 = acc[b][4 * j + 2 * h], v1 = acc[b][4 * j + 2 * h + 1];
          if (col < n) {
            const float2 mf = __bfloat1622float2(m[j][h]);
            v0 *= mf.x > 0.f ? 1.f : 0.f;
            v1 *= mf.y > 0.f ? 1.f : 0.f;
            *reinterpret_cast<__nv_bfloat162*>(out + row * ldo + col) =
                __floats2bfloat162_rn(v0, v1);
          } else {
            v0 = v1 = 0.f;
          }
          s0 += v0;
          s1 += v1;
        }
#pragma unroll
        for (int off = 4; off < 32; off <<= 1) {
          s0 += __shfl_xor_sync(0xffffffffu, s0, off);
          s1 += __shfl_xor_sync(0xffffffffu, s1, off);
        }
        if (lane < 4) {
          part[(warp * kDataBlocks + b) * kBox + 8 * j + 2 * lane] = s0;
          part[(warp * kDataBlocks + b) * kBox + 8 * j + 2 * lane + 1] = s1;
        }
      }
    }
    named_sync();  // (the other set is free: every warp passed the last pass's sync)
    const int t = threadIdx.x & 127, b = t / kBox, c = col0 + (wg + 2 * b) * kBox + t % kBox;
    if (b < nb && c < n) {
      const int at = b * kBox + t % kBox, stride = kDataBlocks * kBox;
      db[c] = ((part[at] + part[stride + at]) + part[2 * stride + at]) + part[3 * stride + at];
    }
  }

  // The pass's relu masks, 64 rows x kDataPass columns from col0, fetched
  // into L2 while its products run: one 128-byte line a thread.
  __device__ __forceinline__ void prefetch_mask(const bf16* mask, int col0, int n) const {
    if (mask == nullptr) return;
    const int t = threadIdx.x & 127;
    const int c = col0 + wg * 128 + t % 2 * 64;
    const int row = t / 2;
    if (c < n)
      asm volatile("prefetch.global.L2 [%0];\n" ::"l"(mask + (size_t)row * n + c));
  }
};

// Grid (CTAs, members): B rows a member, g_ha and g_hr the members' rows
// one after another.
__global__ void __launch_bounds__(kDataThreads, 1)
trunk_bwd_data(const __grid_constant__ DataParams P, const float* __restrict__ g_ha,
               const float* __restrict__ g_hr, int B, SavedActs A_all, Scratch S_all,
               const __grid_constant__ Layout L, int depth, int width, int ha, int hr) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int half = width / 2;
  const DataSmem M(width, ha);
  const int ldh = M.ldh;
  bf16* buf0 = reinterpret_cast<bf16*>(smem);
  bf16* buf1 = reinterpret_cast<bf16*>(smem + M.off_buf1);
  bf16* gas = reinterpret_cast<bf16*>(smem + M.off_ga);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + M.off_bar);
  uint64_t* empty = full + 2 * kDataStages;
  unsigned char* stages = smem + M.off_stage;
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2 * kDataStages; ++i) {
      mbar_init(&full[i], 1);
      mbar_init(&empty[i], 4);  // the warpgroup's four warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= kDataConsumers) {  // the producer warp
    if (threadIdx.x == kDataConsumers) data_produce(P, stages, full, empty);
    return;
  }
  // from here on only the consumers: they meet at named barrier 3
  auto consumers_sync = [] { asm volatile("bar.sync 3, %0;\n" ::"n"(kDataConsumers) : "memory"); };
  const int wg = threadIdx.x / 128;
  DataWarpgroup G(P, stages + wg * kDataStages * kDataStageBytes, full + wg * kDataStages,
                  empty + wg * kDataStages,
                  reinterpret_cast<float*>(smem + M.off_red) + wg * 2 * 4 * kDataBlocks * kBox);

  const long long row0 = (long long)blockIdx.x * kRows;
  const int rows_valid = (int)min((long long)kRows, (long long)B - row0);
  // this CTA's member: its saved activations, scratch and cotangent rows
  const SavedActs A = A_all.member(blockIdx.y);
  const Scratch S = S_all.member(blockIdx.y);
  g_ha += (long long)blockIdx.y * B * ha;
  g_hr += (long long)blockIdx.y * B * hr;
  const long long R = A.rows_pad;
  auto act = [&](bf16* base, int cols) { return base + row0 * cols; };  // this tile's rows
  auto layer_h = [&](int i) { return A.h + (long long)i * R * width + row0 * width; };
  auto layer_g = [&](int i) { return S.g + (long long)i * R * width + row0 * width; };
  float* db = S.db_part + (long long)blockIdx.x * L.b_total;

  // One step: out = (A0 B0 [+ A1 B1]) [mask > 0], n columns, pass by
  // pass; once a barrier has completed it, its copy to the scratch.
  auto step = [&](int n, const bf16* a0, int lda0, const bf16* a1, int lda1, const bf16* mask,
                  bf16* out, bf16* out_g, float* db_step) {
    for (int col0 = 0; col0 < n; col0 += kDataPass) {
      G.prefetch_mask(mask, col0, n);
      G.zero();
      G.product(a0, lda0);
      if (a1 != nullptr) G.product(a1, lda1);
      G.epilogue(col0, n, mask, out, ldh, db_step);
    }
    consumers_sync();
    copy_out(out, ldh, out_g, n, kDataConsumers);
  };

  // heads, views, feature, then the layers in reverse
  float* part = reinterpret_cast<float*>(smem + M.off_red);  // free until the first epilogue
  stage_cotangent(g_hr, hr, row0, rows_valid, buf0, ldh, act(S.gr, hr), db + L.bhr, part,
                  consumers_sync);
  consumers_sync();  // part is reused
  stage_cotangent(g_ha, ha, row0, rows_valid, gas, M.ldga, act(S.ga, ha), db + L.bha, part,
                  consumers_sync);
  consumers_sync();
  // g_hv = (g_hr Whr) [hv > 0]
  step(half, buf0, ldh, nullptr, 0, A.hv + row0 * half, buf1, act(S.gv, half), db + L.bv);
  // g_f = g_hv Wvf (the feature layer is linear)
  step(width, buf1, ldh, nullptr, 0, nullptr, buf0, act(S.gf, width), db + L.bf);
  // g_{D-1} = (g_f Wf + g_ha Wha) [h_{D-1} > 0]
  step(width, buf0, ldh, gas, M.ldga, layer_h(depth - 1), buf1, layer_g(depth - 1),
       db + L.b[depth - 1]);
  bf16* cur = buf1;
  bf16* nxt = buf0;
  for (int i = depth - 1; i >= 1; --i) {
    // g_{i-1} = (g_i W_i) [h_{i-1} > 0]; W_i is wsh at the skip layer (x
    // gets no gradient)
    step(width, cur, ldh, nullptr, 0, layer_h(i - 1), nxt, layer_g(i - 1), db + L.b[i - 1]);
    bf16* t = cur;
    cur = nxt;
    nxt = t;
  }
}

// ---------------------------------------------------------------------------
// the weight-gradient pass
// ---------------------------------------------------------------------------

// dW (n_out x n_in) = G^T H: G (rows, n_out) bf16 in the scratch and H
// (rows, n_in) bf16 in the saved activations, both row-major, each read
// through a TMA tensor map (`map`, starting at row `*_row0` of it).
enum MapId { kMapGW, kMapGV, kMapGA, kMapGR, kMapHW, kMapX, kMapV, kMapHV, kMaps };

struct Job {
  long long out;  // dW's offset in the packed layout
  int g_map, g_row0, h_map, h_row0;
  int n_out, n_in, n_tile, tiles_in, first_tile;
};

struct alignas(64) WgradParams {
  CUtensorMap map[kMaps];
  Job job[kMaxJobs];
  int n_jobs, rows_pad, rows_per_split;
  long long w_total;
  float* dw_part;              // member 0's partials
  long long dw_member_floats;  // from one member's partials to the next's
};

// the dW tile's width for an n_in: the wgmma N that covers it, at most 256
__host__ __device__ inline int n_tile_for(int n_in) {
  return n_in <= 64 ? 64 : n_in <= 128 ? 128 : 256;
}

// A consumer warpgroup: its 64 dW rows x N columns over the CTA's chunks.
// Each chunk: wait for the stage's TMA copies, four wgmma k-steps of 16
// rows, wait for them, release the stage (one arrival per warp).  A
// warpgroup past the matrix's last row (`active` false) only keeps the
// pipeline's count.  Then its f32 partial: row w*16 + lane/4 (+8) and
// columns 8j + 2 (lane % 4) (+1) of the accumulator's j-th 8-column block,
// as wgmma lays D out.
template <int N>
__device__ __forceinline__ void wgrad_consume(const WgradParams& p, const Job& job,
                                              unsigned char* stages, uint64_t* full,
                                              uint64_t* empty, int n_chunks, int cw, bool active,
                                              int o0, int i0) {
  float acc[N / 2];
#pragma unroll
  for (int e = 0; e < N / 2; ++e) acc[e] = 0.f;
  const int lane = threadIdx.x & 31;
  for (int c = 0; c < n_chunks; ++c) {
    const int st = c % kWgradStages;
    mbar_wait(&full[st], (c / kWgradStages) & 1);
    if (active) {
      const uint32_t a0 = smem_u32(stages + st * kWgradStageBytes + cw * kBoxBytes);
      const uint32_t b0 = smem_u32(stages + st * kWgradStageBytes + kStageGBytes);
      fence_acc<N>(acc);
      asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
      for (int kk = 0; kk < kWgradChunk / 16; ++kk)  // 16 rows = 2048 bytes a k-step
        wgmma_tt<N>(acc, wgmma_desc(a0 + kk * 2048, kBoxBytes),
                    wgmma_desc(b0 + kk * 2048, kBoxBytes));
      asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
      asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
      fence_acc<N>(acc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[st]);
  }
  if (!active) return;
  const int warp = (threadIdx.x >> 5) & 3;
  const int split = blockIdx.y;
  float* out = p.dw_part + blockIdx.z * p.dw_member_floats + split * p.w_total + job.out;
#pragma unroll
  for (int j = 0; j < N / 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int o = o0 + cw * 64 + warp * 16 + (lane >> 2) + 8 * h;
      const int i = i0 + j * 8 + 2 * (lane & 3);
      if (o < job.n_out && i < job.n_in)
        *reinterpret_cast<float2*>(out + (long long)o * job.n_in + i) =
            make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
    }
}

// One CTA: a kWgradM x n_tile tile of one dW over one range of rows
// (blockIdx.y) of one member (blockIdx.z), into that range's partial.  Warpgroup 0 is the producer:
// one thread keeps up to kWgradStages chunks of G's and H's boxes in
// flight by TMA, each stage completing on its `full` barrier; warpgroups 1
// and 2 consume (wgrad_consume) and free a stage through its `empty`
// barrier.  Boxes wholly past the matrix's edge are not copied: the G box
// of a warpgroup with no rows there, and H boxes whose columns are all past
// n_in (their columns of the product are never written).
__global__ void __launch_bounds__(kWgradThreads, 1)
trunk_bwd_wgrad(const __grid_constant__ WgradParams p) {
  extern __shared__ unsigned char smem_raw[];
  unsigned char* stages = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(stages + kWgradStages * kWgradStageBytes);
  uint64_t* empty = full + kWgradStages;

  int j = 0;
  while (j + 1 < p.n_jobs && p.job[j + 1].first_tile <= (int)blockIdx.x) ++j;
  const Job& job = p.job[j];
  const int tile = blockIdx.x - job.first_tile;
  const int o0 = (tile / job.tiles_in) * kWgradM;
  const int i0 = (tile % job.tiles_in) * job.n_tile;
  const int r_begin = blockIdx.y * p.rows_per_split;
  const int r_end = min(p.rows_pad, r_begin + p.rows_per_split);
  const int n_chunks = max(0, (r_end - r_begin) / kWgradChunk);
  const int g_boxes = min(kWgradM / kBox, (job.n_out - o0 + kBox - 1) / kBox);
  const int h_boxes = min(job.n_tile / kBox, (job.n_in - i0 + kBox - 1) / kBox);

  if (threadIdx.x == 0) {
    for (int st = 0; st < kWgradStages; ++st) {
      mbar_init(&full[st], 1);
      mbar_init(&empty[st], 8);  // every consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n" ::: "memory");
    if (threadIdx.x == 0) {
      const int member = blockIdx.z;
      const uint32_t bytes = (g_boxes + h_boxes) * kBoxBytes;
      for (int c = 0; c < n_chunks; ++c) {
        const int st = c % kWgradStages;
        if (c >= kWgradStages) mbar_wait(&empty[st], (c / kWgradStages - 1) & 1);
        mbar_expect_tx(&full[st], bytes);
        const int r = r_begin + c * kWgradChunk;
        unsigned char* sg = stages + st * kWgradStageBytes;
        for (int b = 0; b < g_boxes; ++b)
          tma_load(sg + b * kBoxBytes, &p.map[job.g_map], o0 + b * kBox, job.g_row0 + r, member,
                   &full[st]);
        for (int b = 0; b < h_boxes; ++b)
          tma_load(sg + kStageGBytes + b * kBoxBytes, &p.map[job.h_map], i0 + b * kBox,
                   job.h_row0 + r, member, &full[st]);
      }
    }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n" ::: "memory");
    const int cw = wg - 1;
    const bool active = cw < g_boxes;
    if (job.n_tile == 256)
      wgrad_consume<256>(p, job, stages, full, empty, n_chunks, cw, active, o0, i0);
    else if (job.n_tile == 128)
      wgrad_consume<128>(p, job, stages, full, empty, n_chunks, cw, active, o0, i0);
    else
      wgrad_consume<64>(p, job, stages, full, empty, n_chunks, cw, active, o0, i0);
  }
}

// dW = the row ranges' partials added in order, member by member (a
// member's partials `member_floats` apart, its dW w_total).
__global__ void trunk_bwd_reduce_dw(const float* __restrict__ part, int splits,
                                    long long w_total, long long member_floats, int members,
                                    float* __restrict__ dw) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < members * w_total;
       i += (long long)gridDim.x * blockDim.x) {
    const long long m = i / w_total, e = i - m * w_total;
    const float* q = part + m * member_floats;
    float s = 0.f;
    for (int k = 0; k < splits; ++k) s += q[k * w_total + e];
    dw[i] = s;
  }
}

// db = the CTAs' partials added in a fixed order: lane = column, warp k
// adds CTAs k, k + 8, ..., then the 8 warps' sums in order; member
// blockIdx.y's partials `member_floats` after member 0's.
__global__ void __launch_bounds__(256)
trunk_bwd_reduce_db(const float* __restrict__ part, int n_ctas, int b_total,
                    long long member_floats, float* __restrict__ db) {
  __shared__ float sums[8][32];
  part += blockIdx.y * member_floats;
  db += (long long)blockIdx.y * b_total;
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


// A tensor map of `members` (rows, cols) row-major bf16 matrices,
// member_bytes apart, read in boxes of box_rows rows x kBox columns with the
// 128-byte swizzle; elements past the edge read as zero.
bool encode_map(CUtensorMap* map, const void* base, int members, long long member_bytes,
                long long rows, int cols, int box_rows = kWgradChunk) {
  return encode_members(map, base, members, member_bytes, rows, cols, kBox, box_rows);
}

// The data pass's parameters: tensor maps of the weights it multiplies
// (every W-wide matrix from w1 through wvf as one (rows, W) matrix, and
// whr) and its operands in order.  false if a tensor map cannot be made.
bool make_data(DataParams& p, const Layout& L, const bf16* w, int members, int depth, int width,
               int ha, int hr) {
  const int half = width / 2;
  const long long base = L.w[1], wb = L.w_total * 2;
  if (!encode_map(&p.map[kDMapW], w + base, members, wb, (L.wvv - base) / width, width,
                  kDataChunk) ||
      !encode_map(&p.map[kDMapHr], w + L.whr, members, wb, hr, half, kDataChunk)) {
    return false;
  }
  auto row = [&](long long off) { return (int)((off - base) / width); };
  // a step's operands, pass by pass, in the order the kernel's steps take them
  p.n_ops = 0;
  auto step = [&](int n, DOp b0, DOp b1) {
    for (int col0 = 0; col0 < n; col0 += kDataPass) {
      const int cols = std::min(kDataPass, n - col0);
      p.op[p.n_ops++] = DOp{b0.map, b0.row0, b0.k, col0, cols};
      if (b1.k > 0) p.op[p.n_ops++] = DOp{b1.map, b1.row0, b1.k, col0, cols};
    }
  };
  const DOp none{0, 0, 0, 0, 0};
  step(half, DOp{kDMapHr, 0, hr, 0, 0}, none);
  step(width, DOp{kDMapW, row(L.wvf), half, 0, 0}, none);
  step(width, DOp{kDMapW, row(L.wf), width, 0, 0}, DOp{kDMapW, row(L.wha), ha, 0, 0});
  for (int i = depth - 1; i >= 1; --i) step(width, DOp{kDMapW, row(L.w[i]), width, 0, 0}, none);
  p.n_chunks = 0;
  for (int i = 0; i < p.n_ops; ++i) p.n_chunks += chunks_of(p.op[i].k);
  return true;
}

int tiles_of(int n_out, int n_in) {
  return ((n_out + kWgradM - 1) / kWgradM) * ((n_in + n_tile_for(n_in) - 1) / n_tile_for(n_in));
}

// Appends the job dW = G^T H (G: rows from g_row0 of map g_map, H: from
// h_row0 of h_map) after the tiles already counted; returns the tiles.
int add_job(WgradParams& p, int tiles, int g_map, long long g_row0, int h_map,
            long long h_row0, long long out, int n_out, int n_in) {
  Job& j = p.job[p.n_jobs++];
  j.out = out;
  j.g_map = g_map;
  j.g_row0 = (int)g_row0;
  j.h_map = h_map;
  j.h_row0 = (int)h_row0;
  j.n_out = n_out;
  j.n_in = n_in;
  j.n_tile = n_tile_for(n_in);
  j.tiles_in = (n_in + j.n_tile - 1) / j.n_tile;
  j.first_tile = tiles;
  return tiles + tiles_of(n_out, n_in);
}

// The weight-gradient pass's parameters: the tensor maps of every G (in
// the scratch) and H (in the saved activations), and every matrix's job.
// Returns the tiles, or -1 if a tensor map cannot be made.
int make_wgrad(WgradParams& p, const Layout& L, const Plan& P, const ActPlan& A,
               unsigned char* ws, const unsigned char* acts, int members, int depth, int width,
               int in_pad, int v_pad, int ha, int hr) {
  const long long R = P.rows_pad;
  const int skip = depth / 2, half = width / 2;
  const int n = members;
  const bool ok = encode_map(&p.map[kMapGW], ws + P.g, n, P.bytes, (depth + 1) * R, width) &&
                  encode_map(&p.map[kMapGV], ws + P.gv, n, P.bytes, R, half) &&
                  encode_map(&p.map[kMapGA], ws + P.ga, n, P.bytes, R, ha) &&
                  encode_map(&p.map[kMapGR], ws + P.gr, n, P.bytes, R, hr) &&
                  encode_map(&p.map[kMapHW], acts + A.h, n, A.bytes, (depth + 1) * R, width) &&
                  encode_map(&p.map[kMapX], acts + A.x, n, A.bytes, R, in_pad) &&
                  encode_map(&p.map[kMapV], acts + A.v, n, A.bytes, R, v_pad) &&
                  encode_map(&p.map[kMapHV], acts + A.hv, n, A.bytes, R, half);
  if (!ok) return -1;
  p.n_jobs = 0;
  int t = add_job(p, 0, kMapGW, 0, kMapX, 0, L.w[0], width, in_pad);
  for (int i = 1; i < depth; ++i) {
    if (i == skip + 1) t = add_job(p, t, kMapGW, i * R, kMapX, 0, L.wsx, width, in_pad);
    t = add_job(p, t, kMapGW, i * R, kMapHW, (i - 1) * R, L.w[i], width, width);
  }
  t = add_job(p, t, kMapGA, 0, kMapHW, (depth - 1) * R, L.wha, ha, width);
  t = add_job(p, t, kMapGW, depth * R, kMapHW, (depth - 1) * R, L.wf, width, width);
  t = add_job(p, t, kMapGV, 0, kMapHW, depth * R, L.wvf, half, width);
  t = add_job(p, t, kMapGV, 0, kMapV, 0, L.wvv, half, v_pad);
  t = add_job(p, t, kMapGR, 0, kMapHV, 0, L.whr, hr, half);
  p.rows_pad = P.rows_pad;
  p.rows_per_split = P.rows_per_split;
  p.w_total = L.w_total;
  p.dw_part = reinterpret_cast<float*>(ws + P.dw_part);
  p.dw_member_floats = P.bytes / 4;
  return t;
}

int count_tiles(int depth, int width, int in_pad, int v_pad, int ha, int hr) {
  const int half = width / 2;
  return tiles_of(width, in_pad) * 2 + (depth - 1) * tiles_of(width, width) +
         tiles_of(ha, width) + tiles_of(width, width) + tiles_of(half, width) +
         tiles_of(half, v_pad) + tiles_of(hr, half);
}

// Also a runtime call that makes the device's context current on the
// calling thread, as cuTensorMapEncodeTiled needs: call it before encoding.
cudaError_t wgrad_attribute() {
  return cudaFuncSetAttribute(trunk_bwd_wgrad, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              kWgradSmem);
}

cudaError_t launch_wgrad(const WgradParams& p, int tiles, int splits, int members,
                         cudaStream_t s) {
  trunk_bwd_wgrad<<<dim3(tiles, splits, members), kWgradThreads, kWgradSmem, s>>>(p);
  return cudaGetLastError();
}

Plan plan_for(int B, int depth, int width, int input_ch, int views_ch, int ha, int hr) {
  const int in_pad = round16(input_ch), v_pad = round16(views_ch);
  const Layout L(depth, width, in_pad, v_pad, ha, hr);
  return Plan(B, depth, width, ha, hr, count_tiles(depth, width, in_pad, v_pad, ha, hr),
              L.w_total, L.b_total);
}

}  // namespace

// The bytes of scratch trunk_bwd needs for B rows of this trunk (beside the
// forward's saved activations), a member's; -1 for a shape it does not take.
extern "C" long long trunk_bwd_workspace(int B, int depth, int width, int input_ch,
                                         int views_ch, int ha, int hr) {
  if (!shape_ok(B, depth, width, input_ch, views_ch, ha, hr)) return -1;
  return plan_for(B, depth, width, input_ch, views_ch, ha, hr).bytes;
}

// C entry point (bound with ctypes).  `members` trunks of B rows each (1:
// one trunk).  acts: the activations trunk.cu's trunk_fwd_save wrote for
// these rows (members x its trunk_fwd_workspace's bytes, a member's ActPlan
// block after another), read only; w: device bf16 weights, as trunk.cu
// reads them, the members' copies back to back; g_ha (members x B, ha),
// g_hr (members x B, hr): device f32 cotangents, contiguous; dw, db: device
// f32 outputs laid out as the weights and the biases, a member's after
// another; workspace: device memory of members x trunk_bwd_workspace's
// bytes.  The caller checks shapes and types; this checks what the kernels'
// layout needs.  Launches the four kernels on `stream` and returns the first
// CUDA error (0 on success); it never synchronises.
extern "C" int trunk_bwd(const void* acts, long long acts_bytes, const void* w,
                         const float* g_ha, const float* g_hr, float* dw, float* db,
                         void* workspace, long long workspace_bytes, int B, int depth,
                         int width, int input_ch, int views_ch, int ha, int hr, int members,
                         void* stream) {
  if (!shape_ok(B, depth, width, input_ch, views_ch, ha, hr) || members < 1)
    return (int)cudaErrorInvalidValue;
  const int in_pad = round16(input_ch), v_pad = round16(views_ch);
  const DataSmem M(width, ha);
  const Plan P = plan_for(B, depth, width, input_ch, views_ch, ha, hr);
  const ActPlan A(B, depth, width, in_pad, v_pad);
  if (M.bytes > kMaxSmem || workspace_bytes < members * P.bytes ||
      acts_bytes < members * A.bytes) {
    return (int)cudaErrorInvalidValue;
  }
  const Layout L(depth, width, in_pad, v_pad, ha, hr);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (B == 0) {
    cudaError_t e = cudaMemsetAsync(dw, 0, members * L.w_total * sizeof(float), s);
    if (e == cudaSuccess) e = cudaMemsetAsync(db, 0, members * L.b_total * sizeof(float), s);
    return (int)e;
  }
  unsigned char* ws = static_cast<unsigned char*>(workspace);
  const unsigned char* ab = static_cast<const unsigned char*>(acts);
  auto at = [ws](long long off) { return reinterpret_cast<bf16*>(ws + off); };
  const Scratch S{at(P.g), at(P.gf), at(P.gv), at(P.ga), at(P.gr),
                  reinterpret_cast<float*>(ws + P.db_part), P.bytes};
  const SavedActs SA{reinterpret_cast<const bf16*>(ab + A.h),
                     reinterpret_cast<const bf16*>(ab + A.hv), A.rows_pad, A.bytes};

  // runtime calls first: they make the device's context current on this
  // thread (autograd runs the backward on a thread of its own), which the
  // driver's cuTensorMapEncodeTiled needs
  cudaError_t e = cudaFuncSetAttribute(trunk_bwd_data,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, M.bytes);
  if (e == cudaSuccess) e = wgrad_attribute();
  if (e != cudaSuccess) return (int)e;
  DataParams dp;
  if (!make_data(dp, L, static_cast<const bf16*>(w), members, depth, width, ha, hr)) {
    return (int)cudaErrorInvalidValue;
  }
  trunk_bwd_data<<<dim3(P.n_ctas, members), kDataThreads, M.bytes, s>>>(
      dp, g_ha, g_hr, B, SA, S, L, depth, width, ha, hr);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;

  WgradParams wp;
  const int tiles =
      make_wgrad(wp, L, P, A, ws, ab, members, depth, width, in_pad, v_pad, ha, hr);
  if (tiles < 0) return (int)cudaErrorInvalidValue;
  if ((e = launch_wgrad(wp, tiles, P.splits, members, s)) != cudaSuccess) return (int)e;

  trunk_bwd_reduce_dw<<<1024, 256, 0, s>>>(wp.dw_part, P.splits, L.w_total, P.bytes / 4,
                                           members, dw);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  trunk_bwd_reduce_db<<<dim3((L.b_total + 31) / 32, members), 256, 0, s>>>(
      reinterpret_cast<const float*>(ws + P.db_part), P.n_ctas, L.b_total, P.bytes / 4, db);
  return (int)cudaGetLastError();
}

// The weight-gradient pass alone on one matrix, for checking it: dw
// (n_out x n_in, f32) = G^T H with G (rows, n_out) and H (rows, n_in)
// device bf16, row-major; rows a multiple of 64, n_out and n_in multiples
// of 16 (at most 512 and 256 x tiles, as the trunk's); one row range.
extern "C" int trunk_bwd_wgrad_one(const void* g, const void* h, int rows, int n_out, int n_in,
                                   float* dw, void* stream) {
  if (rows < 0 || rows % kWgradChunk != 0 || n_out < 16 || n_out % 16 != 0 || n_in < 16 ||
      n_in % 16 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaError_t e = wgrad_attribute();
  if (e != cudaSuccess) return (int)e;
  WgradParams wp{};
  if (!encode_map(&wp.map[kMapGW], g, 1, (long long)rows * n_out * 2, rows, n_out) ||
      !encode_map(&wp.map[kMapHW], h, 1, (long long)rows * n_in * 2, rows, n_in)) {
    return (int)cudaErrorInvalidValue;
  }
  const int tiles = add_job(wp, 0, kMapGW, 0, kMapHW, 0, 0, n_out, n_in);
  wp.rows_pad = rows;
  wp.rows_per_split = rows;
  wp.w_total = (long long)n_out * n_in;
  wp.dw_part = dw;
  wp.dw_member_floats = 0;
  return (int)launch_wgrad(wp, tiles, 1, 1, static_cast<cudaStream_t>(stream));
}
