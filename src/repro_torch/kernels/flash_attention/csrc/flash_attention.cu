// Flash attention forward on Hopper (sm_90a): causal and/or sliding-window
// GQA attention with an online softmax. Two kernels, one function:
// fa_bf16_kernel takes bf16 inputs (tensor cores fed by TMA), fa_kernel
// takes f32 inputs (tensor cores, error-compensated to f32 accuracy).
//
// Both replace the Pallas TPU kernel
// src/repro/kernels/flash_attention/kernel.py:33 (_fa_kernel, launched by
// flash_attention_fwd). Same function:
//
//   s = q . k^T * scale in f32; entries outside the mask (causal: key >
//   query; window: query - key >= window) are set to -1e30; the softmax
//   over keys is taken online, block by block (m, l, acc in f32), and the
//   output is acc / max(l, 1e-30), cast to q's type.
//
// q and k have head dim D, v and the output Dv: the pairs (D, Dv) the
// repo's models give the kernel, (32, 32), (64, 64), (128, 128), (256, 256)
// (gemma-2b) and (96, 64) (minicpm3-4b's MLA: q and k nope 64 + rope 32, v
// 64), each instantiated by FA_PAIRS below. Head h reads KV head h / (Hq /
// KVH): GQA is an index, KV is never repeated in memory. Both kernels visit
// only the KV tiles that hold a key some row of the query tile may see
// (below the diagonal when causal, inside the band with a window); the
// Pallas kernel streams every tile and masks. Masked scores are -1e30,
// never -inf: a row whose first visited tile is wholly masked sums exp(0)
// = 1 over garbage there, and the first tile that holds a real key wipes it
// with alpha = exp(-1e30 - m) = 0, as the Pallas kernel does. A window
// below 1 masks the diagonal too, so a row may see no key at all: then
// every tile is visited and the row averages all S values uniformly, as
// the Pallas kernel's row of -1e30 scores does. Keys past S (the ragged
// last tile, read as zero) score -inf, so they weigh 0 even in such a row;
// queries past S are not written.
//
// ---- fa_bf16_kernel, the bf16 path.
//
// Bound: operations, 2 (D + Dv) flops per unmasked (query, key) pair over
// the 989 TFLOP/s of the bf16 tensor cores. At yi-6b's attention (B 1, Hq
// 32, KV 4, S 4096, D 128, causal) that is 137.5 GFLOP, 0.139 ms, against
// 0.014 ms for its 46 MB of q, k, v and o; at hymba-1.5b's prefill (B 2,
// Hq 25, KV 5, S 4096, D 64, window 2048) 80.5 GFLOP, 0.081 ms, against
// 0.019 ms. Beside it each pair pays one exp2 on the special function
// units (16 a clock a SM: 3.87e12/s), 80% of the tensor term at (96, 64)
// (D + Dv 160: 320 flops an exp2) and 25% at (256, 256). (The f32 design
// below takes three TF32 products, each at half that rate, for each
// product.) What this design does about it:
//   * Both products are wgmma (bf16 x bf16 -> f32, m64nNk16). A block is
//     128 query rows and three warpgroups: one producer, two consumers of
//     64 rows each. S = Q.K^T is m64n128 over a 128-key tile (m64n80 over
//     80 keys at D 256) with Q and K read from shared memory. P is rounded
//     to bf16 in registers: the f32 accumulator's fragment is, pair by
//     pair, the A fragment of the next wgmma, so P never touches shared
//     memory. O += P.V reads V in its natural keys x Dv layout through the
//     transpose bit (MN-major B); at Dv 256 as two m64n128 products.
//   * The scale multiplies the f32 scores after the product (q is never
//     rounded as q * scale); log2(e) is folded into it and exp2f used.
//   * One producer thread keeps K and V tiles coming by TMA
//     (cp.async.bulk.tensor) into a ring of as many stages as fit, at most
//     4: 4 at D 32, 64 and (96, 64), 3 at D 128, 2 at D 256. Each stage
//     has a "full" mbarrier (transaction bytes) and an "empty" one (one
//     arrival per consumer warp). Tile j + 1 is in flight while tile j's
//     products run. setmaxnreg gives the producer 40 registers and the
//     consumers 232.
//   * Inside a consumer, tile j's softmax runs while the tensor cores do
//     P.V of tile j - 1 (issued together with S of tile j), so a tile's
//     stage is released one tile later: hence 3 stages at D 128, where 2
//     would expose each load.
//   * D 256 (gemma-2b), where only 2 stages fit beside the 64 KB Q tile,
//     has a plan of its own (Plan::kSplit):
//     - K and V on rings of their own, each stage with its own full and
//       empty barrier, the producer loading K of tile j + 1 before V of
//       tile j. The consumers free K's stage of tile j and V's of tile
//       j - 1 once P.V of tile j - 1 is in, so K of tile j + 1 loads while
//       tile j computes and V of tile j while S of tile j + 1 does; on one
//       ring of 2 (K and V together) tile j + 1's stage was freed just
//       when it was needed.
//     - 80-key tiles: Q 64 KB and two stages of K and V at 40 KB a tile.
//       O is 128 registers a consumer thread, S 40, P 20. S's SS wgmma
//       (m64n80k16) reads 4.5 KB of shared memory for 40 tensor clocks,
//       115 of the 128 bytes a clock shared memory gives.
//     - The two consumers take turns to issue their products (named
//       barriers kTurnBar + consumer: bar.sync takes the turn, bar.arrive
//       hands it on), so one's softmax runs while the other's products do.
//     - L2 -> SM: each block reads the K and V tiles up to its diagonal,
//       562 MB a call at gemma-2b's shape (B 1, Hq 8, KV 1, S 4096). Packing
//       its 8 query heads into a block's rows would not cut that (the bytes
//       a flop follow the rows a block holds, 128 either way); a TMA
//       multicast across a cluster of one KV head's blocks would, and is
//       not taken.
//   * The tensor maps are 3-D (width, S, B * heads): a ragged last tile
//     is zero-filled at S, never read from the next head. Rows of 128
//     bytes (64 columns) use the 128-byte swizzle, D 32's 64-byte rows the
//     64-byte one, in both the map and the wgmma descriptor; wider rows
//     are loaded as several 64-column boxes; tiles are 1024-byte aligned.
//     D 96 (192-byte rows, which no one swizzled box covers) is loaded as
//     two boxes at columns 0 and 64: TMA fills the 32 columns past the
//     tensor's edge with zeros, and Q.K^T takes only the 6 k-steps of 16
//     columns that hold data, so the padding costs shared memory and no
//     products.
//   * The online softmax stays in registers: a row lives in the 4 threads
//     of a quad (two shuffles), each thread keeps a partial row sum, and
//     the quad adds them once at the end.
//   * Query tiles launch heaviest first (the last tile of every head in
//     the first wave), so the causal tail does not idle the last wave.
//   Shared memory (Q, the ring, barriers, 1 KB to align): 74,824 B at D
//   32, 148,552 at D 64, 230,456 at D 128, 230,472 at D 256 (two rings),
//   230,472 at (96, 64). One block (384 threads) a SM.
//
// ---- fa_kernel, the f32 path.
//
// f32 inputs must meet 3e-5, which one TF32 product (10 mantissa bits)
// does not. Both products run on the tensor cores all the same, error-
// compensated (3xTF32): each f32 operand x is split into hi = tf32(x) and
// lo = tf32(x - hi), both rounded to nearest with ties away as cvt.rna
// rounds (hopper::to_tf32), and a product a.b is taken as hi_a.hi_b +
// hi_a.lo_b + lo_a.hi_b with f32 accumulation; lo_a.lo_b (2^-22 of a.b)
// is dropped. So the f32 bound is operations: 2 (D + Dv) flops per
// unmasked pair, three TF32 products each, over the 495 TFLOP/s of the
// TF32 tensor cores (yi-6b's shape: 3 x 137.5 GFLOP, 0.833 ms; 2.052 ms at
// the CUDA cores' 67 TFLOP/s, the ceiling of the FMA design this one
// replaced). The accuracy does not depend on torch's allow_tf32 switch:
// the split is in the kernel. What the design does:
//   * mma.sync.m16n8k8 (tf32 x tf32 -> f32), not wgmma: for 32-bit types
//     wgmma takes both operands K-major only, so P.V would need V
//     transposed in shared memory; mma.sync reads B fragments with plain
//     32-bit shared loads.
//   * A block is 128 query rows in 8 warps of 16 rows (256 threads), over
//     KV tiles of 64 keys: 8 warps a SM at D 128, against the FMA
//     design's 4. At D 256 a block is 64 rows in 4 warps over 32-key
//     tiles, so that Q and a ring of 2 fit (205,824 B) and a warp's O
//     accumulator (16 x 256: 128 registers a thread) leaves room for S (16
//     x 32) and the products' fragments. A warp's S and O accumulators
//     stay in registers.
//   * The contraction order inside each k-step is permuted, the same way
//     for both operands (a sum does not care): for S = Q.K^T, k-step 2j
//     takes D columns 16 j + 4 t + {0, 1} and k-step 2j + 1 columns
//     16 j + 4 t + {2, 3} (t = lane % 4), so one 16-byte load gives a lane
//     its Q or K fragments of two k-steps; for O += P.V, k-step j takes key
//     8 j + 2 t as fragment column t and key 8 j + 2 t + 1 as column t + 4,
//     so the S accumulator of keys 8 j .. 8 j + 7 (columns 2 t, 2 t + 1) is,
//     register for register, P's A fragment: P never leaves registers and
//     needs no shuffle.
//   * Q (scaled after the product, in f32) lives in shared memory and is
//     split per use; K and V come by cp.async (16 bytes, .cg; 4-byte copies
//     when a pointer is off a 16-byte boundary) into a ring of 2 stages:
//     tile j + 1 is in flight while tile j computes. Row strides: D + 16
//     floats for Q and K (the 16-byte loads of 8 lanes, rows g and g + 1,
//     fall on 32 distinct banks), Dv + 4 for V (rows 2 t and 2 t + 1 at
//     column g fall on bank 8 t + g).
//   * The 3 products of each fragment go term by term over 4 (S) or 8
//     (P.V; 2 at Dv 256, where more spilled) independent accumulators, so
//     no mma waits on the one before.
//   * The tensor cores' adder truncates where the f32 ALU rounds, so no
//     long sum runs through it: S is summed 16 columns of D at a time from
//     zero and each part added in f32; a tile's P.V is summed from zero
//     and folded into O as O = alpha O + part (one FFMA a register).
//     (With the sums run through the tensor cores, chip_smoke.py's edge
//     cases on an H100 erred up to 1.96e-5; so, 4.2e-6.)
//   * A warp skips the tiles that are wholly masked for its 16 rows.
//   * The kernel issues several instructions for each mma, most of them
//     the splits (each warp splits all of a tile's K and V): it is bound
//     by issue, not by the tensor cores. So the splits are two integer
//     operations each, not cvt.rna (which ptxas expands into four), and a
//     thread's copies take one base address and constant offsets (per-copy
//     addresses hoisted out of the tile loop held enough registers to
//     spill) where its threads cover whole rows.
//   Shared memory: 215,040 B at D 128, 116,736 at D 64, 67,584 at D 32,
//   205,824 at D 256, 149,504 at (96, 64); one block a SM. Registers at
//   D 128: 255 a thread, no spills.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

// the (D, Dv) pairs the kernels take, each instantiated for both dtypes
// (ops.py::HEAD_DIMS mirrors them)
#define FA_PAIRS(X) X(32, 32) X(64, 64) X(128, 128) X(256, 256) X(96, 64)

namespace {

constexpr float kNegInf = -1e30f;
constexpr int kSmemMax = 232448;   // dynamic shared memory a block may use

// error codes of this library, beside cudaError_t's
constexpr int kErrNoEncoder = 20001;   // cuTensorMapEncodeTiled not found
constexpr int kErrEncode = 20002;      // cuTensorMapEncodeTiled refused
constexpr int kErrAlign = 20003;       // a pointer off a 16-byte boundary

// ------------------------------------------------------------ the f32 path
constexpr int kStages = 2;      // the K/V ring
constexpr float kLog2e = 1.4426950408889634f;

// the f32 tile plan for head dims (D, DV) (ops.py::f32_tile_plan mirrors
// it): query rows a block (warps of 16), keys a KV tile, P.V's output
// tiles a batch
template <int D, int DV>
struct F32Plan {
  static constexpr int kBQ = D == 256 ? 64 : 128;
  static constexpr int kBK = D == 256 ? 32 : 64;
  static constexpr int kThreads = 2 * kBQ;        // a warp per 16 rows
  // O's n8 tiles a P.V batch: 2 at Dv 256, where O's accumulator holds
  // 128 registers a thread (4 spilled)
  static constexpr int kNB = DV == 256 ? 2 : (DV / 8 < 8 ? DV / 8 : 8);
  static constexpr int kQK = D + 16;   // row stride (floats) of Q and K
  static constexpr int kV = DV + 4;    // row stride of V
  static constexpr int kQFloats = kBQ * kQK;
  static constexpr int kKFloats = kBK * kQK;
  static constexpr int kStageFloats = kKFloats + kBK * kV;
  static constexpr int kSmemBytes =
      (kQFloats + kStages * kStageFloats) * static_cast<int>(sizeof(float));
};

// rows [r0, r0 + ROWS) of a contiguous (S, W) f32 matrix into shared
// memory at row stride ``stride``, by THREADS threads with cp.async; rows
// past S read as zero (their source clamped to row 0, which is not read).
// Where the threads cover whole rows, a thread copies the same columns of
// every (THREADS / copies-a-row)-th row, so its addresses are one base
// and constant offsets; otherwise (W 96, or W 256 in 4-byte copies) copy i
// of a thread is copy threadIdx.x + i THREADS of the tile, row-major.
template <int W, int ROWS, int THREADS>
__device__ __forceinline__ void load_rows(float* dst, int stride,
                                          const float* src, int r0, int S,
                                          bool vec) {
  static_assert(ROWS * W % (4 * THREADS) == 0, "whole rounds of copies");
  if (vec) {
    constexpr int kRow = W / 4;                  // 16-byte copies a row
    if constexpr (THREADS % kRow == 0) {
      constexpr int kStep = THREADS / kRow;      // rows a round
      const int r = r0 + threadIdx.x / kRow, c = threadIdx.x % kRow * 4;
      float* d = dst + (r - r0) * stride + c;
      const float* g = src + static_cast<size_t>(r) * W + c;
#pragma unroll
      for (int i = 0; i < ROWS / kStep; ++i) {
        const bool in = r + i * kStep < S;
        hopper::cp_async16(d + i * kStep * stride,
                           in ? g + i * kStep * W : src, in ? 16 : 0);
      }
    } else {
#pragma unroll
      for (int i = 0; i < ROWS * kRow / THREADS; ++i) {
        const int idx = threadIdx.x + i * THREADS;
        const int r = r0 + idx / kRow, c = idx % kRow * 4;
        const bool in = r < S;
        hopper::cp_async16(dst + (r - r0) * stride + c,
                           in ? src + static_cast<size_t>(r) * W + c : src,
                           in ? 16 : 0);
      }
    }
  } else {
    if constexpr (THREADS % W == 0) {
      constexpr int kStep = THREADS / W;
      const int r = r0 + threadIdx.x / W, c = threadIdx.x % W;
      float* d = dst + (r - r0) * stride + c;
      const float* g = src + static_cast<size_t>(r) * W + c;
      for (int i = 0; i < ROWS / kStep; ++i) {
        const bool in = r + i * kStep < S;
        hopper::cp_async4(d + i * kStep * stride,
                          in ? g + i * kStep * W : src, in ? 4 : 0);
      }
    } else {
      for (int i = 0; i < ROWS * W / THREADS; ++i) {
        const int idx = threadIdx.x + i * THREADS;
        const int r = r0 + idx / W, c = idx % W;
        const bool in = r < S;
        hopper::cp_async4(dst + (r - r0) * stride + c,
                          in ? src + static_cast<size_t>(r) * W + c : src,
                          in ? 4 : 0);
      }
    }
  }
}

// S (16 x BK) = Q (16 x D) . K^T (D x BK). q: Q's row g (row g + 8 is
// 8 rows on), k: K's key g of the tile, both at column 4 t. Each 16
// columns of D are summed from zero on the tensor cores, whose adder
// truncates, and added to S by the f32 ALU, which rounds to nearest; the
// keys go in groups of 32 (4 accumulators each) to keep the registers in
// hand, Q's fragments split once for all of them.
template <class P, int D>
__device__ __forceinline__ void qk_f32(float (&sc)[P::kBK / 8][4],
                                       const float* q, const float* k) {
#pragma unroll
  for (int n = 0; n < P::kBK / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll 1
  for (int j = 0; j < D / 16; ++j) {
    const float4 qa = *reinterpret_cast<const float4*>(q + 16 * j);
    const float4 qb = *reinterpret_cast<const float4*>(q + 8 * P::kQK + 16 * j);
    // k-step s: a0 (row g), a1 (row g + 8) at column t; a2, a3 at t + 4
    const float a[2][4] = {{qa.x, qb.x, qa.y, qb.y}, {qa.z, qb.z, qa.w, qb.w}};
    uint32_t ah[2][4], al[2][4];
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int i = 0; i < 4; ++i) hopper::split_tf32(a[s][i], ah[s][i], al[s][i]);
#pragma unroll
    for (int h = 0; h < P::kBK / 32; ++h) {
      float4 kf[4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
        kf[n] = *reinterpret_cast<const float4*>(
            k + 8 * (4 * h + n) * P::kQK + 16 * j);
      float part[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[n][e] = 0.f;
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        uint32_t bh[4][2], bl[4][2];
#pragma unroll
        for (int n = 0; n < 4; ++n) {
          hopper::split_tf32(s ? kf[n].z : kf[n].x, bh[n][0], bl[n][0]);
          hopper::split_tf32(s ? kf[n].w : kf[n].y, bh[n][1], bl[n][1]);
        }
        hopper::mma3_tf32<4>(part, ah[s], al[s], bh, bl);
      }
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) sc[4 * h + n][e] += part[n][e];
    }
  }
}

// O (16 x DV) = alpha O + P (16 x BK) . V (BK x DV). p: the softmax of the
// S accumulator, in place; v: V's key 2 t of the tile at column g; alpha:
// the rescale of rows g and g + 8. The tile's product is summed from zero
// on the tensor cores, NB output tiles at a time, and added to O by the
// f32 ALU, so the truncating adder never carries O across tiles.
template <class P, int DV>
__device__ __forceinline__ void pv_f32(float (&acc)[DV / 8][4],
                                       const float (&p)[P::kBK / 8][4],
                                       const float* v,
                                       const float (&alpha)[2]) {
  constexpr int NB = P::kNB;
#pragma unroll
  for (int n0 = 0; n0 < DV / 8; n0 += NB) {
    float part[NB][4];
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[n][e] = 0.f;
#pragma unroll
    for (int j = 0; j < P::kBK / 8; ++j) {
      // keys 8 j + 2 t (column t) and 8 j + 2 t + 1 (column t + 4)
      const float a[4] = {p[j][0], p[j][2], p[j][1], p[j][3]};
      uint32_t ah[4], al[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) hopper::split_tf32(a[i], ah[i], al[i]);
      const float* vj = v + 8 * j * P::kV + 8 * n0;
      float b[NB][2];
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        b[n][0] = vj[8 * n];
        b[n][1] = vj[P::kV + 8 * n];
      }
      uint32_t bh[NB][2], bl[NB][2];
#pragma unroll
      for (int n = 0; n < NB; ++n) {
        hopper::split_tf32(b[n][0], bh[n][0], bl[n][0]);
        hopper::split_tf32(b[n][1], bh[n][1], bl[n][1]);
      }
      hopper::mma3_tf32<NB>(part, ah, al, bh, bl);
    }
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        acc[n0 + n][e] = fmaf(acc[n0 + n][e], alpha[e >> 1], part[n][e]);
  }
}

// grid: (B * Hq, ceil(S / kBQ)), query tiles in reverse (heaviest first).
// Keys with query - key >= window are masked (S or more: no window); vec:
// q, k and v are 16-byte aligned.
template <int D, int DV>
__global__ void __launch_bounds__(F32Plan<D, DV>::kThreads, 1)
fa_kernel(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, float* __restrict__ o, int Hq,
          int KVH, int S, float scale_log2, int causal, int window,
          int vec) {
  using P = F32Plan<D, DV>;
  constexpr int kBQ = P::kBQ, kBK = P::kBK, kThreads = P::kThreads;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);   // [kBQ][kQK]
  float* ring = qs + P::kQFloats;   // kStages x {K [kBK][kQK], V [kBK][kV]}

  const int bh = blockIdx.x;
  const int b = bh / Hq;
  const int kvh = b * KVH + (bh % Hq) / (Hq / KVH);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const float* qb = q + static_cast<size_t>(bh) * S * D;
  const float* kb = k + static_cast<size_t>(kvh) * S * D;
  const float* vb = v + static_cast<size_t>(kvh) * S * DV;
  // the KV tiles holding a key some row of [q0, q0 + kBQ) may see; under a
  // window below 1 a row may see none, and then averages every key
  const bool all = window < 1;
  int k_lo = 0, k_hi = S;
  if (!all) {
    if (causal) k_hi = min(S, q0 + kBQ);
    k_lo = max(0, q0 - window + 1);
  }
  const int n_first = k_lo / kBK;
  const int n_tiles = (k_hi + kBK - 1) / kBK - n_first;

  load_rows<D, kBQ, kThreads>(qs, P::kQK, qb, q0, S, vec);
  load_rows<D, kBK, kThreads>(ring, P::kQK, kb, n_first * kBK, S, vec);
  load_rows<DV, kBK, kThreads>(ring + P::kKFloats, P::kV, vb, n_first * kBK,
                               S, vec);
  hopper::cp_async_commit();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int w_lo = q0 + 16 * warp, w_hi = w_lo + 15;   // the warp's rows
  const int row0 = w_lo + g;                           // and row0 + 8

  float acc[DV / 8][4];
#pragma unroll
  for (int n = 0; n < DV / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};   // this thread's share of the row sums

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = (n_first + it) * kBK;
    if (it + 1 < n_tiles) {
      float* next = ring + (it + 1) % kStages * P::kStageFloats;
      load_rows<D, kBK, kThreads>(next, P::kQK, kb, k0 + kBK, S, vec);
      load_rows<DV, kBK, kThreads>(next + P::kKFloats, P::kV, vb, k0 + kBK,
                                   S, vec);
      hopper::cp_async_commit();
      hopper::cp_async_wait<1>();   // this thread's copies of tile it
    } else {
      hopper::cp_async_wait<0>();
    }
    __syncthreads();                // everyone's copies of tile it
    const float* ks = ring + it % kStages * P::kStageFloats;
    const float* vs = ks + P::kKFloats;
    const bool live = w_lo < S &&
                      (all || (!(causal && k0 > w_hi) &&
                               w_lo - (k0 + kBK - 1) < window));
    if (live) {
      float sc[kBK / 8][4];
      qk_f32<P, D>(sc, qs + (16 * warp + g) * P::kQK + 4 * t,
                   ks + g * P::kQK + 4 * t);
      // scale, mask, and the online softmax of rows row0 (e < 2) and
      // row0 + 8 (e >= 2), each spread over the 4 threads of a quad
      const bool edge = k0 + kBK > S || (causal && k0 + kBK - 1 > w_lo) ||
                        w_hi - k0 >= window;
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float s = sc[n][e] * scale_log2;
          if (edge) {
            const int qi = row0 + 8 * (e >> 1);
            const int kj = k0 + 8 * n + 2 * t + (e & 1);
            const bool ok = (!causal || qi >= kj) && qi - kj < window;
            s = kj >= S ? -INFINITY : (ok ? s : kNegInf);
          }
          sc[n][e] = s;
          mx[e >> 1] = fmaxf(mx[e >> 1], s);
        }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        alpha[r] = hopper::exp2_ftz(m[r] - m_new);
        m[r] = m_new;
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int n = 0; n < kBK / 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[n][e] = hopper::exp2_ftz(sc[n][e] - m[e >> 1]);
          l[e >> 1] += sc[n][e];
        }
      pv_f32<P, DV>(acc, sc, vs + 2 * t * P::kV + g, alpha);
    }
    __syncthreads();                // stage it % kStages may be refilled
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    const float den = fmaxf(l[r], 1e-30f);
    const int qi = row0 + 8 * r;
    if (qi >= S) continue;
    float* orow = o + (static_cast<size_t>(bh) * S + qi) * DV + 2 * t;
#pragma unroll
    for (int n = 0; n < DV / 8; ++n)
      *reinterpret_cast<float2*>(orow + 8 * n) =
          make_float2(acc[n][2 * r] / den, acc[n][2 * r + 1] / den);
  }
}

template <int D, int DV>
int launch_f32(const void* q, const void* k, const void* v, void* o, int B,
               int Hq, int KVH, int S, float scale, int causal, int window,
               cudaStream_t stream) {
  using P = F32Plan<D, DV>;
  if ((S + P::kBQ - 1) / P::kBQ > 65535)   // grid.y: query tiles
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      fa_kernel<D, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      P::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec = (reinterpret_cast<uintptr_t>(q) |
                   reinterpret_cast<uintptr_t>(k) |
                   reinterpret_cast<uintptr_t>(v)) % 16 == 0;
  const dim3 grid(B * Hq, (S + P::kBQ - 1) / P::kBQ);
  fa_kernel<D, DV><<<grid, P::kThreads, P::kSmemBytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Hq, KVH, S,
      scale * kLog2e, causal, window, vec);
  return static_cast<int>(cudaGetLastError());
}

// ----------------------------------------------------------- the bf16 path
namespace tc {

constexpr int kBQ = 128;         // query rows a block: 2 consumers x 64
constexpr int kThreads = 384;    // producer warpgroup + 2 consumers
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr uint32_t kTurnBar = 1;   // named barriers 1 and 2: the consumers'
                                   // turns to issue (kSplit)

// the tile plan for head dims (D, DV) (ops.py::tile_plan mirrors it)
template <int D, int DV>
struct Plan {
  static_assert((D == 32) == (DV == 32), "one swizzle for every tile");
  // D 256: K and V on rings of their own, the consumers taking turns
  static constexpr bool kSplit = D == 256;
  static constexpr int kRings = kSplit ? 2 : 1;
  static constexpr int kBK = kSplit ? 80 : 128;         // keys a KV tile
  static constexpr int kRowBytes = D == 32 ? 64 : 128;  // a swizzled box row
  static constexpr int kBoxCols = kRowBytes / 2;
  // column boxes of Q and K (2 at D 96: columns 96..127 zero) and of V
  static constexpr int kQKBoxes = (D + kBoxCols - 1) / kBoxCols;
  static constexpr int kVBoxes = DV / kBoxCols;
  static constexpr uint32_t kMode = D == 32 ? 2 : 1;   // 64 B / 128 B swizzle
  static constexpr int kQBoxBytes = kBQ * kRowBytes;   // 128 rows of a box
  static constexpr int kKVBoxBytes = kBK * kRowBytes;  // kBK rows of a box
  static constexpr int kQBytes = kQKBoxes * kQBoxBytes;
  static constexpr int kKBytes = kQKBoxes * kKVBoxBytes;    // one K tile
  static constexpr int kVBytes = kVBoxes * kKVBoxBytes;     // one V tile
  static constexpr int kStageBytes = kKBytes + kVBytes;
  // as many stages as fit beside Q, two 8-byte barriers a ring each, Q's
  // barrier and 1024 bytes to align the base; at most 4
  static constexpr int kFit =
      (kSmemMax - 1024 - 8 - kQBytes) / (kStageBytes + 16 * kRings);
  static constexpr int kStages = kFit < 4 ? kFit : 4;
  static constexpr int kBarOffset = kQBytes + kStages * kStageBytes;
  static constexpr int kSmemBytes =
      kBarOffset + 8 * (2 * kRings * kStages + 1) + 1024;
  static_assert(kStages >= 2 && kSmemBytes <= kSmemMax, "a ring fits");
  static_assert(kKVBoxBytes % 1024 == 0, "boxes on the swizzle's 1024 B");
};

// shared-memory address of ring stage s's K tile (its V tile follows)
template <class P>
__device__ __forceinline__ uint32_t k_tile(uint32_t q_s, int s) {
  return q_s + P::kQBytes + s * P::kStageBytes;
}

// S = Q . K^T (64 x BK) over D in steps of 16: 32 bytes along a swizzled
// row, then on to the next column box (Q's boxes hold 128 rows, K's BK)
template <class P, int D>
__device__ __forceinline__ void qk_mma(float (&sc)[P::kBK / 2], uint32_t q,
                                       uint32_t k) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const int box = kk * 16 / P::kBoxCols, col = (kk * 16 % P::kBoxCols) * 2;
    const uint64_t a = hopper::make_desc(q + box * P::kQBoxBytes + col, 16,
                                         8 * P::kRowBytes, P::kMode);
    const uint64_t b = hopper::make_desc(k + box * P::kKVBoxBytes + col, 16,
                                         8 * P::kRowBytes, P::kMode);
    if constexpr (P::kBK == 128) hopper::wgmma_ss_m64n128(sc, a, b, kk > 0);
    if constexpr (P::kBK == 80) hopper::wgmma_ss_m64n80(sc, a, b, kk > 0);
  }
}

// O += P . V over the tile's keys in steps of 16. V is the MN-major B
// operand: 16 rows a step, 8-row groups 8 rows apart (SBO) and its column
// boxes one box apart (LBO); Dv 256 as two products of 128 columns.
template <class P, int DV>
__device__ __forceinline__ void pv_mma(float (&acc)[DV / 2],
                                       const uint32_t (&p)[P::kBK / 16][4],
                                       uint32_t v) {
#pragma unroll
  for (int kk = 0; kk < P::kBK / 16; ++kk) {
    const uint32_t row = v + kk * 16 * P::kRowBytes;
    if constexpr (DV <= 128) {
      const uint64_t b = hopper::make_desc(row, P::kKVBoxBytes,
                                           8 * P::kRowBytes, P::kMode);
      if constexpr (DV == 32) hopper::wgmma_rs_m64n32(acc, p[kk], b, 1);
      if constexpr (DV == 64) hopper::wgmma_rs_m64n64(acc, p[kk], b, 1);
      if constexpr (DV == 128) hopper::wgmma_rs_m64n128(acc, p[kk], b, 1);
    } else {
#pragma unroll
      for (int c = 0; c < DV / 128; ++c) {
        // columns 128 c .. 128 c + 127: boxes 2 c and 2 c + 1
        const uint64_t b = hopper::make_desc(row + 2 * c * P::kKVBoxBytes,
                                             P::kKVBoxBytes,
                                             8 * P::kRowBytes, P::kMode);
        hopper::wgmma_rs_m64n128(
            *reinterpret_cast<float(*)[64]>(acc + 64 * c), p[kk], b, 1);
      }
    }
  }
}

// what a consumer thread needs to mask its scores: its rows row0 and
// row0 + 8, its warpgroup's first and last row, its column offset in each
// 8-key group
struct Rows {
  int row0, lo, hi, col, S, causal, window;
  float scale_log2;
};

// One tile's online softmax on the 64 x BK scores of a warpgroup, in
// place: sc[4 i + e] (row row0 + 8 (e >> 1), key k0 + 8 i + col + (e & 1))
// becomes p = exp2(s * scale_log2 - m_new) in f32, m and this thread's
// share of l move on, and alpha = exp2(m_old - m_new) is returned for O.
template <int BK>
__device__ __forceinline__ void online_softmax(float (&sc)[BK / 2],
                                               float (&m)[2], float (&l)[2],
                                               float (&alpha)[2],
                                               const Rows& w, int k0) {
  // a tile that may hold masked entries (or a scale whose sign would turn
  // the row max around) is scaled and masked first
  const bool edge = k0 + BK > w.S || (w.causal && k0 + BK - 1 > w.lo) ||
                    w.hi - k0 >= w.window || !(w.scale_log2 > 0.f);
  float mx[2] = {kNegInf, kNegInf};
  if (edge) {
#pragma unroll
    for (int i = 0; i < BK / 8; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = w.row0 + 8 * (e >> 1);
        const int kj = k0 + 8 * i + w.col + (e & 1);
        const bool ok = (!w.causal || qi >= kj) && qi - kj < w.window;
        sc[4 * i + e] = kj >= w.S ? -INFINITY
                        : ok ? sc[4 * i + e] * w.scale_log2 : kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[4 * i + e]);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < BK / 2; ++i)
      mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], sc[i]);
#pragma unroll
    for (int r = 0; r < 2; ++r) mx[r] *= w.scale_log2;
  }
  const float mul = edge ? 1.f : w.scale_log2;
  float neg_m[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    alpha[r] = hopper::exp2_ftz(m[r] - m_new);
    m[r] = m_new;
    neg_m[r] = -m_new;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) {
    const int r = (i >> 1) & 1;
    sc[i] = hopper::exp2_ftz(fmaf(sc[i], mul, neg_m[r]));
    l[r] += sc[i];
  }
}

// p in bf16, already in the A-fragment order of the P.V wgmma: for keys
// 16 kk .. 16 kk + 15, the scores sc[8 kk .. 8 kk + 7] in pairs
template <int BK>
__device__ __forceinline__ void to_bf16(const float (&sc)[BK / 2],
                                        uint32_t (&p)[BK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      p[kk][j] = hopper::pack_bf16(sc[8 * kk + 2 * j], sc[8 * kk + 2 * j + 1]);
}

// grid: (B * Hq, ceil(S / kBQ)), query tiles in reverse (heaviest first).
// Maps: q (D, S, B * Hq) in boxes of (kBoxCols, 128, 1), k (D, S, B * KVH)
// and v (DV, S, B * KVH) in boxes of (kBoxCols, kBK, 1). Keys with query -
// key >= window are masked (S or more: no window).
template <int D, int DV>
__global__ void __launch_bounds__(kThreads, 1)
fa_bf16_kernel(const __grid_constant__ CUtensorMap q_map,
               const __grid_constant__ CUtensorMap k_map,
               const __grid_constant__ CUtensorMap v_map,
               __nv_bfloat16* __restrict__ o, int Hq, int KVH, int S,
               float scale_log2, int causal, int window) {
  using P = Plan<D, DV>;
  constexpr int kBK = P::kBK;
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_s = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = q_s + P::kBarOffset;
  // full[s] at bars + 8 s, empty[s] at bars + 8 (kStages + s) (K's under
  // kSplit; V's full and empty follow), then q_full
  const uint32_t v_full = bars + 16 * P::kStages;
  const uint32_t v_empty = v_full + 8 * P::kStages;
  const uint32_t q_full = bars + 16 * P::kRings * P::kStages;

  const int bh = blockIdx.x;
  const int b = bh / Hq;
  const int kvh = b * KVH + (bh % Hq) / (Hq / KVH);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  // the KV tiles holding a key some row of [q0, q0 + kBQ) may see; under a
  // window below 1 a row may see none, and then averages every key
  int k_lo = 0, k_hi = S;
  if (window >= 1) {
    if (causal) k_hi = min(S, q0 + kBQ);
    k_lo = max(0, q0 - window + 1);
  }
  const int n_first = k_lo / kBK, n_end = (k_hi + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < P::kStages; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (P::kStages + s), 8);   // the 8 consumer warps
      if constexpr (P::kSplit) {
        mbar_init(v_full + 8 * s, 1);
        mbar_init(v_empty + 8 * s, 8);
      }
    }
    mbar_init(q_full, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer warpgroup: one thread issues every load
    setmaxnreg_dec<kProducerRegs>();
    if (threadIdx.x == 0) {
      tma_prefetch_map(&k_map);
      tma_prefetch_map(&v_map);
      mbar_arrive_expect_tx(q_full, P::kQBytes);
      for (int c = 0; c < P::kQKBoxes; ++c)
        tma_load_3d(q_s + c * P::kQBoxBytes, &q_map, q_full,
                    c * P::kBoxCols, q0, bh);
      if constexpr (P::kSplit) {
        // K of tile j + 1 before V of tile j, the order the consumers
        // take them in; each ring's first revolution finds it empty
        for (int it = -1, n_tiles = n_end - n_first; it < n_tiles; ++it) {
          if (const int nx = it + 1; nx < n_tiles) {
            const int s = nx % P::kStages;
            const uint32_t full = bars + 8 * s;
            mbar_wait(bars + 8 * (P::kStages + s),
                      ((nx / P::kStages) & 1) ^ 1);
            mbar_arrive_expect_tx(full, P::kKBytes);
            for (int c = 0; c < P::kQKBoxes; ++c)
              tma_load_3d(k_tile<P>(q_s, s) + c * P::kKVBoxBytes, &k_map,
                          full, c * P::kBoxCols, (n_first + nx) * kBK, kvh);
          }
          if (it < 0) continue;
          const int s = it % P::kStages;
          const uint32_t full = v_full + 8 * s;
          mbar_wait(v_empty + 8 * s, ((it / P::kStages) & 1) ^ 1);
          mbar_arrive_expect_tx(full, P::kVBytes);
          for (int c = 0; c < P::kVBoxes; ++c)
            tma_load_3d(k_tile<P>(q_s, s) + P::kKBytes + c * P::kKVBoxBytes,
                        &v_map, full, c * P::kBoxCols, (n_first + it) * kBK,
                        kvh);
        }
        return;
      }
      for (int n = n_first, it = 0; n < n_end; ++n, ++it) {
        const int s = it % P::kStages;
        const uint32_t full = bars + 8 * s;
        const uint32_t k_s = k_tile<P>(q_s, s), v_s = k_s + P::kKBytes;
        // the ring's first revolution finds every stage empty
        mbar_wait(bars + 8 * (P::kStages + s), ((it / P::kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(full, P::kStageBytes);
        for (int c = 0; c < P::kQKBoxes; ++c)
          tma_load_3d(k_s + c * P::kKVBoxBytes, &k_map, full,
                      c * P::kBoxCols, n * kBK, kvh);
        for (int c = 0; c < P::kVBoxes; ++c)
          tma_load_3d(v_s + c * P::kKVBoxBytes, &v_map, full,
                      c * P::kBoxCols, n * kBK, kvh);
      }
    }
    return;
  }

  // ---- consumer warpgroups: rows q0 + cw * 64 .. + 63. Tile j's
  // softmax runs while the tensor cores do P.V of tile j - 1.
  setmaxnreg_inc<kConsumerRegs>();
  const int cw = threadIdx.x / 128 - 1;
  const int lane = threadIdx.x % 32;
  const int row0 = q0 + cw * 64 + (threadIdx.x / 32) % 4 * 16 + lane / 4;
  const Rows rows{row0, q0 + cw * 64, q0 + cw * 64 + 63, 2 * (lane % 4), S,
                  causal, window, scale_log2};
  const uint32_t q_wg = q_s + cw * 64 * P::kRowBytes;
  const int n_tiles = n_end - n_first;

  float acc[DV / 2];
#pragma unroll
  for (int i = 0; i < DV / 2; ++i) acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};   // this thread's share of the row sums
  float alpha[2];
  float sc[kBK / 2];
  uint32_t p[kBK / 16][4];

  if constexpr (P::kSplit) {
    // K and V on rings of their own; K's stage of tile j and V's of tile
    // j - 1 are freed once P.V of tile j - 1 is in. The consumers take
    // turns to issue their products: consumer 0 opens, each hands the turn
    // on once its products are issued (a turn for each tile, and one for
    // the last P.V).
    const auto take_turn = [&] { named_bar_sync(kTurnBar + cw, 256); };
    const auto pass_turn = [&] {
      named_bar_arrive(kTurnBar + (cw + 1) % 2, 256);
    };
    // one arrival of this warp on each given empty barrier (0: none)
    const auto release = [&](uint32_t empty_k, uint32_t empty_v) {
      __syncwarp();
      if (lane == 0) {
        if (empty_k) mbar_arrive(empty_k);
        if (empty_v) mbar_arrive(empty_v);
      }
    };
    // the full barriers of tile ``it``'s K and V stages
    const auto wait_k = [&](int it) {
      mbar_wait(bars + 8 * (it % P::kStages), (it / P::kStages) & 1);
    };
    const auto wait_v = [&](int it) {
      mbar_wait(bars + 8 * (2 * P::kStages + it % P::kStages),
                (it / P::kStages) & 1);
    };
    const auto free_tiles = [&](int k_it, int v_it) {   // -1: none
      release(k_it < 0 ? 0 : bars + 8 * (P::kStages + k_it % P::kStages),
              v_it < 0 ? 0 : bars + 8 * (3 * P::kStages + v_it % P::kStages));
    };
    const auto issue_s = [&](int it) {
      take_turn();
      __syncwarp();
      fence_regs(sc);
      fence_regs(acc);
      wgmma_fence();
      qk_mma<P, D>(sc, q_wg, k_tile<P>(q_s, it % P::kStages));
      wgmma_commit();
    };
    const auto issue_pv = [&](int it) {
      pv_mma<P, DV>(acc, p, k_tile<P>(q_s, it % P::kStages) + P::kKBytes);
      wgmma_commit();
    };
    if (cw == 0) named_bar_arrive(kTurnBar, 256);
    mbar_wait(q_full, 0);
    wait_k(0);
    issue_s(0);
    pass_turn();
    wgmma_wait<0>();
    fence_regs(sc);
    free_tiles(0, -1);
    online_softmax<kBK>(sc, m, l, alpha, rows, n_first * kBK);
    to_bf16<kBK>(sc, p);
    for (int it = 1; it < n_tiles; ++it) {
      wait_k(it);
      wait_v(it - 1);
      issue_s(it);
      issue_pv(it - 1);
      pass_turn();
      wgmma_wait<1>();   // S of tile it is in; P.V of tile it - 1 runs on
      fence_regs(sc);
      online_softmax<kBK>(sc, m, l, alpha, rows, (n_first + it) * kBK);
      wgmma_wait<0>();
      fence_regs(acc);
      free_tiles(it, it - 1);
#pragma unroll
      for (int i = 0; i < DV / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
      to_bf16<kBK>(sc, p);
    }
    wait_v(n_tiles - 1);
    take_turn();
    __syncwarp();
    fence_regs(acc);
    wgmma_fence();
    issue_pv(n_tiles - 1);
    if (cw != 1) pass_turn();   // consumer 1's last turn
    wgmma_wait<0>();
    fence_regs(acc);
  } else {
    mbar_wait(q_full, 0);
    mbar_wait(bars, 0);
    __syncwarp();
    fence_regs(sc);
    wgmma_fence();
    qk_mma<P, D>(sc, q_wg, k_tile<P>(q_s, 0));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    online_softmax<kBK>(sc, m, l, alpha, rows, n_first * kBK);
    to_bf16<kBK>(sc, p);
    for (int it = 1; it < n_tiles; ++it) {
      const int s = it % P::kStages, prev = (it - 1) % P::kStages;
      mbar_wait(bars + 8 * s, (it / P::kStages) & 1);
      __syncwarp();
      fence_regs(sc);
      fence_regs(acc);
      wgmma_fence();
      qk_mma<P, D>(sc, q_wg, k_tile<P>(q_s, s));
      wgmma_commit();
      pv_mma<P, DV>(acc, p, k_tile<P>(q_s, prev) + P::kKBytes);
      wgmma_commit();
      wgmma_wait<1>();   // S of tile it is in; P.V of tile it - 1 runs on
      fence_regs(sc);
      online_softmax<kBK>(sc, m, l, alpha, rows, (n_first + it) * kBK);
      wgmma_wait<0>();
      fence_regs(acc);
      __syncwarp();
      if (lane == 0) mbar_arrive(bars + 8 * (P::kStages + prev));
#pragma unroll
      for (int i = 0; i < DV / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
      to_bf16<kBK>(sc, p);
    }
    const int last = (n_tiles - 1) % P::kStages;
    fence_regs(acc);
    wgmma_fence();
    pv_mma<P, DV>(acc, p, k_tile<P>(q_s, last) + P::kKBytes);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
  }

  float den[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    den[r] = fmaxf(l[r], 1e-30f);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row0 + 8 * r;
    if (qi >= S) continue;
    uint32_t* orow = reinterpret_cast<uint32_t*>(
        o + (static_cast<size_t>(bh) * S + qi) * DV + rows.col);
#pragma unroll
    for (int i = 0; i < DV / 8; ++i)
      orow[4 * i] = pack_bf16(acc[4 * i + 2 * r] / den[r],
                              acc[4 * i + 2 * r + 1] / den[r]);
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                void*, const cuuint64_t*, const cuuint64_t*,
                                const cuuint32_t*, const cuuint32_t*,
                                CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled of libcuda, looked up through the runtime (the
// library is not linked against libcuda)
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a (width, S, heads) bf16 tensor, boxes of (box_cols, rows, 1); columns
// of a box past ``width`` read as zero
template <class P>
int make_map(CUtensorMap* map, const void* ptr, int width, int S, int heads,
             int rows) {
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return kErrNoEncoder;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(width),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(width) * 2,
                                 static_cast<cuuint64_t>(S) * width * 2};
  const cuuint32_t box[3] = {P::kBoxCols, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      P::kMode == 2 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kErrEncode;
}

template <int D, int DV>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Hq, int KVH, int S, float scale, int causal, int window,
           cudaStream_t stream) {
  using P = Plan<D, DV>;
  if ((S + kBQ - 1) / kBQ > 65535)   // grid.y: query tiles
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap q_map, k_map, v_map;
  int err = make_map<P>(&q_map, q, D, S, B * Hq, kBQ);
  if (!err) err = make_map<P>(&k_map, k, D, S, B * KVH, P::kBK);
  if (!err) err = make_map<P>(&v_map, v, DV, S, B * KVH, P::kBK);
  if (err) return err;
  const cudaError_t attr = cudaFuncSetAttribute(
      fa_bf16_kernel<D, DV>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      P::kSmemBytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(B * Hq, (S + kBQ - 1) / kBQ);
  fa_bf16_kernel<D, DV><<<grid, kThreads, P::kSmemBytes, stream>>>(
      q_map, k_map, v_map, static_cast<__nv_bfloat16*>(o), Hq, KVH, S,
      scale * kLog2e, causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

}  // namespace

extern "C" {

// q: (B, Hq, S, D), k: (B, KVH, S, D), v: (B, KVH, S, DV), o: (B, Hq, S,
// DV), all contiguous on the device, f32 (dtype 0; any alignment) or bf16
// (dtype 1; every pointer 16-byte aligned). (D, DV) one of FA_PAIRS;
// Hq % KVH == 0. Keys with query - key >= window are masked: pass S (or
// more) for no window; a window below 1 may leave a row no key, which
// then averages all S values.
// Returns cudaGetLastError() after the launch, or the error that stopped
// it (see fa_error_string).
int fa_launch(const void* q, const void* k, const void* v, void* o,
              int dtype, int B, int Hq, int KVH, int S, int D, int DV,
              float scale, int causal, int window, void* stream) {
  if (B <= 0 || S <= 0 || KVH <= 0 || Hq % KVH != 0 || Hq > 65535 ||
      B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
#define FA_F32(d, dv)                                                     \
    if (D == d && DV == dv)                                               \
      return launch_f32<d, dv>(q, k, v, o, B, Hq, KVH, S, scale, causal,  \
                               window, st);
    FA_PAIRS(FA_F32)
#undef FA_F32
  } else if (dtype == 1) {
    if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
         reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) % 16)
      return kErrAlign;
#define FA_BF16(d, dv)                                                    \
    if (D == d && DV == dv)                                               \
      return tc::launch<d, dv>(q, k, v, o, B, Hq, KVH, S, scale, causal,  \
                               window, st);
    FA_PAIRS(FA_BF16)
#undef FA_BF16
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// dynamic shared memory an f32 block takes at head dims (D, DV) (0 if none)
int fa_f32_smem_bytes(int D, int DV) {
#define FA_F32_SMEM(d, dv) \
  if (D == d && DV == dv) return F32Plan<d, dv>::kSmemBytes;
  FA_PAIRS(FA_F32_SMEM)
#undef FA_F32_SMEM
  return 0;
}

// the bf16 plan at head dims (D, DV) into out[5]: query rows and keys a
// tile, ring stages, split rings (K and V apart, the consumers taking
// turns), and the dynamic shared memory a block takes. Returns 0, or -1
// for a pair it does not take.
int fa_bf16_plan(int D, int DV, int* out) {
#define FA_BF16_PLAN(d, dv)                                               \
  if (D == d && DV == dv) {                                               \
    using P = tc::Plan<d, dv>;                                            \
    const int plan[5] = {tc::kBQ, P::kBK, P::kStages, P::kSplit,          \
                         P::kSmemBytes};                                  \
    for (int i = 0; i < 5; ++i) out[i] = plan[i];                         \
    return 0;                                                             \
  }
  FA_PAIRS(FA_BF16_PLAN)
#undef FA_BF16_PLAN
  return -1;
}

const char* fa_error_string(int code) {
  switch (code) {
    case kErrNoEncoder: return "cuTensorMapEncodeTiled not found in libcuda";
    case kErrEncode: return "cuTensorMapEncodeTiled refused a tensor map";
    case kErrAlign: return "a bf16 pointer is not 16-byte aligned (TMA)";
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
