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
// the CUDA cores' 67 TFLOP/s). mma.sync.m16n8k8 itself reaches about 320
// TFLOP/s on an H100 (a bare loop of independent products). The accuracy
// does not depend on torch's allow_tf32 switch: the split is in the
// kernel. What the design does:
//   * mma.sync.m16n8k8 (tf32 x tf32 -> f32), not wgmma: for 32-bit types
//     wgmma takes both operands K-major only, so P.V would need V
//     transposed in shared memory.
//   * The contraction order inside each k-step is permuted, the same way
//     for both operands (a sum does not care): for S = Q.K^T, k-step 2j
//     takes D columns 16 j + 4 t + {0, 1} and k-step 2j + 1 columns
//     16 j + 4 t + {2, 3} (t = lane % 4), so 16 contiguous bytes hold a
//     lane's Q or K fragments of two k-steps; for O += P.V, k-step j takes
//     key 8 j + 2 t as fragment column t and key 8 j + 2 t + 1 as column
//     t + 4, so the S accumulator of keys 8 j .. 8 j + 7 is, register for
//     register, P's A fragment: P never needs a shuffle.
//   * The kernel issues several instructions for each mma, most of them
//     the splits (an add and a mask each for tf32, not cvt.rna, which
//     ptxas expands into four): it is bound by issue and by shared memory,
//     not by the tensor cores. Split per use, each warp would split all of
//     a tile's K and V, Q once a tile and P once an output batch; so no
//     value is split twice where the shared memory allows it ("split
//     once", every pair but D 256):
//     - Q is split once, before the first tile, into hi and lo planes.
//     - Each KV tile lands raw by cp.async (16 bytes, .cg; 4-byte copies
//       when a pointer is off a 16-byte boundary), and the whole block
//       splits it once into hi and lo planes of K and V.
//     - A plane is in the order of the mma fragments: a lane's words for
//       two k-steps (Q, K) or two output tiles (V) are 16 contiguous
//       bytes, so every fragment load is one conflict-free 16-byte load.
//     - P is split once a tile, in registers.
//     A plane costs twice a raw tile's bytes a fragment, so the keys a
//     tile are as many as the planes leave room for (64 at D 64 and (96,
//     64), 128 at D 32, 32 at D 128), and the split and the products take
//     turns (two barriers a tile), the next tile's copies running beside
//     the products. 128 rows in 8 warps of 16.
//   * At D 256 (gemma-2b) Q's planes alone would take 128 KB, and a warp
//     holding a strip's whole O (16 x 256) 128 registers a thread, which
//     leaves 4 warps an SM. The pair plan: 64 rows in 8 warps, two a
//     16-row strip. Each scores half of a 32-key tile's keys and holds
//     half of O's columns (64 registers); the two trade their row maxima
//     and their halves of P through shared memory under the strip's named
//     barrier, and each splits the tile's whole P once. Q stays raw, K and
//     V come raw into a ring of 2 (rows padded to D + 16 and Dv + 4 floats
//     for conflict-free loads), and each warp splits what it reads.
//   * The tensor cores' adder truncates where the f32 ALU rounds, so no
//     long sum runs through it: S is summed 16 columns of D at a time from
//     zero and each part added in f32, in column order; a tile's P.V is
//     summed from zero and folded into O as O = alpha O + part (one FFMA a
//     register). (With the sums run through the tensor cores,
//     chip_smoke.py's edge cases on an H100 erred up to 1.96e-5; so,
//     4.2e-6.) kJU blocks of 16 columns of S (2, or 4 at D 128) have
//     their products in flight at once, 4 n8 tiles of keys each (2 in the
//     pair plan), and P.V's 8 output tiles, so no mma waits on the one
//     before; the parts are still added in column order.
//   * A warp skips the tiles that are wholly masked for its 16 rows.
//   Shared memory (F32Plan): 141,312 B at D 32, 168,960 at D 64, 231,936
//   at D 128, 226,304 at (96, 64), 216,064 at D 256; one block a SM.

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
constexpr float kLog2e = 1.4426950408889634f;

// The f32 plan for head dims (D, DV) (ops.py::f32_tile_plan mirrors it).
// Split once (kOnce), every pair but D 256: 128 query rows in 8 warps of
// 16; each KV tile's K and V split into tf32 hi and lo once, by the whole
// block, into fragment-ordered planes, and Q once before the first tile.
// The pair plan, D 256: 64 rows in 8 warps, two a 16-row strip (kPair),
// each scoring half of a tile's keys and holding half of O's columns; Q
// stays raw, K and V come raw into a ring of 2, and each warp splits what
// it reads.
template <int D, int DV>
struct F32Plan {
  static constexpr bool kOnce = D != 256;
  static constexpr int kPair = kOnce ? 1 : 2;   // warps a 16-row strip
  static constexpr int kBQ = kOnce ? 128 : 64;  // query rows a block
  // keys a KV tile, as many as the planes leave room for (whole groups of
  // 4 n8 tiles)
  static constexpr int kBK = D == 32 ? 128 : (D == 64 || D == 96) ? 64 : 32;
  // 16-column blocks of S whose products are in flight at once
  static constexpr int kJU = D == 128 ? 4 : 2;
  static constexpr int kRaw = kOnce ? 1 : 2;     // raw K/V stages
  static constexpr int kSplit = kOnce ? 1 : 0;   // split K/V stages
  static constexpr int kThreads = 2 * kBQ * kPair;   // 8 warps
  static constexpr int kDvW = DV / kPair;            // O's columns a warp
  static constexpr int kNB = kDvW / 8 < 8 ? kDvW / 8 : 8;   // P.V's n8 tiles
                                                            // a batch
  static constexpr int kQK = D + 16;   // row stride (floats) of raw Q and K
  static constexpr int kV = DV + 4;    // row stride of raw V
  static constexpr int kQFloats = kBQ * kQK;
  static constexpr int kKFloats = kBK * kQK;
  static constexpr int kStageFloats = kKFloats + kBK * kV;   // a raw stage
  // a split stage: K's hi and lo planes, then V's (32-bit words)
  static constexpr int kSplitWords = 2 * kBK * (D + DV);
  // what a pair warp publishes to its partner a tile: its half of P (4
  // words a lane an n8 tile), then its row maxima (2 a lane)
  static constexpr int kXchWords = kBK / 16 * 128 + 64;
  static constexpr int kSmemBytes =
      4 * (kOnce ? 2 * kBQ * D + kSplit * kSplitWords + kRaw * kStageFloats
                 : kQFloats + kRaw * kStageFloats +
                       kThreads / 32 * kXchWords);
  static_assert(kSmemBytes <= kSmemMax, "a block's tiles fit");
  static_assert(kBK % 32 == 0 && (D / 16) % kJU == 0 && kNB % 2 == 0,
                "whole key groups, column blocks and output tile pairs");
  // split once: Q's raw tile is staged over the split and raw stages
  static_assert(!kOnce || kQFloats <= kSplitWords + kStageFloats,
                "Q's raw tile fits where it is staged");
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

// A block's query head bh, its KV head, its first query row q0, and the
// KV tiles holding a key some row of [q0, q0 + BQ) may see: n_tiles from
// tile n_first. Under a window below 1 (all) a row may see none, and then
// averages every key. grid: (B * Hq, ceil(S / BQ)), query tiles in
// reverse (heaviest first).
struct BlockTiles {
  int bh, kvh, q0, n_first, n_tiles;
  bool all;
};

template <int BQ, int BK>
__device__ __forceinline__ BlockTiles block_tiles(int Hq, int KVH, int S,
                                                  int causal, int window) {
  BlockTiles b;
  b.bh = blockIdx.x;
  b.kvh = b.bh / Hq * KVH + (b.bh % Hq) / (Hq / KVH);
  b.q0 = (gridDim.y - 1 - blockIdx.y) * BQ;
  b.all = window < 1;
  int k_lo = 0, k_hi = S;
  if (!b.all) {
    if (causal) k_hi = min(S, b.q0 + BQ);
    k_lo = max(0, b.q0 - window + 1);
  }
  b.n_first = k_lo / BK;
  b.n_tiles = (k_hi + BK - 1) / BK - b.n_first;
  return b;
}

// whether a warp's rows [w_lo, w_lo + 15] see a key of the tile at k0
// (skipped otherwise), and whether the tile may hold a masked key for them
__device__ __forceinline__ bool tile_live(int w_lo, int k0, int bk, int S,
                                          bool all, int causal,
                                          int window) {
  return w_lo < S && (all || (!(causal && k0 > w_lo + 15) &&
                              w_lo - (k0 + bk - 1) < window));
}
__device__ __forceinline__ bool tile_edge(int w_lo, int k0, int bk, int S,
                                          int causal, int window) {
  return k0 + bk > S || (causal && k0 + bk - 1 > w_lo) ||
         w_lo + 15 - k0 >= window;
}

// Scale and mask NT n8 tiles of a warp's scores, in place: sc[n][e] is row
// row0 + 8 (e >> 1) at key kc + 8 n + 2 t + (e & 1); entries outside the
// mask -1e30, keys past S -inf. mx: each row's maximum over the quad.
template <int NT>
__device__ __forceinline__ void scale_mask(float (&sc)[NT][4],
                                           float (&mx)[2], int row0, int kc,
                                           int t, int S, int causal,
                                           int window, float scale_log2,
                                           bool edge) {
  mx[0] = mx[1] = kNegInf;
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float s = sc[n][e] * scale_log2;
      if (edge) {
        const int qi = row0 + 8 * (e >> 1);
        const int kj = kc + 8 * n + 2 * t + (e & 1);
        const bool ok = (!causal || qi >= kj) && qi - kj < window;
        s = kj >= S ? -INFINITY : (ok ? s : kNegInf);
      }
      sc[n][e] = s;
      mx[e >> 1] = fmaxf(mx[e >> 1], s);
    }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
  }
}

// the online softmax's step for rows row0 and row0 + 8 given the tile's
// row maxima: m moves on, alpha = exp2(m_old - m_new) rescales l (this
// thread's share of the row sums) here and O in the P.V fold
__device__ __forceinline__ void rescale(float (&m)[2], float (&l)[2],
                                        float (&alpha)[2],
                                        const float (&mx)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float m_new = fmaxf(m[r], mx[r]);
    alpha[r] = hopper::exp2_ftz(m[r] - m_new);
    m[r] = m_new;
    l[r] *= alpha[r];
  }
}

// p = exp2(s - m) in place, added to this thread's share of l
template <int NT>
__device__ __forceinline__ void exp_rows(float (&sc)[NT][4], float (&l)[2],
                                         const float (&m)[2]) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      sc[n][e] = hopper::exp2_ftz(sc[n][e] - m[e >> 1]);
      l[e >> 1] += sc[n][e];
    }
}

// one n8 tile of P (the S accumulator's layout) split into the A fragment
// of a P.V k-step: keys 8 n + 2 t as column t, 8 n + 2 t + 1 as column
// t + 4, so the accumulator is, register for register, the fragment
__device__ __forceinline__ void split_p(const float (&p)[4], uint32_t (&h)[4],
                                        uint32_t (&l)[4]) {
  hopper::split_tf32(p[0], h[0], l[0]);
  hopper::split_tf32(p[2], h[1], l[1]);
  hopper::split_tf32(p[1], h[2], l[2]);
  hopper::split_tf32(p[3], h[3], l[3]);
}

// O = alpha O + part, NB n8 tiles from n0, by the f32 ALU: the tensor
// cores' truncating adder never carries O across tiles
template <int NT, int NB>
__device__ __forceinline__ void fold(float (&acc)[NT][4], int n0,
                                     const float (&part)[NB][4],
                                     const float (&alpha)[2]) {
#pragma unroll
  for (int n = 0; n < NB; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      acc[n0 + n][e] = fmaf(acc[n0 + n][e], alpha[e >> 1], part[n][e]);
}

// O's rows row0 and row0 + 8 (those below S), columns 8 n + 2 t of orow,
// divided by the row sums l (the quad's, already added)
template <int NT>
__device__ __forceinline__ void store_o(float* orow, int row_stride,
                                        const float (&acc)[NT][4],
                                        const float (&l)[2], int row0,
                                        int S) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const float den = fmaxf(l[r], 1e-30f);
    if (row0 + 8 * r >= S) continue;
    float* out = orow + 8 * r * row_stride;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      *reinterpret_cast<float2*>(out + 8 * n) =
          make_float2(acc[n][2 * r] / den, acc[n][2 * r + 1] / den);
  }
}

__device__ __forceinline__ void quad_sum(float (&l)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
}

// S (16 x NT 8) = Q (16 x D) . K^T on the tensor cores, each product as
// three TF32 products. qf(j, ah, al) gives Q's hi and lo A fragments of
// k-steps 2 j and 2 j + 1 (columns 16 j ..), kf(n, j, bh, bl) key tile n's
// B fragments of the same two k-steps ([s][0..1]). Each 16 columns of D
// are summed from zero on the tensor cores, whose adder truncates, and
// added to S by the f32 ALU, which rounds to nearest, in column order; JU
// blocks of 16 columns and up to 4 key tiles each have their products in
// flight at once.
template <int NT, int D, int JU, class QF, class KF>
__device__ __forceinline__ void qk_tf32(float (&sc)[NT][4], QF qf, KF kf) {
  constexpr int G = NT < 4 ? NT : 4;
  static_assert(NT % G == 0 && (D / 16) % JU == 0, "whole groups");
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) sc[n][e] = 0.f;
#pragma unroll 1
  for (int j0 = 0; j0 < D / 16; j0 += JU) {
    uint32_t ah[JU][2][4], al[JU][2][4];
#pragma unroll
    for (int u = 0; u < JU; ++u) qf(j0 + u, ah[u], al[u]);
#pragma unroll
    for (int n0 = 0; n0 < NT; n0 += G) {
      float part[JU][G][4];
#pragma unroll
      for (int u = 0; u < JU; ++u)
#pragma unroll
        for (int n = 0; n < G; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[u][n][e] = 0.f;
#pragma unroll
      for (int u = 0; u < JU; ++u) {
        uint32_t fh[G][2][2], fl[G][2][2];
#pragma unroll
        for (int n = 0; n < G; ++n) kf(n0 + n, j0 + u, fh[n], fl[n]);
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          uint32_t bh[G][2], bl[G][2];
#pragma unroll
          for (int n = 0; n < G; ++n)
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              bh[n][r] = fh[n][s][r];
              bl[n][r] = fl[n][s][r];
            }
          hopper::mma3_tf32<G>(part[u], ah[u][s], al[u][s], bh, bl);
        }
      }
#pragma unroll
      for (int u = 0; u < JU; ++u)
#pragma unroll
        for (int n = 0; n < G; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) sc[n0 + n][e] += part[u][n][e];
    }
  }
}

// O (16 x NO 8) = alpha O + P (16 x NT 8) . V. ph, pl: the tile's P split
// once (split_p); vf(j, m, bh, bl): V's B fragments of k-step j (keys
// 8 j ..) for output tiles 2 m and 2 m + 1 ([2][2]). The tile's product is
// summed from zero, NB output tiles at a time, and folded into O.
template <int NO, int NT, int NB, class VF>
__device__ __forceinline__ void pv_tf32(float (&acc)[NO][4],
                                        const uint32_t (&ph)[NT][4],
                                        const uint32_t (&pl)[NT][4], VF vf,
                                        const float (&alpha)[2]) {
  static_assert(NO % NB == 0 && NB % 2 == 0, "whole batches of tile pairs");
#pragma unroll
  for (int n0 = 0; n0 < NO; n0 += NB) {
    float part[NB][4];
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[n][e] = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t bh[NB][2], bl[NB][2];
#pragma unroll
      for (int m = 0; m < NB / 2; ++m) {
        uint32_t h[2][2], l[2][2];
        vf(j, n0 / 2 + m, h, l);
#pragma unroll
        for (int i = 0; i < 2; ++i)
#pragma unroll
          for (int r = 0; r < 2; ++r) {
            bh[2 * m + i][r] = h[i][r];
            bl[2 * m + i][r] = l[i][r];
          }
      }
      hopper::mma3_tf32<NB>(part, ph[j], pl[j], bh, bl);
    }
    fold(acc, n0, part, alpha);
  }
}

// ---- split once (P::kOnce). A plane holds a tile's tf32 hi or lo parts
// in the order of the mma fragments: a lane's words for one pair of
// k-steps (Q, K) or one pair of output tiles (V) are 16 contiguous bytes,
// a warp's 512, so every fragment load is one conflict-free 16-byte load
// and nothing is split twice.

// Q's tile, staged raw at ``raw`` (row stride kQK), into its planes: for
// strip w, columns 16 j .. 16 j + 15 and k-step s, lane (g, t)'s A
// fragment (rows g and g + 8 at columns 16 j + 4 t + 2 s and + 1) at word
// 128 ((w D / 16 + j) 2 + s) + 4 lane
template <class P, int D>
__device__ __forceinline__ void split_q(uint32_t* hi, uint32_t* lo,
                                        const float* raw) {
  constexpr int kUnits = P::kBQ * D / 8;   // (w, j, lane)
  static_assert(kUnits % P::kThreads == 0, "whole rounds of units");
  const int lane = threadIdx.x % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int i = 0; i < kUnits / P::kThreads; ++i) {
    const int wj = (threadIdx.x + i * P::kThreads) / 32;
    const int w = wj / (D / 16), j = wj % (D / 16);
    const float* r = raw + (16 * w + g) * P::kQK + 16 * j + 4 * t;
    const float4 qa = *reinterpret_cast<const float4*>(r);
    const float4 qb = *reinterpret_cast<const float4*>(r + 8 * P::kQK);
    const float a[2][4] = {{qa.x, qb.x, qa.y, qb.y}, {qa.z, qb.z, qa.w, qb.w}};
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      uint4 h, l;
      hopper::split_tf32(a[s][0], h.x, l.x);
      hopper::split_tf32(a[s][1], h.y, l.y);
      hopper::split_tf32(a[s][2], h.z, l.z);
      hopper::split_tf32(a[s][3], h.w, l.w);
      const int at = 128 * (2 * wj + s) + 4 * lane;
      *reinterpret_cast<uint4*>(hi + at) = h;
      *reinterpret_cast<uint4*>(lo + at) = l;
    }
  }
}

// A raw K/V stage (rows at strides kQK and kV) into the split stage: K's
// hi and lo planes (key tile n, columns 16 j ..: lane (g, t)'s K[8 n + g]
// [16 j + 4 t .. + 3], two k-steps' B fragments, at word 4 u, u = 32 (n D
// / 16 + j) + lane), then V's (keys 8 j .., output tiles 2 m and 2 m + 1:
// V[8 j + 2 t][16 m + g], V[8 j + 2 t + 1][16 m + g] and the same at
// column 16 m + 8 + g, at 4 u, u = 32 (j DV / 16 + m) + lane). Each thread
// reads whole units and writes them split: one split a value a block.
template <class P, int D, int DV>
__device__ __forceinline__ void split_kv(uint32_t* dst, const float* raw) {
  constexpr int BK = P::kBK;
  constexpr int kKUnits = BK * D / 4, kVUnits = BK * DV / 4;
  static_assert(kKUnits % P::kThreads == 0 && kVUnits % P::kThreads == 0,
                "whole rounds of units");
  uint32_t* khi = dst;
  uint32_t* klo = khi + BK * D;
  uint32_t* vhi = klo + BK * D;
  uint32_t* vlo = vhi + BK * DV;
  const int g = threadIdx.x % 32 / 4, t = threadIdx.x % 4;
#pragma unroll
  for (int i = 0; i < kKUnits / P::kThreads; ++i) {
    const int u = threadIdx.x + i * P::kThreads;
    const int n = u / 32 / (D / 16), j = u / 32 % (D / 16);
    const float4 x = *reinterpret_cast<const float4*>(
        raw + (8 * n + g) * P::kQK + 16 * j + 4 * t);
    uint4 h, l;
    hopper::split_tf32(x.x, h.x, l.x);
    hopper::split_tf32(x.y, h.y, l.y);
    hopper::split_tf32(x.z, h.z, l.z);
    hopper::split_tf32(x.w, h.w, l.w);
    *reinterpret_cast<uint4*>(khi + 4 * u) = h;
    *reinterpret_cast<uint4*>(klo + 4 * u) = l;
  }
  const float* vraw = raw + P::kKFloats;
#pragma unroll
  for (int i = 0; i < kVUnits / P::kThreads; ++i) {
    const int u = threadIdx.x + i * P::kThreads;
    const int j = u / 32 / (DV / 16), m = u / 32 % (DV / 16);
    const float* c = vraw + (8 * j + 2 * t) * P::kV + 16 * m + g;
    uint4 h, l;
    hopper::split_tf32(c[0], h.x, l.x);
    hopper::split_tf32(c[P::kV], h.y, l.y);
    hopper::split_tf32(c[8], h.z, l.z);
    hopper::split_tf32(c[P::kV + 8], h.w, l.w);
    *reinterpret_cast<uint4*>(vhi + 4 * u) = h;
    *reinterpret_cast<uint4*>(vlo + 4 * u) = l;
  }
}

// The split-once block: Q staged raw over the stages and split into its
// planes; then for each KV tile, its raw stage split by every thread into
// the split stage, which every warp reads. The split and the products take
// turns (two barriers a tile); the next tile's copies run beside the
// products.
template <int D, int DV>
__device__ __forceinline__ void fa_once(const float* __restrict__ q,
                                        const float* __restrict__ k,
                                        const float* __restrict__ v,
                                        float* __restrict__ o, int Hq,
                                        int KVH, int S, float scale_log2,
                                        int causal, int window, int vec) {
  using P = F32Plan<D, DV>;
  constexpr int kBQ = P::kBQ, kBK = P::kBK, kThreads = P::kThreads;
  extern __shared__ float4 smem4[];
  uint32_t* qhi = reinterpret_cast<uint32_t*>(smem4);   // [kBQ D] each
  uint32_t* qlo = qhi + kBQ * D;
  uint32_t* split = qlo + kBQ * D;   // {K hi, K lo, V hi, V lo}
  float* raw = reinterpret_cast<float*>(split + P::kSplitWords);
  const BlockTiles bt = block_tiles<kBQ, kBK>(Hq, KVH, S, causal, window);
  const float* kb = k + static_cast<size_t>(bt.kvh) * S * D;
  const float* vb = v + static_cast<size_t>(bt.kvh) * S * DV;

  float* q_raw = reinterpret_cast<float*>(split);
  load_rows<D, kBQ, kThreads>(q_raw, P::kQK,
                              q + static_cast<size_t>(bt.bh) * S * D, bt.q0,
                              S, vec);
  hopper::cp_async_commit();
  hopper::cp_async_wait<0>();
  __syncthreads();
  split_q<P, D>(qhi, qlo, q_raw);
  __syncthreads();                  // Q's staging may be overwritten
  const auto load_tile = [&](int it) {
    const int k0 = (bt.n_first + it) * kBK;
    load_rows<D, kBK, kThreads>(raw, P::kQK, kb, k0, S, vec);
    load_rows<DV, kBK, kThreads>(raw + P::kKFloats, P::kV, vb, k0, S, vec);
    hopper::cp_async_commit();
  };
  if (bt.n_tiles > 0) load_tile(0);

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t = lane % 4;
  const int w_lo = bt.q0 + 16 * warp, row0 = w_lo + lane / 4;
  // the fragments, each of a lane's 16-byte words from a plane
  const uint32_t* qh = qhi + 256 * (D / 16) * warp + 4 * lane;
  const uint32_t* kh = split + 4 * lane;   // and K lo, V hi, V lo after it
  const auto q_planes = [&](int j, uint32_t (&hi)[2][4], uint32_t (&lo)[2][4]) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const uint4 x = *reinterpret_cast<const uint4*>(qh + 128 * (2 * j + s));
      const uint4 y = *reinterpret_cast<const uint4*>(qh + kBQ * D +
                                                      128 * (2 * j + s));
      hi[s][0] = x.x; hi[s][1] = x.y; hi[s][2] = x.z; hi[s][3] = x.w;
      lo[s][0] = y.x; lo[s][1] = y.y; lo[s][2] = y.z; lo[s][3] = y.w;
    }
  };
  // two k-steps of a key tile, or (V) two output tiles of a k-step
  const auto words = [](const uint32_t* at_hi, const uint32_t* at_lo,
                        uint32_t (&hi)[2][2], uint32_t (&lo)[2][2]) {
    const uint4 x = *reinterpret_cast<const uint4*>(at_hi);
    const uint4 y = *reinterpret_cast<const uint4*>(at_lo);
    hi[0][0] = x.x; hi[0][1] = x.y; hi[1][0] = x.z; hi[1][1] = x.w;
    lo[0][0] = y.x; lo[0][1] = y.y; lo[1][0] = y.z; lo[1][1] = y.w;
  };
  const auto k_planes = [&](int n, int j, uint32_t (&hi)[2][2],
                            uint32_t (&lo)[2][2]) {
    const uint32_t* at = kh + 128 * (n * (D / 16) + j);
    words(at, at + kBK * D, hi, lo);
  };
  const auto v_planes = [&](int j, int tp, uint32_t (&hi)[2][2],
                            uint32_t (&lo)[2][2]) {
    const uint32_t* at = kh + 2 * kBK * D + 128 * (j * (DV / 16) + tp);
    words(at, at + kBK * DV, hi, lo);
  };
  float acc[DV / 8][4];
#pragma unroll
  for (int n = 0; n < DV / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};   // this thread's share of the row sums

  for (int it = 0; it < bt.n_tiles; ++it) {
    const int k0 = (bt.n_first + it) * kBK;
    hopper::cp_async_wait<0>();     // this thread's copies of tile it
    __syncthreads();                // everyone's; tile it - 1 read
    split_kv<P, D, DV>(split, raw);
    __syncthreads();                // tile it split; its raw stage free
    if (it + 1 < bt.n_tiles) load_tile(it + 1);
    if (!tile_live(w_lo, k0, kBK, S, bt.all, causal, window)) continue;
    float sc[kBK / 8][4];
    qk_tf32<kBK / 8, D, P::kJU>(sc, q_planes, k_planes);
    float mx[2], alpha[2];
    scale_mask(sc, mx, row0, k0, t, S, causal, window, scale_log2,
               tile_edge(w_lo, k0, kBK, S, causal, window));
    rescale(m, l, alpha, mx);
    exp_rows(sc, l, m);
    uint32_t ph[kBK / 8][4], pl[kBK / 8][4];
#pragma unroll
    for (int n = 0; n < kBK / 8; ++n) split_p(sc[n], ph[n], pl[n]);
    pv_tf32<DV / 8, kBK / 8, P::kNB>(acc, ph, pl, v_planes, alpha);
  }
  quad_sum(l);
  store_o(o + (static_cast<size_t>(bt.bh) * S + row0) * DV + 2 * t, DV, acc,
          l, row0, S);
}

// ---- the pair plan (D 256): two warps a 16-row strip. Each scores half
// of a tile's keys and holds half of O's columns; they trade their row
// maxima and their halves of P through shared memory under the strip's
// named barrier, so a warp's O takes 64 registers, not 128, and a block
// has 8 warps, not 4, with no product taken twice.

// The pair block: K and V by cp.async into a ring of 2 (tile j + 1 in
// flight while tile j computes), Q raw; per tile each warp scores its half
// of the keys, publishes its row maxima, takes the partner's (barrier),
// publishes its half of P, takes the partner's (barrier), splits the
// whole P once and multiplies it into its half of O's columns.
template <int D, int DV>
__device__ __forceinline__ void fa_pair(const float* __restrict__ q,
                                        const float* __restrict__ k,
                                        const float* __restrict__ v,
                                        float* __restrict__ o, int Hq,
                                        int KVH, int S, float scale_log2,
                                        int causal, int window, int vec) {
  using P = F32Plan<D, DV>;
  constexpr int kBQ = P::kBQ, kBK = P::kBK, kThreads = P::kThreads;
  constexpr int kNT = kBK / 8, kHT = kNT / 2;   // n8 tiles: a tile's, a warp's
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);   // [kBQ][kQK]
  float* ring = qs + P::kQFloats;   // 2 x {K [kBK][kQK], V [kBK][kV]}
  float* xch = ring + 2 * P::kStageFloats;   // kXchWords a warp
  const BlockTiles bt = block_tiles<kBQ, kBK>(Hq, KVH, S, causal, window);
  const float* kb = k + static_cast<size_t>(bt.kvh) * S * D;
  const float* vb = v + static_cast<size_t>(bt.kvh) * S * DV;
  const auto load_tile = [&](int it) {   // into stage it % 2
    float* st = ring + it % 2 * P::kStageFloats;
    const int k0 = (bt.n_first + it) * kBK;
    load_rows<D, kBK, kThreads>(st, P::kQK, kb, k0, S, vec);
    load_rows<DV, kBK, kThreads>(st + P::kKFloats, P::kV, vb, k0, S, vec);
  };

  load_rows<D, kBQ, kThreads>(qs, P::kQK,
                              q + static_cast<size_t>(bt.bh) * S * D, bt.q0,
                              S, vec);
  if (bt.n_tiles > 0) load_tile(0);
  hopper::cp_async_commit();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int strip = warp / 2, half = warp % 2;
  const int w_lo = bt.q0 + 16 * strip, row0 = w_lo + g;
  float* mine = xch + warp * P::kXchWords;
  const float* theirs = xch + (warp ^ 1) * P::kXchWords;
  const uint32_t bar = 1 + strip;   // the strip's named barrier (0: block)
  const float* qw = qs + (16 * strip + g) * P::kQK + 4 * t;
  const auto q_raw = [&](int j, uint32_t (&hi)[2][4], uint32_t (&lo)[2][4]) {
    const float4 qa = *reinterpret_cast<const float4*>(qw + 16 * j);
    const float4 qb =
        *reinterpret_cast<const float4*>(qw + 8 * P::kQK + 16 * j);
    // k-step s: a0 (row g), a1 (row g + 8) at column t; a2, a3 at t + 4
    const float a[2][4] = {{qa.x, qb.x, qa.y, qb.y}, {qa.z, qb.z, qa.w, qb.w}};
#pragma unroll
    for (int s = 0; s < 2; ++s)
#pragma unroll
      for (int i = 0; i < 4; ++i)
        hopper::split_tf32(a[s][i], hi[s][i], lo[s][i]);
  };
  float acc[P::kDvW / 8][4];
#pragma unroll
  for (int n = 0; n < P::kDvW / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};   // this thread's share of its keys' row sums

  for (int it = 0; it < bt.n_tiles; ++it) {
    const int k0 = (bt.n_first + it) * kBK;
    if (it + 1 < bt.n_tiles) {
      load_tile(it + 1);
      hopper::cp_async_commit();
      hopper::cp_async_wait<1>();   // this thread's copies of tile it
    } else {
      hopper::cp_async_wait<0>();
    }
    __syncthreads();                // everyone's copies of tile it
    const float* ks = ring + it % 2 * P::kStageFloats;
    // both warps of a strip take the same branch, and so the same barriers
    if (tile_live(w_lo, k0, kBK, S, bt.all, causal, window)) {
      const float* kw = ks + (kBK / 2 * half + g) * P::kQK + 4 * t;
      const auto k_raw = [&](int n, int j, uint32_t (&hi)[2][2],
                             uint32_t (&lo)[2][2]) {
        const float4 x = *reinterpret_cast<const float4*>(
            kw + 8 * n * P::kQK + 16 * j);
        hopper::split_tf32(x.x, hi[0][0], lo[0][0]);
        hopper::split_tf32(x.y, hi[0][1], lo[0][1]);
        hopper::split_tf32(x.z, hi[1][0], lo[1][0]);
        hopper::split_tf32(x.w, hi[1][1], lo[1][1]);
      };
      float sc[kHT][4];
      qk_tf32<kHT, D, P::kJU>(sc, q_raw, k_raw);
      float mx[2], alpha[2];
      scale_mask(sc, mx, row0, k0 + kBK / 2 * half, t, S, causal, window,
                 scale_log2, tile_edge(w_lo, k0, kBK, S, causal, window));
      *reinterpret_cast<float2*>(mine + 128 * kHT + 2 * lane) =
          make_float2(mx[0], mx[1]);
      hopper::named_bar_sync(bar, 64);
      const float2 other =
          *reinterpret_cast<const float2*>(theirs + 128 * kHT + 2 * lane);
      mx[0] = fmaxf(mx[0], other.x);
      mx[1] = fmaxf(mx[1], other.y);
      rescale(m, l, alpha, mx);
      exp_rows(sc, l, m);
#pragma unroll
      for (int n = 0; n < kHT; ++n)
        *reinterpret_cast<float4*>(mine + 128 * n + 4 * lane) =
            make_float4(sc[n][0], sc[n][1], sc[n][2], sc[n][3]);
      hopper::named_bar_sync(bar, 64);
      // the tile's whole P, split once: this warp's keys and the partner's
      // (a warp-uniform branch; indexing the fragments by ``half`` would
      // put them in local memory)
      uint32_t ph[kNT][4], pl[kNT][4];
#pragma unroll
      for (int n = 0; n < kNT; ++n) {
        if (n / kHT == half) {
          split_p(sc[n % kHT], ph[n], pl[n]);
        } else {
          const float4 x = *reinterpret_cast<const float4*>(
              theirs + 128 * (n % kHT) + 4 * lane);
          const float p[4] = {x.x, x.y, x.z, x.w};
          split_p(p, ph[n], pl[n]);
        }
      }
      // this warp's columns of O += P . V: V's key 2 t of the tile at
      // column g, split per use as the raw Q and K are
      const float* vw = ks + P::kKFloats + 2 * t * P::kV + g + P::kDvW * half;
      const auto v_raw = [&](int j, int tp, uint32_t (&hi)[2][2],
                             uint32_t (&lo)[2][2]) {
        // keys 8 j + 2 t (row t) and 8 j + 2 t + 1 (row t + 4)
        const float* c = vw + 8 * j * P::kV + 16 * tp;
        hopper::split_tf32(c[0], hi[0][0], lo[0][0]);
        hopper::split_tf32(c[P::kV], hi[0][1], lo[0][1]);
        hopper::split_tf32(c[8], hi[1][0], lo[1][0]);
        hopper::split_tf32(c[P::kV + 8], hi[1][1], lo[1][1]);
      };
      pv_tf32<P::kDvW / 8, kNT, P::kNB>(acc, ph, pl, v_raw, alpha);
    }
    __syncthreads();                // stage it % 2 may be refilled
  }
  // each warp's share of the row sums, then its partner's
  quad_sum(l);
  *reinterpret_cast<float2*>(mine + 128 * kHT + 2 * lane) =
      make_float2(l[0], l[1]);
  hopper::named_bar_sync(bar, 64);
  const float2 other =
      *reinterpret_cast<const float2*>(theirs + 128 * kHT + 2 * lane);
  l[0] += other.x;
  l[1] += other.y;
  store_o(o + (static_cast<size_t>(bt.bh) * S + row0) * DV + P::kDvW * half +
              2 * t,
          DV, acc, l, row0, S);
}

// Keys with query - key >= window are masked (S or more: no window); vec:
// q, k and v are 16-byte aligned.
template <int D, int DV>
__global__ void __launch_bounds__(F32Plan<D, DV>::kThreads, 1)
fa_kernel(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, float* __restrict__ o, int Hq,
          int KVH, int S, float scale_log2, int causal, int window,
          int vec) {
  if constexpr (F32Plan<D, DV>::kOnce)
    fa_once<D, DV>(q, k, v, o, Hq, KVH, S, scale_log2, causal, window, vec);
  else
    fa_pair<D, DV>(q, k, v, o, Hq, KVH, S, scale_log2, causal, window, vec);
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

// the f32 plan at head dims (D, DV) into out[10]: query rows a block, keys
// a KV tile, warps a 16-row strip, raw K/V stages, split stages, whether K
// and V are split once a block, the raw row strides (floats) of Q and K
// and of V, blocks of 16 columns of S in flight, and the dynamic shared
// memory a block takes. Returns 0, or -1 for a pair it does not take.
int fa_f32_plan(int D, int DV, int* out) {
#define FA_F32_PLAN(d, dv)                                                \
  if (D == d && DV == dv) {                                               \
    using P = F32Plan<d, dv>;                                             \
    const int plan[10] = {P::kBQ,    P::kBK,   P::kPair, P::kRaw,         \
                          P::kSplit, P::kOnce, P::kQK,   P::kV,           \
                          P::kJU,    P::kSmemBytes};                      \
    for (int i = 0; i < 10; ++i) out[i] = plan[i];                        \
    return 0;                                                             \
  }
  FA_PAIRS(FA_F32_PLAN)
#undef FA_F32_PLAN
  return -1;
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
