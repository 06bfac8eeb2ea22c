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
// Head h reads KV head h / (Hq / KVH): GQA is an index, KV is never
// repeated in memory. Both kernels visit only the KV tiles that hold a key
// some row of the query tile may see (below the diagonal when causal,
// inside the band with a window); the Pallas kernel streams every tile and
// masks. Masked scores are -1e30, never -inf: a row whose first visited
// tile is wholly masked sums exp(0) = 1 over garbage there, and the first
// tile that holds a real key wipes it with alpha = exp(-1e30 - m) = 0, as
// the Pallas kernel does. Keys and queries past S read as zero and are
// masked; rows past S are not written.
//
// ---- fa_bf16_kernel, the bf16 path.
//
// Bound: operations, 4 D flops per unmasked (query, key) pair over the
// 989 TFLOP/s of the bf16 tensor cores. At yi-6b's attention (B 1, Hq 32,
// KV 4, S 4096, D 128, causal) that is 137.5 GFLOP, 0.139 ms, against
// 0.014 ms for its 46 MB of q, k, v and o; at hymba-1.5b's prefill (B 2,
// Hq 25, KV 5, S 4096, D 64, window 2048) 80.5 GFLOP, 0.081 ms, against
// 0.019 ms. (The f32 design below takes three TF32 products, each at half
// that rate, for each product.) What this design does about it:
//   * Both products are wgmma (bf16 x bf16 -> f32, m64nNk16). A block is
//     128 query rows and three warpgroups: one producer, two consumers of
//     64 rows each. S = Q.K^T is m64n128 over a 128-key tile with Q and K
//     read from shared memory. P is rounded to bf16 in registers: the f32
//     accumulator's fragment is, pair by pair, the A fragment of the next
//     wgmma, so P never touches shared memory. O += P.V reads V in its
//     natural keys x D layout through the transpose bit (MN-major B).
//   * The scale multiplies the f32 scores after the product (q is never
//     rounded as q * scale); log2(e) is folded into it and exp2f used.
//   * One producer thread keeps K and V tiles coming by TMA
//     (cp.async.bulk.tensor) into a ring of 3 (D 128) or 4 (D 32, 64)
//     stages, each with a "full" mbarrier (transaction bytes) and an
//     "empty" one (one arrival per consumer warp). Tile j + 1 is in flight
//     while tile j's products run. setmaxnreg gives the producer 40
//     registers and the consumers 232.
//   * Inside a consumer, tile j's softmax runs while the tensor cores do
//     P.V of tile j - 1 (issued together with S of tile j), so a tile's
//     stage is released one tile later: hence 3 stages at D 128, where 2
//     would expose each load.
//   * The tensor maps are 3-D (D, S, B * heads): a ragged last tile is
//     zero-filled at S, never read from the next head. Rows of 128 bytes
//     (D 64, and D 128 as two 64-column boxes) use the 128-byte swizzle,
//     D 32's 64-byte rows the 64-byte one, in both the map and the wgmma
//     descriptor; tiles are 1024-byte aligned.
//   * The online softmax stays in registers: a row lives in the 4 threads
//     of a quad (two shuffles), each thread keeps a partial row sum, and
//     the quad adds them once at the end.
//   * Query tiles launch heaviest first (the last tile of every head in
//     the first wave), so the causal tail does not idle the last wave.
//   Shared memory: 128 x D x 2 B of Q plus 2 x 128 x D x 2 B a stage:
//   72 KB at D 32, 144 KB at D 64, 224 KB at D 128, plus 1 KB for
//   alignment and the barriers. One block (384 threads) a SM.
//
// ---- fa_kernel, the f32 path.
//
// f32 inputs must meet 3e-5, which one TF32 product (10 mantissa bits)
// does not. Both products run on the tensor cores all the same, error-
// compensated (3xTF32): each f32 operand x is split into hi = tf32(x) and
// lo = tf32(x - hi), both rounded to nearest with ties away as cvt.rna
// rounds (hopper::to_tf32), and a product a.b is taken as hi_a.hi_b +
// hi_a.lo_b + lo_a.hi_b with f32 accumulation; lo_a.lo_b (2^-22 of a.b)
// is dropped. So the f32 bound is operations: 4 D flops per unmasked
// pair, three TF32 products each, over the 495 TFLOP/s of the TF32 tensor
// cores (yi-6b's shape: 3 x 137.5 GFLOP, 0.833 ms; 2.052 ms at the CUDA
// cores' 67 TFLOP/s, the ceiling of the FMA design this one replaced).
// The accuracy does not depend on torch's allow_tf32 switch: the split is
// in the kernel. What the design does:
//   * mma.sync.m16n8k8 (tf32 x tf32 -> f32), not wgmma: for 32-bit types
//     wgmma takes both operands K-major only, so P.V would need V
//     transposed in shared memory; mma.sync reads B fragments with plain
//     32-bit shared loads.
//   * A block is 128 query rows in 8 warps of 16 rows (256 threads), over
//     KV tiles of 64 keys: 8 warps a SM at D 128, against the FMA
//     design's 4. A
//     warp's S (16 x 64) and O (16 x D) accumulators stay in registers.
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
//     fall on 32 distinct banks), D + 4 for V (rows 2 t and 2 t + 1 at
//     column g fall on bank 8 t + g).
//   * The 3 products of each fragment go term by term over 4 (S) or 8
//     (P.V) independent accumulators, so no mma waits on the one before.
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
//     spill).
//   Shared memory: 215,040 B at D 128, 116,736 at D 64, 67,584 at D 32;
//   one block a SM. Registers: 254 / 175 / 161 a thread, no spills.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float kNegInf = -1e30f;

// error codes of this library, beside cudaError_t's
constexpr int kErrNoEncoder = 20001;   // cuTensorMapEncodeTiled not found
constexpr int kErrEncode = 20002;      // cuTensorMapEncodeTiled refused
constexpr int kErrAlign = 20003;       // a pointer off a 16-byte boundary

// ------------------------------------------------------------ the f32 path
constexpr int kBQ = 128;        // query rows a block: 8 warps x 16
constexpr int kBK = 64;         // keys a KV tile
constexpr int kThreads = 256;
constexpr int kStages = 2;      // the K/V ring
constexpr float kLog2e = 1.4426950408889634f;

// the f32 tile plan for head dim D (ops.py::f32_tile_plan mirrors it)
template <int D>
struct F32Plan {
  static constexpr int kQK = D + 16;   // row stride (floats) of Q and K
  static constexpr int kV = D + 4;     // row stride of V
  static constexpr int kQFloats = kBQ * kQK;
  static constexpr int kKFloats = kBK * kQK;
  static constexpr int kStageFloats = kKFloats + kBK * kV;
  static constexpr int kSmemBytes =
      (kQFloats + kStages * kStageFloats) * static_cast<int>(sizeof(float));
};

// rows [r0, r0 + ROWS) of a contiguous (S, D) f32 matrix into shared
// memory at row stride ``stride``, by cp.async; rows past S read as zero
// (their source clamped to row 0, which is not read). A thread copies the
// same columns of every (kThreads / (D / 4))-th row, so its addresses are
// one base and constant offsets.
template <int D, int ROWS>
__device__ __forceinline__ void load_rows(float* dst, int stride,
                                          const float* src, int r0, int S,
                                          bool vec) {
  static_assert(ROWS * D % (4 * kThreads) == 0, "whole rounds of copies");
  if (vec) {
    constexpr int kStep = kThreads / (D / 4);   // rows a round
    const int r = r0 + threadIdx.x / (D / 4), c = threadIdx.x % (D / 4) * 4;
    float* d = dst + (r - r0) * stride + c;
    const float* g = src + static_cast<size_t>(r) * D + c;
#pragma unroll
    for (int i = 0; i < ROWS / kStep; ++i) {
      const bool in = r + i * kStep < S;
      hopper::cp_async16(d + i * kStep * stride,
                         in ? g + i * kStep * D : src, in ? 16 : 0);
    }
  } else {
    constexpr int kStep = kThreads / D;
    const int r = r0 + threadIdx.x / D, c = threadIdx.x % D;
    float* d = dst + (r - r0) * stride + c;
    const float* g = src + static_cast<size_t>(r) * D + c;
    for (int i = 0; i < ROWS / kStep; ++i) {
      const bool in = r + i * kStep < S;
      hopper::cp_async4(d + i * kStep * stride, in ? g + i * kStep * D : src,
                        in ? 4 : 0);
    }
  }
}

// S (16 x 64) = Q (16 x D) . K^T (D x 64). q: Q's row g (row g + 8 is
// 8 rows on), k: K's key g of the tile, both at column 4 t. Each 16
// columns of D are summed from zero on the tensor cores, whose adder
// truncates, and added to S by the f32 ALU, which rounds to nearest; the
// keys go in two halves of 32 (4 accumulators each) to keep the registers
// in hand, Q's fragments split once for both.
template <int D>
__device__ __forceinline__ void qk_f32(float (&sc)[8][4], const float* q,
                                       const float* k) {
  using P = F32Plan<D>;
#pragma unroll
  for (int n = 0; n < 8; ++n)
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
    for (int h = 0; h < 2; ++h) {
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

// O (16 x D) = alpha O + P (16 x 64) . V (64 x D). p: the softmax of the
// S accumulator, in place; v: V's key 2 t of the tile at column g; alpha:
// the rescale of rows g and g + 8. The tile's product is summed from zero
// on the tensor cores, 8 output tiles at a time, and added to O by the
// f32 ALU, so the truncating adder never carries O across tiles.
template <int D>
__device__ __forceinline__ void pv_f32(float (&acc)[D / 8][4],
                                       const float (&p)[8][4],
                                       const float* v,
                                       const float (&alpha)[2]) {
  using P = F32Plan<D>;
  constexpr int NB = D / 8 < 8 ? D / 8 : 8;   // output tiles a batch
#pragma unroll
  for (int n0 = 0; n0 < D / 8; n0 += NB) {
    float part[NB][4];
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) part[n][e] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
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
// window <= 0 means no window; vec: q, k and v are 16-byte aligned.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
fa_kernel(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, float* __restrict__ o, int Hq,
          int KVH, int S, float scale_log2, int causal, int window,
          int vec) {
  using P = F32Plan<D>;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);   // [kBQ][kQK]
  float* ring = qs + P::kQFloats;   // kStages x {K [kBK][kQK], V [kBK][kV]}

  const int bh = blockIdx.x;
  const int b = bh / Hq;
  const int kvh = b * KVH + (bh % Hq) / (Hq / KVH);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  const float* qb = q + static_cast<size_t>(bh) * S * D;
  const float* kb = k + static_cast<size_t>(kvh) * S * D;
  const float* vb = v + static_cast<size_t>(kvh) * S * D;
  // the KV tiles holding a key some row of [q0, q0 + kBQ) may see
  int k_lo = 0, k_hi = S;
  if (causal) k_hi = min(S, q0 + kBQ);
  if (window > 0) k_lo = max(0, q0 - window + 1);
  const int n_first = k_lo / kBK;
  const int n_tiles = (k_hi + kBK - 1) / kBK - n_first;

  load_rows<D, kBQ>(qs, P::kQK, qb, q0, S, vec);
  load_rows<D, kBK>(ring, P::kQK, kb, n_first * kBK, S, vec);
  load_rows<D, kBK>(ring + P::kKFloats, P::kV, vb, n_first * kBK, S, vec);
  hopper::cp_async_commit();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;
  const int w_lo = q0 + 16 * warp, w_hi = w_lo + 15;   // the warp's rows
  const int row0 = w_lo + g;                           // and row0 + 8

  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};   // this thread's share of the row sums

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = (n_first + it) * kBK;
    if (it + 1 < n_tiles) {
      float* next = ring + (it + 1) % kStages * P::kStageFloats;
      load_rows<D, kBK>(next, P::kQK, kb, k0 + kBK, S, vec);
      load_rows<D, kBK>(next + P::kKFloats, P::kV, vb, k0 + kBK, S, vec);
      hopper::cp_async_commit();
      hopper::cp_async_wait<1>();   // this thread's copies of tile it
    } else {
      hopper::cp_async_wait<0>();
    }
    __syncthreads();                // everyone's copies of tile it
    const float* ks = ring + it % kStages * P::kStageFloats;
    const float* vs = ks + P::kKFloats;
    const bool live = w_lo < S && !(causal && k0 > w_hi) &&
                      !(window > 0 && w_lo - (k0 + kBK - 1) >= window);
    if (live) {
      float sc[8][4];
      qk_f32<D>(sc, qs + (16 * warp + g) * P::kQK + 4 * t,
                ks + g * P::kQK + 4 * t);
      // scale, mask, and the online softmax of rows row0 (e < 2) and
      // row0 + 8 (e >= 2), each spread over the 4 threads of a quad
      const bool edge = k0 + kBK > S || (causal && k0 + kBK - 1 > w_lo) ||
                        (window > 0 && w_hi - k0 >= window);
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float s = sc[n][e] * scale_log2;
          if (edge) {
            const int qi = row0 + 8 * (e >> 1);
            const int kj = k0 + 8 * n + 2 * t + (e & 1);
            const bool ok = kj < S && (!causal || qi >= kj) &&
                            (window <= 0 || qi - kj < window);
            s = ok ? s : kNegInf;
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
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sc[n][e] = hopper::exp2_ftz(sc[n][e] - m[e >> 1]);
          l[e >> 1] += sc[n][e];
        }
      pv_f32<D>(acc, sc, vs + 2 * t * P::kV + g, alpha);
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
    float* orow = o + (static_cast<size_t>(bh) * S + qi) * D + 2 * t;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<float2*>(orow + 8 * n) =
          make_float2(acc[n][2 * r] / den, acc[n][2 * r + 1] / den);
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o, int B,
               int Hq, int KVH, int S, float scale, int causal, int window,
               cudaStream_t stream) {
  const int bytes = F32Plan<D>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(
      fa_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int vec = (reinterpret_cast<uintptr_t>(q) |
                   reinterpret_cast<uintptr_t>(k) |
                   reinterpret_cast<uintptr_t>(v)) % 16 == 0;
  const dim3 grid(B * Hq, (S + kBQ - 1) / kBQ);
  fa_kernel<D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Hq, KVH, S,
      scale * kLog2e, causal, window, vec);
  return static_cast<int>(cudaGetLastError());
}

// ----------------------------------------------------------- the bf16 path
namespace tc {

constexpr int kBQ = 128;         // query rows a block: 2 consumers x 64
constexpr int kBK = 128;         // keys a KV tile
constexpr int kThreads = 384;    // producer warpgroup + 2 consumers
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

// the tile plan for head dim D (ops.py::tile_plan mirrors it)
template <int D>
struct Plan {
  static constexpr int kRowBytes = D == 32 ? 64 : 128;  // a swizzled box row
  static constexpr int kBoxCols = kRowBytes / 2;
  static constexpr int kBoxes = D / kBoxCols;   // column boxes: 2 at D 128
  static constexpr uint32_t kMode = D == 32 ? 2 : 1;   // 64 B / 128 B swizzle
  static constexpr int kStages = D == 128 ? 3 : 4;
  static constexpr int kBoxBytes = kBK * kRowBytes;  // 128 rows of one box
  static constexpr int kQBytes = kBQ * D * 2;
  static constexpr int kTileBytes = kBK * D * 2;     // one K or V tile
  static constexpr int kBarOffset = kQBytes + kStages * 2 * kTileBytes;
  // + the barriers, + slack to align the base to 1024 bytes
  static constexpr int kSmemBytes = kBarOffset + 8 * (2 * kStages + 1) + 1024;
};

// shared-memory address of ring stage s's K tile (its V tile follows)
template <int D>
__device__ __forceinline__ uint32_t k_tile(uint32_t q_s, int s) {
  return q_s + Plan<D>::kQBytes + s * 2 * Plan<D>::kTileBytes;
}

// S = Q . K^T (64 x 128) over D in steps of 16: 32 bytes along a swizzled
// row, then (D 128) on to the second column box
template <int D>
__device__ __forceinline__ void qk_mma(float (&sc)[64], uint32_t q,
                                       uint32_t k) {
  using P = Plan<D>;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    const uint32_t off = kk * 16 / P::kBoxCols * P::kBoxBytes +
                         (kk * 16 % P::kBoxCols) * 2;
    hopper::wgmma_ss_m64n128(
        sc, hopper::make_desc(q + off, 16, 8 * P::kRowBytes, P::kMode),
        hopper::make_desc(k + off, 16, 8 * P::kRowBytes, P::kMode), kk > 0);
  }
}

// O += P . V over the tile's 128 keys in steps of 16. V is the MN-major B
// operand: 16 rows a step, 8-row groups 8 rows apart (SBO) and, at D 128,
// its two column boxes one box apart (LBO).
template <int D>
__device__ __forceinline__ void pv_mma(float (&acc)[D / 2],
                                       const uint32_t (&p)[kBK / 16][4],
                                       uint32_t v) {
  using P = Plan<D>;
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk) {
    const uint64_t b = hopper::make_desc(v + kk * 16 * P::kRowBytes,
                                         P::kBoxBytes, 8 * P::kRowBytes,
                                         P::kMode);
    if constexpr (D == 32) hopper::wgmma_rs_m64n32(acc, p[kk], b, 1);
    if constexpr (D == 64) hopper::wgmma_rs_m64n64(acc, p[kk], b, 1);
    if constexpr (D == 128) hopper::wgmma_rs_m64n128(acc, p[kk], b, 1);
  }
}

// what a consumer thread needs to mask its scores: its rows row0 and
// row0 + 8, its warpgroup's first and last row, its column offset in each
// 8-key group
struct Rows {
  int row0, lo, hi, col, S, causal, window;
  float scale_log2;
};

// One tile's online softmax on the 64 x 128 scores of a warpgroup, in
// place: sc[4 i + e] (row row0 + 8 (e >> 1), key k0 + 8 i + col + (e & 1))
// becomes p = exp2(s * scale_log2 - m_new) in f32, m and this thread's
// share of l move on, and alpha = exp2(m_old - m_new) is returned for O.
__device__ __forceinline__ void online_softmax(float (&sc)[64], float (&m)[2],
                                               float (&l)[2],
                                               float (&alpha)[2],
                                               const Rows& w, int k0) {
  // a tile that may hold masked entries (or a scale whose sign would turn
  // the row max around) is scaled and masked first
  const bool edge = k0 + kBK > w.S || (w.causal && k0 + kBK - 1 > w.lo) ||
                    (w.window > 0 && w.hi - k0 >= w.window) ||
                    !(w.scale_log2 > 0.f);
  float mx[2] = {kNegInf, kNegInf};
  if (edge) {
#pragma unroll
    for (int i = 0; i < 16; ++i) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qi = w.row0 + 8 * (e >> 1);
        const int kj = k0 + 8 * i + w.col + (e & 1);
        const bool ok = kj < w.S && (!w.causal || qi >= kj) &&
                        (w.window <= 0 || qi - kj < w.window);
        sc[4 * i + e] = ok ? sc[4 * i + e] * w.scale_log2 : kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], sc[4 * i + e]);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < 64; ++i)
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
  for (int i = 0; i < 64; ++i) {
    const int r = (i >> 1) & 1;
    sc[i] = hopper::exp2_ftz(fmaf(sc[i], mul, neg_m[r]));
    l[r] += sc[i];
  }
}

// p in bf16, already in the A-fragment order of the P.V wgmma: for keys
// 16 kk .. 16 kk + 15, the scores sc[8 kk .. 8 kk + 7] in pairs
__device__ __forceinline__ void to_bf16(const float (&sc)[64],
                                        uint32_t (&p)[kBK / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < kBK / 16; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j)
      p[kk][j] = hopper::pack_bf16(sc[8 * kk + 2 * j], sc[8 * kk + 2 * j + 1]);
}

// grid: (B * Hq, ceil(S / kBQ)), query tiles in reverse (heaviest first).
// Maps: q (D, S, B * Hq), k and v (D, S, B * KVH), boxes of
// (kBoxCols, 128, 1). window <= 0 means no window.
template <int D>
__global__ void __launch_bounds__(kThreads, 1)
fa_bf16_kernel(const __grid_constant__ CUtensorMap q_map,
               const __grid_constant__ CUtensorMap k_map,
               const __grid_constant__ CUtensorMap v_map,
               __nv_bfloat16* __restrict__ o, int Hq, int KVH, int S,
               float scale_log2, int causal, int window) {
  using P = Plan<D>;
  using namespace hopper;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t q_s = (smem_addr(smem_raw) + 1023u) & ~1023u;
  const uint32_t bars = q_s + P::kBarOffset;
  // full[s] at bars + 8 s, empty[s] at bars + 8 (kStages + s), then q_full
  const uint32_t q_full = bars + 16 * P::kStages;

  const int bh = blockIdx.x;
  const int b = bh / Hq;
  const int kvh = b * KVH + (bh % Hq) / (Hq / KVH);
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kBQ;
  // the KV tiles holding a key some row of [q0, q0 + kBQ) may see
  int k_lo = 0, k_hi = S;
  if (causal) k_hi = min(S, q0 + kBQ);
  if (window > 0) k_lo = max(0, q0 - window + 1);
  const int n_first = k_lo / kBK, n_end = (k_hi + kBK - 1) / kBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < P::kStages; ++s) {
      mbar_init(bars + 8 * s, 1);
      mbar_init(bars + 8 * (P::kStages + s), 8);   // the 8 consumer warps
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
      for (int c = 0; c < P::kBoxes; ++c)
        tma_load_3d(q_s + c * P::kBoxBytes, &q_map, q_full,
                    c * P::kBoxCols, q0, bh);
      for (int n = n_first, it = 0; n < n_end; ++n, ++it) {
        const int s = it % P::kStages;
        const uint32_t full = bars + 8 * s;
        const uint32_t k_s = k_tile<D>(q_s, s), v_s = k_s + P::kTileBytes;
        // the ring's first revolution finds every stage empty
        mbar_wait(bars + 8 * (P::kStages + s), ((it / P::kStages) & 1) ^ 1);
        mbar_arrive_expect_tx(full, 2 * P::kTileBytes);
        for (int c = 0; c < P::kBoxes; ++c) {
          tma_load_3d(k_s + c * P::kBoxBytes, &k_map, full, c * P::kBoxCols,
                      n * kBK, kvh);
          tma_load_3d(v_s + c * P::kBoxBytes, &v_map, full, c * P::kBoxCols,
                      n * kBK, kvh);
        }
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

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};   // this thread's share of the row sums
  float alpha[2];
  float sc[64];
  uint32_t p[kBK / 16][4];

  mbar_wait(q_full, 0);
  mbar_wait(bars, 0);
  __syncwarp();
  fence_regs(sc);
  wgmma_fence();
  qk_mma<D>(sc, q_wg, k_tile<D>(q_s, 0));
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(sc);
  online_softmax(sc, m, l, alpha, rows, n_first * kBK);
  to_bf16(sc, p);
  for (int it = 1; it < n_tiles; ++it) {
    const int s = it % P::kStages, prev = (it - 1) % P::kStages;
    mbar_wait(bars + 8 * s, (it / P::kStages) & 1);
    __syncwarp();
    fence_regs(sc);
    fence_regs(acc);
    wgmma_fence();
    qk_mma<D>(sc, q_wg, k_tile<D>(q_s, s));
    wgmma_commit();
    pv_mma<D>(acc, p, k_tile<D>(q_s, prev) + P::kTileBytes);
    wgmma_commit();
    wgmma_wait<1>();   // S of tile it is in; P.V of tile it - 1 runs on
    fence_regs(sc);
    online_softmax(sc, m, l, alpha, rows, (n_first + it) * kBK);
    wgmma_wait<0>();
    fence_regs(acc);
    __syncwarp();
    if (lane == 0) mbar_arrive(bars + 8 * (P::kStages + prev));
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i >> 1) & 1];
    to_bf16(sc, p);
  }
  const int last = (n_tiles - 1) % P::kStages;
  fence_regs(acc);
  wgmma_fence();
  pv_mma<D>(acc, p, k_tile<D>(q_s, last) + P::kTileBytes);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);

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
        o + (static_cast<size_t>(bh) * S + qi) * D + rows.col);
#pragma unroll
    for (int i = 0; i < D / 8; ++i)
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

// a (D, S, heads) bf16 tensor, boxes of (box_cols, 128, 1)
template <int D>
int make_map(CUtensorMap* map, const void* ptr, int S, int heads) {
  using P = Plan<D>;
  const EncodeTiled encode = encoder();
  if (encode == nullptr) return kErrNoEncoder;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(heads)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2,
                                 static_cast<cuuint64_t>(S) * D * 2};
  const cuuint32_t box[3] = {P::kBoxCols, kBK, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult res = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
      strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
      D == 32 ? CU_TENSOR_MAP_SWIZZLE_64B : CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kErrEncode;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Hq, int KVH, int S, float scale, int causal, int window,
           cudaStream_t stream) {
  CUtensorMap q_map, k_map, v_map;
  int err = make_map<D>(&q_map, q, S, B * Hq);
  if (!err) err = make_map<D>(&k_map, k, S, B * KVH);
  if (!err) err = make_map<D>(&v_map, v, S, B * KVH);
  if (err) return err;
  const int bytes = Plan<D>::kSmemBytes;
  const cudaError_t attr = cudaFuncSetAttribute(
      fa_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (attr != cudaSuccess) return static_cast<int>(attr);
  const dim3 grid(B * Hq, (S + kBQ - 1) / kBQ);
  fa_bf16_kernel<D><<<grid, kThreads, bytes, stream>>>(
      q_map, k_map, v_map, static_cast<__nv_bfloat16*>(o), Hq, KVH, S,
      scale * kLog2e, causal, window);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

}  // namespace

extern "C" {

// q: (B, Hq, S, D), k/v: (B, KVH, S, D), o: (B, Hq, S, D), all contiguous
// on the device, f32 (dtype 0; any alignment) or bf16 (dtype 1; every
// pointer 16-byte aligned). D in {32, 64, 128}; Hq % KVH == 0; window <= 0
// for none.
// Returns cudaGetLastError() after the launch, or the error that stopped
// it (see fa_error_string).
int fa_launch(const void* q, const void* k, const void* v, void* o,
              int dtype, int B, int Hq, int KVH, int S, int D, float scale,
              int causal, int window, void* stream) {
  if (B <= 0 || S <= 0 || KVH <= 0 || Hq % KVH != 0 || Hq > 65535 ||
      B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if ((S + kBQ - 1) / kBQ > 65535)   // grid.y: query tiles
      return static_cast<int>(cudaErrorInvalidValue);
    switch (D) {
      case 32: return launch_f32<32>(q, k, v, o, B, Hq, KVH, S, scale, causal, window, st);
      case 64: return launch_f32<64>(q, k, v, o, B, Hq, KVH, S, scale, causal, window, st);
      case 128: return launch_f32<128>(q, k, v, o, B, Hq, KVH, S, scale, causal, window, st);
    }
  } else if (dtype == 1) {
    if ((S + tc::kBQ - 1) / tc::kBQ > 65535)   // grid.y: query tiles
      return static_cast<int>(cudaErrorInvalidValue);
    if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
         reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) % 16)
      return kErrAlign;
    switch (D) {
      case 32: return tc::launch<32>(q, k, v, o, B, Hq, KVH, S, scale, causal, window, st);
      case 64: return tc::launch<64>(q, k, v, o, B, Hq, KVH, S, scale, causal, window, st);
      case 128: return tc::launch<128>(q, k, v, o, B, Hq, KVH, S, scale, causal, window, st);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// dynamic shared memory an f32 block takes at head dim D (0 if none)
int fa_f32_smem_bytes(int D) {
  switch (D) {
    case 32: return F32Plan<32>::kSmemBytes;
    case 64: return F32Plan<64>::kSmemBytes;
    case 128: return F32Plan<128>::kSmemBytes;
  }
  return 0;
}

// dynamic shared memory a bf16 block takes at head dim D (0 if none)
int fa_bf16_smem_bytes(int D) {
  switch (D) {
    case 32: return tc::Plan<32>::kSmemBytes;
    case 64: return tc::Plan<64>::kSmemBytes;
    case 128: return tc::Plan<128>::kSmemBytes;
  }
  return 0;
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
