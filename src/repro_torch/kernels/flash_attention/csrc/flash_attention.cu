// Flash attention forward on Hopper (sm_90a): causal and/or sliding-window
// GQA attention with an online softmax. Two kernels, one function:
// fa_bf16_kernel takes bf16 inputs (tensor cores fed by TMA), fa_kernel
// takes f32 inputs (exact f32 FMAs).
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
// 0.019 ms. The f32 design below runs on the CUDA cores at 1/15 of that
// rate. What this design does about it:
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
// f32 inputs must meet 3e-5, so every product is an f32 FMA on the CUDA
// cores (no TF32); its ceiling is the 67 TFLOP/s f32 rate. What the design
// does:
//   * One block per (batch, head, 64-query tile), 128 threads. Each thread
//     owns a 4 x 8 patch of the 64 x 64 score tile (4 query rows, 8 keys)
//     and the same 4 rows x D/8 columns of the output, so each shared-memory
//     load of q, k, p or v feeds 2 to 4 FMAs.
//   * q and k are kept transposed in shared memory (stride 68 floats) so
//     the 4 rows and 8 keys a thread needs are two 16-byte loads; p goes
//     through shared memory to change owners between the two products.

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
constexpr int kBQ = 64;         // query rows per block
constexpr int kBK = 64;         // keys per KV tile
constexpr int kThreads = 128;   // 16 row groups x 8 key groups
constexpr int kPad = 68;        // row stride (floats) of transposed tiles

template <int D>
constexpr int smem_floats() {
  return 2 * D * kPad + kBK * D + kBK * kPad;
}

// grid: (ceil(S / kBQ), Hq, B). window <= 0 means no window.
template <int D>
__global__ void __launch_bounds__(kThreads)
fa_kernel(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, float* __restrict__ o, int Hq,
          int KVH, int S, float scale, int causal, int window) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* qT = smem;               // [D][kPad]   q tile * scale, transposed
  float* kT = qT + D * kPad;      // [D][kPad]   k tile, transposed
  float* vs = kT + D * kPad;      // [kBK][D]    v tile
  float* pT = vs + kBK * D;       // [kBK][kPad] probabilities, transposed
  constexpr int DT = D / 8;       // output columns per thread

  const int tid = threadIdx.x;
  const int ty = tid >> 3;        // rows ty*4 .. ty*4+3
  const int tx = tid & 7;         // keys tx*8 .. tx*8+7, columns tx*DT ..
  const int b = blockIdx.z, h = blockIdx.y;
  const int q0 = blockIdx.x * kBQ;
  const int hk = h / (Hq / KVH);
  const float* qb = q + (static_cast<size_t>(b) * Hq + h) * S * D;
  const float* kb = k + (static_cast<size_t>(b) * KVH + hk) * S * D;
  const float* vb = v + (static_cast<size_t>(b) * KVH + hk) * S * D;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, d = e % D;
    qT[d * kPad + r] =
        q0 + r < S ? qb[static_cast<size_t>(q0 + r) * D + d] * scale : 0.f;
  }

  // keys some row of [q0, q0 + kBQ) may see
  int k_lo = 0, k_hi = S;
  if (causal) k_hi = min(S, q0 + kBQ);
  if (window > 0) k_lo = max(0, q0 - window + 1);

  float m[4], l[4], acc[4][DT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DT; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = (k_lo / kBK) * kBK; k0 < k_hi; k0 += kBK) {
    __syncthreads();  // the q tile is in; the last tile's readers are done
    for (int e = tid; e < kBK * D; e += kThreads) {
      const int c = e / D, d = e % D;
      const bool in = k0 + c < S;
      const size_t off = static_cast<size_t>(k0 + c) * D + d;
      kT[d * kPad + c] = in ? kb[off] : 0.f;
      vs[c * D + d] = in ? vb[off] : 0.f;
    }
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float4 qa = *reinterpret_cast<const float4*>(qT + d * kPad + ty * 4);
      const float4 ka = *reinterpret_cast<const float4*>(kT + d * kPad + tx * 8);
      const float4 kc = *reinterpret_cast<const float4*>(kT + d * kPad + tx * 8 + 4);
      const float qq[4] = {qa.x, qa.y, qa.z, qa.w};
      const float kk[8] = {ka.x, ka.y, ka.z, ka.w, kc.x, kc.y, kc.z, kc.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qq[i], kk[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q0 + ty * 4 + i;
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kj = k0 + tx * 8 + j;
        const bool ok = kj < S && (!causal || qi >= kj) &&
                        (window <= 0 || qi - kj < window);
        s[i][j] = ok ? s[i][j] : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      // the row's 64 keys live in 8 neighbouring lanes
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        sum += s[i][j];
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      sum += __shfl_xor_sync(0xffffffffu, sum, 2);
      sum += __shfl_xor_sync(0xffffffffu, sum, 4);
      l[i] = l[i] * alpha + sum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DT; ++c) acc[i][c] *= alpha;
#pragma unroll
      for (int j = 0; j < 8; ++j) pT[(tx * 8 + j) * kPad + ty * 4 + i] = s[i][j];
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
      const float4 pa = *reinterpret_cast<const float4*>(pT + c * kPad + ty * 4);
      const float pp[4] = {pa.x, pa.y, pa.z, pa.w};
#pragma unroll
      for (int d4 = 0; d4 < DT; d4 += 4) {
        const float4 va = *reinterpret_cast<const float4*>(vs + c * D + tx * DT + d4);
        const float vv[4] = {va.x, va.y, va.z, va.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int t = 0; t < 4; ++t)
            acc[i][d4 + t] = fmaf(pp[i], vv[t], acc[i][d4 + t]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q0 + ty * 4 + i;
    if (qi >= S) continue;
    const float den = fmaxf(l[i], 1e-30f);
    float* orow = o + ((static_cast<size_t>(b) * Hq + h) * S + qi) * D + tx * DT;
#pragma unroll
    for (int c = 0; c < DT; ++c) orow[c] = acc[i][c] / den;
  }
}

template <int D>
int launch_f32(const void* q, const void* k, const void* v, void* o, int B,
               int Hq, int KVH, int S, float scale, int causal, int window,
               cudaStream_t stream) {
  const int bytes = smem_floats<D>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      fa_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBQ - 1) / kBQ, Hq, B);
  fa_kernel<D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), Hq, KVH, S, scale,
      causal, window);
  return static_cast<int>(cudaGetLastError());
}

// ----------------------------------------------------------- the bf16 path
namespace tc {

constexpr int kBQ = 128;         // query rows a block: 2 consumers x 64
constexpr int kBK = 128;         // keys a KV tile
constexpr int kThreads = 384;    // producer warpgroup + 2 consumers
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;
constexpr float kLog2e = 1.4426950408889634f;

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
// on the device, f32 (dtype 0) or bf16 (dtype 1; every pointer 16-byte
// aligned). D in {32, 64, 128}; Hq % KVH == 0; window <= 0 for none.
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
