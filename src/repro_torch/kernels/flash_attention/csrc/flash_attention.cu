// Flash attention forward on Hopper (sm_90a): causal and/or sliding-window
// GQA attention with an online softmax.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_attention/kernel.py
// (_fa_kernel, launched by flash_attention_fwd). Same function:
//
//   s = (q * scale) . k^T in f32; entries outside the mask (causal: key >
//   query; window: query - key >= window) are set to -1e30; the softmax
//   over keys is taken online, block by block (m, l, acc in f32), and the
//   output is acc / max(l, 1e-30), cast to q's type.
//
// Head h reads KV head h / (Hq / KVH): GQA is an index, KV is never
// repeated in memory.
//
// Bound: operations. At hymba-1.5b's prefill (B 2, Hq 25, S 4096, D 64,
// window 2048) the unmasked (query, key) pairs need 80.5 GFLOP against
// 62.9 MB of q, k, v and o: 0.081 ms on the bf16 tensor cores, 0.019 ms of
// HBM traffic. This first kernel is the simple, exact one: every product
// is an f32 FMA on the CUDA cores (f32 inputs must not round through TF32;
// bf16 inputs are widened exactly), so its own ceiling is the 67 TFLOP/s
// f32 rate, 1.2 ms at that shape. What the design does:
//   * One block per (batch, head, 64-query tile), 128 threads. Each thread
//     owns a 4 x 8 patch of the 64 x 64 score tile (4 query rows, 8 keys)
//     and the same 4 rows x D/8 columns of the output, so each shared-memory
//     load of q, k, p or v feeds 2 to 4 FMAs.
//   * The KV loop visits only the tiles that hold a key some row of the
//     tile may see: below the diagonal when causal, inside the band with a
//     window. The Pallas kernel streams every tile and masks; skipping
//     gives the same result and, with a window, O(S * window) work.
//   * q and k are kept transposed in shared memory (stride 68 floats) so
//     the 4 rows and 8 keys a thread needs are two 16-byte loads; p goes
//     through shared memory to change owners between the two products.
//   * Masked scores are -1e30, never -inf: a row whose first tile is
//     wholly masked then sums exp(0) = 1 over garbage, and the first tile
//     that holds a real key wipes it with alpha = exp(-1e30 - m) = 0, as
//     the Pallas kernel does. Keys and queries past S (a ragged last tile)
//     read as zero and are masked; rows past S are not written.
// The tensor-core (wgmma) redesign is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBQ = 64;         // query rows per block
constexpr int kBK = 64;         // keys per KV tile
constexpr int kThreads = 128;   // 16 row groups x 8 key groups
constexpr int kPad = 68;        // row stride (floats) of transposed tiles
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

template <int D>
constexpr int smem_floats() {
  return 2 * D * kPad + kBK * D + kBK * kPad;
}

// grid: (ceil(S / kBQ), Hq, B). window <= 0 means no window.
template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
fa_kernel(const T* __restrict__ q, const T* __restrict__ k,
          const T* __restrict__ v, T* __restrict__ o, int Hq, int KVH, int S,
          float scale, int causal, int window) {
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
  const T* qb = q + (static_cast<size_t>(b) * Hq + h) * S * D;
  const T* kb = k + (static_cast<size_t>(b) * KVH + hk) * S * D;
  const T* vb = v + (static_cast<size_t>(b) * KVH + hk) * S * D;

  for (int e = tid; e < kBQ * D; e += kThreads) {
    const int r = e / D, d = e % D;
    qT[d * kPad + r] =
        q0 + r < S ? widen(qb[static_cast<size_t>(q0 + r) * D + d]) * scale
                   : 0.f;
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
      kT[d * kPad + c] = in ? widen(kb[off]) : 0.f;
      vs[c * D + d] = in ? widen(vb[off]) : 0.f;
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
    T* orow = o + ((static_cast<size_t>(b) * Hq + h) * S + qi) * D + tx * DT;
#pragma unroll
    for (int c = 0; c < DT; ++c) put(orow + c, acc[i][c] / den);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Hq, int KVH, int S, float scale, int causal, int window,
           cudaStream_t stream) {
  const int bytes = smem_floats<D>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      fa_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBQ - 1) / kBQ, Hq, B);
  fa_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Hq, KVH, S, scale, causal,
      window);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_d(const void* q, const void* k, const void* v, void* o, int B,
             int Hq, int KVH, int S, int D, float scale, int causal,
             int window, cudaStream_t stream) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, o, B, Hq, KVH, S, scale, causal, window, stream);
    case 64: return launch<T, 64>(q, k, v, o, B, Hq, KVH, S, scale, causal, window, stream);
    case 128: return launch<T, 128>(q, k, v, o, B, Hq, KVH, S, scale, causal, window, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// q: (B, Hq, S, D), k/v: (B, KVH, S, D), o: (B, Hq, S, D), all contiguous
// on the device, f32 (dtype 0) or bf16 (dtype 1). D in {32, 64, 128};
// Hq % KVH == 0; window <= 0 for none. Returns cudaGetLastError() after the
// launch (or the error that stopped it).
int fa_launch(const void* q, const void* k, const void* v, void* o,
              int dtype, int B, int Hq, int KVH, int S, int D, float scale,
              int causal, int window, void* stream) {
  if (B <= 0 || S <= 0 || KVH <= 0 || Hq % KVH != 0 || Hq > 65535 ||
      B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_d<float>(q, k, v, o, B, Hq, KVH, S, D, scale, causal, window, st);
  if (dtype == 1)
    return launch_d<__nv_bfloat16>(q, k, v, o, B, Hq, KVH, S, D, scale, causal, window, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* fa_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
