// Mamba-2 SSD chunked scan on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/ssd_scan/kernel.py
// (_ssd_kernel, launched by ssd_scan). Same function: for each (batch,
// head) the sequence is cut into chunks of Q steps and, with the (P, N)
// state h carried from chunk to chunk (zero at the start),
//
//   L      = cumsum(dt * A) within the chunk
//   scores = (C . B^T) * exp(L_i - L_j) * dt_j   for i >= j, else 0
//   y      = scores . x + (C * exp(L)) . h^T + D * x        (x's type)
//   h     <- exp(L_last) * h + x^T . (B * exp(L_last - L) * dt)
//
// and the final h is returned in f32. Head h reads B/C group h / (H / G).
//
// Bound: bytes. At hymba-1.5b's prefill (B 2, S 4096, H 25, P 64, G 1,
// N 16, bf16) the kernel must read x, dt, B, C and write y and h: 54 MB,
// 0.016 ms at 3.35 TB/s, against 5 GFLOP of f32 work (0.075 ms at the
// 67 TFLOP/s f32 CUDA-core rate, so the f32 products, not the bytes, are
// this kernel's own ceiling). What the design does:
//   * The TPU grid (B, H, chunks) runs its chunk axis in order; here the
//     chunk loop is inside the block, and the state never leaves shared
//     memory between chunks.
//   * B * H is 50 at hymba's shapes, under the card's 132 SMs. Each row p
//     of the state evolves on its own, so the block also owns a tile of P
//     (16 rows): grid (P / 16, H, B) fills the card with no communication
//     between blocks. Each block recomputes L and C . B^T for its tile.
//   * exp is taken only for i >= j: above the diagonal L_i - L_j > 0 and
//     exp may overflow to inf, and inf * 0 would be NaN.
//   * Every product is an f32 FMA on the CUDA cores, with IEEE expf (no
//     fast math): the f32 result must match the plain version to 2e-5.
//   * Any S: the last chunk may be short; its missing steps read as zero.
// Shared memory holds B^T, C, the Q x Q scores, the x tile and the state:
// 215 KB at N 128, Q 128 (the wrapper halves Q if a larger N needs it).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kQMax = 128;    // the warp scan below covers 4 steps a lane

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// grid: (ceil(P / PT), H, B)
template <typename T>
__global__ void __launch_bounds__(kThreads)
ssd_kernel(const T* __restrict__ x, const float* __restrict__ dt,
           const float* __restrict__ A, const T* __restrict__ Bm,
           const T* __restrict__ Cm, const float* __restrict__ Dv,
           T* __restrict__ y, float* __restrict__ hout, int S, int H, int P,
           int G, int N, int Q, int PT) {
  extern __shared__ float4 smem4[];
  float* bT = reinterpret_cast<float*>(smem4);  // [N][Q]     B chunk^T
  float* cs = bT + N * Q;                       // [Q][N]     C chunk
  float* sc = cs + Q * N;                       // [Q][Q+1]   scores
  float* xs = sc + Q * (Q + 1);                 // [Q][PT]    x, this P tile
  float* hT = xs + Q * PT;                      // [N][PT]    state^T
  float* Ls = hT + N * PT;                      // [Q]        cumsum(dt * A)
  float* dts = Ls + Q;                          // [Q]        dt
  float* ws = dts + Q;                          // [Q]        exp(L_last-L)*dt

  const int tid = threadIdx.x;
  const int p0 = blockIdx.x * PT, h = blockIdx.y, b = blockIdx.z;
  const int g = h / (H / G);
  const float a = A[h], dskip = Dv[h];

  for (int e = tid; e < N * PT; e += kThreads) hT[e] = 0.f;

  for (int c0 = 0; c0 < S; c0 += Q) {
    const int len = min(Q, S - c0);
    __syncthreads();  // the last chunk's readers are done
    for (int i = tid; i < Q; i += kThreads)
      dts[i] = i < len ? dt[(static_cast<size_t>(b) * S + c0 + i) * H + h]
                       : 0.f;
    for (int e = tid; e < Q * N; e += kThreads) {
      const int i = e / N, n = e % N;
      const size_t off =
          ((static_cast<size_t>(b) * S + c0 + i) * G + g) * N + n;
      bT[n * Q + i] = i < len ? widen(Bm[off]) : 0.f;
      cs[i * N + n] = i < len ? widen(Cm[off]) : 0.f;
    }
    for (int e = tid; e < Q * PT; e += kThreads) {
      const int i = e / PT, p = e % PT;
      xs[e] = i < len && p0 + p < P
                  ? widen(x[((static_cast<size_t>(b) * S + c0 + i) * H + h) *
                                P + p0 + p])
                  : 0.f;
    }
    __syncthreads();

    if (tid < 32) {  // L: inclusive cumsum of dt * A, 4 steps a lane
      float v[4], run = 0.f;
#pragma unroll
      for (int t = 0; t < 4; ++t) {
        const int i = tid * 4 + t;
        run += i < Q ? dts[i] * a : 0.f;
        v[t] = run;
      }
      float tot = run;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float up = __shfl_up_sync(0xffffffffu, tot, off);
        if (tid >= off) tot += up;
      }
      const float before = tot - run;
#pragma unroll
      for (int t = 0; t < 4; ++t)
        if (tid * 4 + t < Q) Ls[tid * 4 + t] = before + v[t];
    }
    __syncthreads();

    const float l_last = Ls[len - 1];
    for (int e = tid; e < Q * Q; e += kThreads) {
      const int i = e / Q, j = e % Q;
      float val = 0.f;
      if (j <= i && i < len) {
        float cb = 0.f;
        for (int n = 0; n < N; ++n) cb = fmaf(cs[i * N + n], bT[n * Q + j], cb);
        val = cb * expf(Ls[i] - Ls[j]) * dts[j];
      }
      sc[i * (Q + 1) + j] = val;
    }
    for (int j = tid; j < Q; j += kThreads)
      ws[j] = j < len ? expf(l_last - Ls[j]) * dts[j] : 0.f;
    __syncthreads();

    for (int e = tid; e < Q * PT; e += kThreads) {
      const int i = e / PT, p = e % PT;
      if (i >= len || p0 + p >= P) continue;
      float acc = 0.f;
      for (int j = 0; j <= i; ++j)
        acc = fmaf(sc[i * (Q + 1) + j], xs[j * PT + p], acc);
      const float el = expf(Ls[i]);
      float inter = 0.f;
      for (int n = 0; n < N; ++n)
        inter = fmaf(cs[i * N + n] * el, hT[n * PT + p], inter);
      const float yv = acc + inter + xs[i * PT + p] * dskip;
      put(y + ((static_cast<size_t>(b) * S + c0 + i) * H + h) * P + p0 + p,
          yv);
    }
    __syncthreads();  // y has read the incoming state

    const float decay = expf(l_last);
    for (int e = tid; e < N * PT; e += kThreads) {
      const int n = e / PT, p = e % PT;
      float upd = 0.f;
      for (int j = 0; j < len; ++j)
        upd = fmaf(xs[j * PT + p], bT[n * Q + j] * ws[j], upd);
      hT[e] = decay * hT[e] + upd;
    }
  }
  __syncthreads();
  for (int e = tid; e < N * PT; e += kThreads) {
    const int n = e / PT, p = e % PT;
    if (p0 + p < P)
      hout[((static_cast<size_t>(b) * H + h) * P + p0 + p) * N + n] = hT[e];
  }
}

template <typename T>
int launch(const void* x, const void* dt, const void* A, const void* Bm,
           const void* Cm, const void* Dv, void* y, void* hout, int B, int S,
           int H, int P, int G, int N, int Q, int PT, int smem_bytes,
           cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      ssd_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((P + PT - 1) / PT, H, B);
  ssd_kernel<T><<<grid, kThreads, smem_bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(dt),
      static_cast<const float*>(A), static_cast<const T*>(Bm),
      static_cast<const T*>(Cm), static_cast<const float*>(Dv),
      static_cast<T*>(y), static_cast<float*>(hout), S, H, P, G, N, Q, PT);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Shared memory (bytes) a block needs for chunk Q, state N, P tile PT.
int ssd_smem_bytes(int Q, int N, int PT) {
  return static_cast<int>(sizeof(float)) *
         (2 * N * Q + Q * (Q + 1) + Q * PT + N * PT + 3 * Q);
}

int ssd_max_chunk() { return kQMax; }

// x: (B, S, H, P), dt: (B, S, H) f32, A: (H,) f32, Bm/Cm: (B, S, G, N),
// Dv: (H,) f32, y: (B, S, H, P), hout: (B, H, P, N) f32; all contiguous on
// the device; x, Bm, Cm and y f32 (dtype 0) or bf16 (dtype 1). 1 <= Q <=
// 128 is the kernel's chunk, PT the P tile. Returns cudaGetLastError()
// after the launch (or the error that stopped it).
int ssd_launch(const void* x, const void* dt, const void* A, const void* Bm,
               const void* Cm, const void* Dv, void* y, void* hout, int dtype,
               int B, int S, int H, int P, int G, int N, int Q, int PT,
               void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || P <= 0 || N <= 0 || G <= 0 ||
      H % G != 0 || Q < 1 || Q > kQMax || PT < 1 || H > 65535 || B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int bytes = ssd_smem_bytes(Q, N, PT);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(x, dt, A, Bm, Cm, Dv, y, hout, B, S, H, P, G, N, Q,
                         PT, bytes, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(x, dt, A, Bm, Cm, Dv, y, hout, B, S, H, P,
                                 G, N, Q, PT, bytes, st);
  return static_cast<int>(cudaErrorInvalidValue);
}

const char* ssd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
