// Mamba-2 SSD chunked scan on Hopper (sm_90a), in three phases.
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
// N 16, bf16) the function must read x, dt, B, C and write y and h: 54 MB,
// 0.016 ms at 3.35 TB/s. The design is the Mamba-2 paper's own SSD
// decomposition: the chunk loop that the TPU runs in order becomes two
// chunk-parallel phases around one short sequential one.
//
//   1. chunk state, grid (chunks, H, B): L by a warp scan, w =
//      exp(L_last - L) * dt, the chunk's own state x^T . (B * w) as a
//      (P, N) f32 tile, and its decay exp(L_last), into scratch that the
//      wrapper allocates: states (B, chunks, H, P, N), decays (B, chunks,
//      H), both f32.
//   2. state passing, grid (P N / 256, H, B): the only sequential part.
//      One thread per state entry walks the chunks in order, replaces each
//      chunk's own state with the state coming into that chunk and carries
//      h <- exp(L_last) h + s; the final h is the second output.
//   3. chunk scan, grid (chunks, G x head slices, B): a block owns a slice
//      of the heads of one group and computes C . B^T once for all of them
//      (the old kernel did so per head and 16-row P tile: 100 times per
//      chunk at hymba); then, head by head, the scores (exp only for
//      i >= j, selected and never multiplied, since above the diagonal
//      L_i - L_j > 0 and exp may be inf, and inf * 0 is NaN) and y.
//
// bf16 inputs: the products of phases 1 and 3 run on the tensor cores as
// warp-level mma.sync m16n8k16 (bf16 x bf16 -> f32). The tiles are small
// (C . B^T is 128 x 128 x N, scores . x 128 x 64 x 128): at hymba's shape
// the scan's products are 3.4 GFLOP, 3.5 us at the 989 TFLOP/s wgmma peak
// against the 16 us bytes bound, so the product rate is not what bounds
// the kernel, and mma.sync needs no shared-memory descriptors or swizzle,
// takes any N (zero-padded to 16) and P (to 16), and leaves each score in
// the registers of the thread that applies its decay.
//   In the chunk scan a warp owns the 16-row stripes w and 7 - w of the
// chunk, so the triangle's short and long rows give four warps the same
// work; C . B^T of a stripe stays in shared memory in fragment order, each
// warp reading back only its own stripes. A block holds up to four such
// warp groups, each on its own head with its own buffers and a named
// barrier, so that one group's loads overlap another's products; B's
// buffer is reused for theirs once C . B^T is in.
//   Loads and stores: a loop of plain loads waits on each before the
// next, and in same-call probes such loops took longer than the products
// themselves. So x, B and C come into shared memory by cp.async, 16 bytes
// at a time and zero past the chunk's end, stay row-major, and ldmatrix
// .trans reads them as fragments (nothing is transposed through
// registers); the f32 states come as float4 loads, four in flight a
// thread. y leaves as 16 bytes a thread once the four threads of a quad
// have traded their accumulator columns: 2-byte stores spread over 8 rows
// cost more than that. Shapes whose rows are not 16-byte multiples (P or
// N not a multiple of 8) take plain loads and stores instead.
// Rounding points: none before y's own rounding to bf16. An f32 operand
// (the scores, the incoming state, x * w in phase 1) enters a product as
// three bf16 terms, hi + mid + lo, which hold all 24 bits of an f32; C, B
// and x are bf16 already, so every product is exact and summed in f32 on
// the tensor cores. Why: one bf16 rounding of the scores (as flash
// attention rounds P) moves the f32 y by ~2^-9 of its terms, enough to
// flip y's own rounding to the next bf16 value, and one bf16 step is 0.125
// where |y| >= 16 (mamba2-130m's shape reaches 28.5) against a 5e-2
// tolerance; two terms (2^-17) leave an error that, by its bound, can
// still flip a few of the 12.6 M outputs there.
// f32 inputs: every product an f32 FMA on the CUDA cores (4 x 4 register
// tiles), IEEE expf, no TF32, so that f32 meets 2e-5.
//
// Chunks: Q <= 128 steps (the wrapper halves Q where shared memory needs
// it; the function does not depend on Q). Any S: the last chunk may be
// short, its missing steps read as zero. The scratch states cost traffic
// the bound does not count: B chunks H P N 4 bytes, written by phase 1,
// read and written by phase 2, read by phase 3 (6.6 MB each pass at
// hymba's shape, 50 MB at mamba2-130m's N 128).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "../../flash_attention/csrc/hopper.cuh"

namespace {

constexpr int kQMax = 128;       // the warp scan covers 4 steps a lane
constexpr int kThreads = 256;    // the f32 kernels and the state passing
constexpr int kGroup = 128;      // a warp group of the bf16 kernels
constexpr int kMaxGroups = 4;    // warp groups a chunk-scan block may hold

__host__ __device__ constexpr int round_up(int v, int m) {
  return (v + m - 1) / m * m;
}
__host__ __device__ constexpr int max_of(int a, int b) { return a > b ? a : b; }

// L = inclusive cumsum of dt * a over n <= kQMax steps, by one warp
__device__ __forceinline__ void chunk_cumsum(const float* dts, float a,
                                             float* Ls, int n) {
  const int lane = threadIdx.x % 32;
  float v[4], run = 0.f;
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const int i = lane * 4 + t;
    run += i < n ? dts[i] * a : 0.f;
    v[t] = run;
  }
  float tot = run;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const float up = __shfl_up_sync(0xffffffffu, tot, off);
    if (lane >= off) tot += up;
  }
  const float before = tot - run;
#pragma unroll
  for (int t = 0; t < 4; ++t)
    if (lane * 4 + t < n) Ls[lane * 4 + t] = before + v[t];
}

// acc[r][q] += u[r] * v[q] for two float4 rows
__device__ __forceinline__ void outer4(float (&acc)[4][4], float4 u,
                                       float4 v) {
  const float uu[4] = {u.x, u.y, u.z, u.w};
  const float vv[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(uu[r], vv[q], acc[r][q]);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// the heads [h_lo, h_hi) of group g that a chunk-scan block owns: grid.y
// is G x slices, a slice HS heads of one group
__device__ __forceinline__ void block_heads(int H, int G, int HS, int& g,
                                            int& h_lo, int& h_hi) {
  const int slices = gridDim.y / G, hpg = H / G;
  g = blockIdx.y / slices;
  h_lo = g * hpg + (blockIdx.y % slices) * HS;
  h_hi = min(h_lo + HS, (g + 1) * hpg);
}

// ------------------------------------------------ phase 1: chunk state, f32
// shared memory (floats): x [Q][Pp], B * w [Q][Np], L, dt, w [Q]
struct StateSmemF32 {
  int Q, Pp, Np;
  __host__ __device__ StateSmemF32(int q, int N, int P)
      : Q(q), Pp(round_up(P, 4)), Np(round_up(N, 4)) {}
  __host__ __device__ int bytes() const {
    return 4 * (Q * Pp + Q * Np + 3 * Q);
  }
};

// grid (chunks, H, B)
__global__ void __launch_bounds__(kThreads)
ssd_chunk_state_f32(const float* __restrict__ x, const float* __restrict__ dt,
                    const float* __restrict__ A, const float* __restrict__ Bm,
                    float* __restrict__ states, float* __restrict__ decays,
                    int S, int H, int P, int G, int N, int Q) {
  extern __shared__ float4 smem4[];
  const StateSmemF32 lay(Q, N, P);
  float* xs = reinterpret_cast<float*>(smem4);   // [Q][Pp]
  float* bw = xs + Q * lay.Pp;                   // [Q][Np]  B * w
  float* Ls = bw + Q * lay.Np;                   // [Q]
  float* dts = Ls + Q;                           // [Q]
  float* ws = dts + Q;                           // [Q]      exp(L_last-L)*dt

  const int tid = threadIdx.x;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, nc = gridDim.x;
  const int c0 = c * Q, len = min(Q, S - c0);
  const int g = h / (H / G);
  const size_t row0 = static_cast<size_t>(b) * S + c0;

  for (int i = tid; i < Q; i += kThreads)
    dts[i] = i < len ? dt[(row0 + i) * H + h] : 0.f;
  for (int e = tid; e < Q * lay.Pp; e += kThreads) {
    const int j = e / lay.Pp, p = e % lay.Pp;
    xs[e] = j < len && p < P ? x[((row0 + j) * H + h) * P + p] : 0.f;
  }
  __syncthreads();
  if (tid < 32) chunk_cumsum(dts, A[h], Ls, Q);
  __syncthreads();
  const float l_last = Ls[len - 1];
  for (int j = tid; j < Q; j += kThreads)
    ws[j] = j < len ? expf(l_last - Ls[j]) * dts[j] : 0.f;
  __syncthreads();
  for (int e = tid; e < Q * lay.Np; e += kThreads) {
    const int j = e / lay.Np, n = e % lay.Np;
    bw[e] = j < len && n < N ? Bm[((row0 + j) * G + g) * N + n] * ws[j]
                             : 0.f;
  }
  __syncthreads();

  // s[p][n] = sum_j x[j][p] (B * w)[j][n], 4 x 4 tiles a thread
  float* out = states + ((static_cast<size_t>(b) * nc + c) * H + h) * P * N;
  const int tn = lay.Np / 4;
  for (int t = tid; t < lay.Pp / 4 * tn; t += kThreads) {
    const int p0 = t / tn * 4, n0 = t % tn * 4;
    float acc[4][4] = {};
    for (int j = 0; j < len; ++j)
      outer4(acc, ld4(xs + j * lay.Pp + p0), ld4(bw + j * lay.Np + n0));
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (p0 + r < P && n0 + q < N) out[(p0 + r) * N + n0 + q] = acc[r][q];
  }
  if (tid == 0)
    decays[(static_cast<size_t>(b) * nc + c) * H + h] = expf(l_last);
}

// ---------------------------------------------- phase 2: state passing
constexpr int kAhead = 16;  // chunks whose loads are in flight at once

// grid (ceil(P N / kThreads), H, B)
__global__ void __launch_bounds__(kThreads)
ssd_state_pass(float* __restrict__ states, const float* __restrict__ decays,
               float* __restrict__ hout, int H, int PN, int nc) {
  const int e = blockIdx.x * kThreads + threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  if (e >= PN) return;
  const size_t step = static_cast<size_t>(H) * PN;   // chunk c -> c + 1
  float* s = states + (static_cast<size_t>(b) * nc * H + h) * PN + e;
  const float* d = decays + static_cast<size_t>(b) * nc * H + h;
  float run = 0.f;
  for (int c0 = 0; c0 < nc; c0 += kAhead) {
    float v[kAhead], dec[kAhead];
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      const bool in = c0 + k < nc;
      v[k] = in ? s[(c0 + k) * step] : 0.f;
      dec[k] = in ? d[static_cast<size_t>(c0 + k) * H] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kAhead; ++k) {
      if (c0 + k < nc) {
        s[(c0 + k) * step] = run;              // the state entering chunk
        run = fmaf(dec[k], run, v[k]);
      }
    }
  }
  hout[(static_cast<size_t>(b) * H + h) * PN + e] = run;
}

// --------------------------------------------- phase 3: chunk scan, f32
// shared memory (floats): C^T, B^T [Np][Qp], (C.B^T)^T and scores^T
// [Qr][Qp] (j major), x [Qr][Pp], h_in^T [Np][Pp], L and dt [Qr]
struct ScanSmemF32 {
  int Qr, Qp, Pp, Np;
  __host__ __device__ ScanSmemF32(int Q, int N, int P)
      : Qr(round_up(Q, 4)), Qp(round_up(Q, 4) + 4), Pp(round_up(P, 4)),
        Np(round_up(N, 4)) {}
  __host__ __device__ int bytes() const {
    return 4 * (2 * Np * Qp + 2 * Qr * Qp + Qr * Pp + Np * Pp + 2 * Qr);
  }
};

// grid (chunks, G x slices, B)
__global__ void __launch_bounds__(kThreads)
ssd_chunk_scan_f32(const float* __restrict__ x, const float* __restrict__ dt,
                   const float* __restrict__ A, const float* __restrict__ Bm,
                   const float* __restrict__ Cm,
                   const float* __restrict__ Dv,
                   const float* __restrict__ states, float* __restrict__ y,
                   int S, int H, int P, int G, int N, int Q, int HS) {
  extern __shared__ float4 smem4[];
  const ScanSmemF32 lay(Q, N, P);
  const int Qp = lay.Qp, Pp = lay.Pp, Np = lay.Np, Qr = lay.Qr;
  float* cT = reinterpret_cast<float*>(smem4);   // [Np][Qp]  C^T
  float* bT = cT + Np * Qp;                      // [Np][Qp]  B^T
  float* cbT = bT + Np * Qp;                     // [Qr][Qp]  cbT[j][i]
  float* sT = cbT + Qr * Qp;                     // [Qr][Qp]  scores, j major
  float* xs = sT + Qr * Qp;                      // [Qr][Pp]  x
  float* hT = xs + Qr * Pp;                      // [Np][Pp]  h_in^T
  float* Ls = hT + Np * Pp;                      // [Qr]
  float* dts = Ls + Qr;                          // [Qr]

  const int tid = threadIdx.x;
  const int c = blockIdx.x, b = blockIdx.z, nc = gridDim.x;
  int g, h_lo, h_hi;
  block_heads(H, G, HS, g, h_lo, h_hi);
  const int c0 = c * Q, len = min(Q, S - c0);
  const size_t row0 = static_cast<size_t>(b) * S + c0;

  for (int e = tid; e < Qr * Np; e += kThreads) {
    const int i = e / Np, n = e % Np;
    const bool in = i < len && n < N;
    const size_t off = ((row0 + i) * G + g) * N + n;
    cT[n * Qp + i] = in ? Cm[off] : 0.f;
    bT[n * Qp + i] = in ? Bm[off] : 0.f;
  }
  __syncthreads();
  // C . B^T once for every head of the block: the 4 x 4 tiles that reach
  // the diagonal or below it
  const int tq = Qr / 4;
  for (int t = tid; t < tq * tq; t += kThreads) {
    const int i0 = t / tq * 4, j0 = t % tq * 4;
    if (j0 > i0) continue;
    float acc[4][4] = {};
    for (int n = 0; n < N; ++n)
      outer4(acc, ld4(cT + n * Qp + i0), ld4(bT + n * Qp + j0));
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int q = 0; q < 4; ++q) cbT[(j0 + q) * Qp + i0 + r] = acc[r][q];
  }

  for (int h = h_lo; h < h_hi; ++h) {
    __syncthreads();   // C.B^T is in; the last head's readers are done
    for (int i = tid; i < Qr; i += kThreads)
      dts[i] = i < len ? dt[(row0 + i) * H + h] : 0.f;
    for (int e = tid; e < Qr * Pp; e += kThreads) {
      const int j = e / Pp, p = e % Pp;
      xs[e] = j < len && p < P ? x[((row0 + j) * H + h) * P + p] : 0.f;
    }
    const float* hin =
        states + ((static_cast<size_t>(b) * nc + c) * H + h) * P * N;
    for (int e = tid; e < Pp * Np; e += kThreads) {
      const int p = e / Np, n = e % Np;
      hT[n * Pp + p] = p < P && n < N ? hin[p * N + n] : 0.f;
    }
    __syncthreads();
    if (tid < 32) chunk_cumsum(dts, A[h], Ls, Qr);
    __syncthreads();
    for (int e = tid; e < Qr * Qr; e += kThreads) {
      const int j = e / Qr, i = e % Qr;
      sT[j * Qp + i] = j <= i && i < len
                           ? cbT[j * Qp + i] * expf(Ls[i] - Ls[j]) * dts[j]
                           : 0.f;
    }
    __syncthreads();

    // y = exp(L) (C . h_in^T) + scores . x + D x, 4 x 4 tiles of (i, p)
    const float dh = Dv[h];
    const int tp = Pp / 4;
    for (int t = tid; t < tq * tp; t += kThreads) {
      const int i0 = t / tp * 4, p0 = t % tp * 4;
      if (i0 >= len) continue;
      float acc[4][4] = {};
      for (int n = 0; n < N; ++n)
        outer4(acc, ld4(cT + n * Qp + i0), ld4(hT + n * Pp + p0));
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const float el = expf(Ls[i0 + r]);
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] *= el;
      }
      const int j_end = min(i0 + 4, len);
      for (int j = 0; j < j_end; ++j)
        outer4(acc, ld4(sT + j * Qp + i0), ld4(xs + j * Pp + p0));
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + r;
        if (i >= len) break;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int p = p0 + q;
          if (p < P)
            y[((row0 + i) * H + h) * P + p] =
                acc[r][q] + xs[i * Pp + p] * dh;
        }
      }
    }
  }
}

// ------------------------------------------- the bf16 (tensor core) path
namespace tc {

__device__ __forceinline__ uint32_t ld32(const uint16_t* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}
__device__ __forceinline__ float bits_to_float(uint16_t v) {
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}
__device__ __forceinline__ uint16_t to_bits(float v) {
  return __bfloat16_as_ushort(__float2bfloat16_rn(v));
}

// v = hi + mid + lo, each term bf16: the three hold v's 24 bits
__device__ __forceinline__ void split3(float v, uint16_t (&t)[3]) {
  t[0] = to_bits(v);
  const float r = v - bits_to_float(t[0]);
  t[1] = to_bits(r);
  t[2] = to_bits(r - bits_to_float(t[1]));
}

// the A fragment of rows r0 .. r0 + 15, columns k0 .. k0 + 15 of a
// row-major bf16 tile
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const uint16_t* t,
                                       int stride, int r0, int k0,
                                       int lane) {
  const uint16_t* p = t + (r0 + lane / 4) * stride + k0 + 2 * (lane % 4);
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * stride);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * stride + 8);
}

// the B fragments of two 8-column tiles, columns n0 .. n0 + 15 over rows
// k0 .. k0 + 15 of a row-major k x n bf16 tile: b[0], b[1] for columns n0
// .., b[2], b[3] for n0 + 8 ..
__device__ __forceinline__ void load_b_pair(uint32_t (&b)[4],
                                            const uint16_t* t, int stride,
                                            int k0, int n0, int lane) {
  const int m = lane / 8;
  hopper::ldmatrix_x4_trans(
      b, t + (k0 + lane % 8 + (m & 1) * 8) * stride + n0 + (m >> 1) * 8);
}

// the A fragment of rows m0 .. m0 + 15 (as columns of t), columns k0 ..
// k0 + 15 (as rows of t) from a row-major k x m bf16 tile t
__device__ __forceinline__ void load_a_trans(uint32_t (&a)[4],
                                             const uint16_t* t, int stride,
                                             int k0, int m0, int lane) {
  const int m = lane / 8;
  hopper::ldmatrix_x4_trans(
      a, t + (k0 + lane % 8 + (m >> 1) * 8) * stride + m0 + (m & 1) * 8);
}

// a barrier for the 128 threads of warp group ``group`` alone (barrier 0
// is __syncthreads)
__device__ __forceinline__ void group_sync(int group) {
  asm volatile("bar.sync %0, 128;\n" :: "r"(group + 1) : "memory");
}

// Rows [0, rows) of ``cols`` bf16 values into shared memory (row r at dst
// + r dst_stride), row r read at src + r src_stride, rows >= valid and
// columns [cols, pad) zero; by threads t, t + nthr, .. of the caller. With
// ``vec`` (cols % 8 == 0, src and its rows 16-byte aligned) as 16-byte
// cp.async copies, which the caller waits for; else by plain loads.
__device__ __forceinline__ void copy_rows(uint16_t* dst, int dst_stride,
                                          const uint16_t* src,
                                          size_t src_stride, int rows,
                                          int valid, int cols, int pad,
                                          bool vec, int t, int nthr) {
  if (vec) {
    const int per = cols / 8;
    for (int e = t; e < rows * per; e += nthr) {
      const int r = e / per, c = 8 * (e % per);
      hopper::cp_async16(dst + r * dst_stride + c,
                         r < valid ? src + r * src_stride + c : src,
                         r < valid ? 16u : 0u);
    }
    for (int e = t; e < rows * (pad - cols); e += nthr) {
      const int r = e / (pad - cols), c = cols + e % (pad - cols);
      dst[r * dst_stride + c] = 0;
    }
  } else {
    for (int e = t; e < rows * pad; e += nthr) {
      const int r = e / pad, c = e % pad;
      dst[r * dst_stride + c] =
          r < valid && c < cols ? src[r * src_stride + c] : 0;
    }
  }
}

// dt of one head over the chunk's steps, zero past len
__device__ __forceinline__ void copy_dt(float* dst, const float* dt,
                                        size_t row0, int H, int h, int n,
                                        int len, int t, int nthr) {
  for (int i = t; i < n; i += nthr)
    hopper::cp_async4(dst + i, i < len ? dt + (row0 + i) * H + h : dt,
                      i < len ? 4u : 0u);
}

// ------------------------------------------------ phase 1: chunk state
// shared memory: L, dt, w [Qk] f32; then bf16: (x * w) as three terms
// [Qk][Pk + 8] (the first first holds x itself) and B [Qk][Nk + 8], Pk =
// P to 16, Nk = N to 16; rows of 16-byte multiples, whose pad of 8 puts the
// 8 rows an ldmatrix reads on distinct banks.
struct StateSmem {
  int Qk, Pk, Nk, xst, bst;
  __host__ __device__ StateSmem(int Q, int N, int P)
      : Qk(round_up(Q, 16)), Pk(round_up(P, 16)), Nk(round_up(N, 16)),
        xst(round_up(P, 16) + 8), bst(round_up(N, 16) + 8) {}
  __host__ __device__ int bytes() const {
    return 12 * Qk + 2 * Qk * (3 * xst + bst);
  }
};

// grid (chunks, H, B), one warp group. s[p][n] = sum_j (x w)[j][p] B[j][n]
// with rows p in 16-row tiles (warp w: tiles w, w + 4, ..) and columns n
// in 8-column tiles, 16 at a time. ``vec``: x's and B's rows can be copied
// 16 bytes at a time.
__global__ void __launch_bounds__(kGroup)
ssd_chunk_state_bf16(const uint16_t* __restrict__ x,
                     const float* __restrict__ dt,
                     const float* __restrict__ A,
                     const uint16_t* __restrict__ Bm,
                     float* __restrict__ states, float* __restrict__ decays,
                     int S, int H, int P, int G, int N, int Q, int vec) {
  extern __shared__ float4 smem4[];
  const StateSmem lay(Q, N, P);
  float* Ls = reinterpret_cast<float*>(smem4);              // [Qk]
  float* dts = Ls + lay.Qk;                                 // [Qk]
  float* ws = dts + lay.Qk;                                 // [Qk]
  uint16_t* xw = reinterpret_cast<uint16_t*>(ws + lay.Qk);  // 3 x [Qk][xst]
  uint16_t* bs = xw + 3 * lay.Qk * lay.xst;                 // [Qk][bst]
  const int xterm = lay.Qk * lay.xst;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, nc = gridDim.x;
  const int c0 = c * Q, len = min(Q, S - c0);
  const int g = h / (H / G);
  const size_t row0 = static_cast<size_t>(b) * S + c0;

  copy_dt(dts, dt, row0, H, h, lay.Qk, len, tid, kGroup);
  copy_rows(xw, lay.xst, x + (row0 * H + h) * P, static_cast<size_t>(H) * P,
            lay.Qk, len, P, lay.Pk, vec, tid, kGroup);
  copy_rows(bs, lay.bst, Bm + (row0 * G + g) * N, static_cast<size_t>(G) * N,
            lay.Qk, len, N, lay.Nk, vec, tid, kGroup);
  hopper::cp_async_wait_all();
  __syncthreads();
  if (warp == 0) chunk_cumsum(dts, A[h], Ls, lay.Qk);
  __syncthreads();
  const float l_last = Ls[len - 1];
  for (int j = tid; j < lay.Qk; j += kGroup)
    ws[j] = j < len ? expf(l_last - Ls[j]) * dts[j] : 0.f;
  __syncthreads();
  // x * w as three bf16 terms, in place: each thread reads the pair it
  // then overwrites
  for (int e = tid; e < lay.Qk * lay.Pk / 2; e += kGroup) {
    const int j = e / (lay.Pk / 2), p = 2 * (e % (lay.Pk / 2));
    const uint32_t raw = ld32(xw + j * lay.xst + p);
    uint16_t u0[3], u1[3];
    split3(bits_to_float(raw & 0xffffu) * ws[j], u0);
    split3(bits_to_float(raw >> 16) * ws[j], u1);
#pragma unroll
    for (int k = 0; k < 3; ++k)
      *reinterpret_cast<uint32_t*>(xw + k * xterm + j * lay.xst + p) =
          static_cast<uint32_t>(u0[k]) | static_cast<uint32_t>(u1[k]) << 16;
  }
  __syncthreads();

  float* out = states + ((static_cast<size_t>(b) * nc + c) * H + h) * P * N;
  for (int p0 = 16 * warp; p0 < lay.Pk; p0 += 64) {
    for (int n0 = 0; n0 < lay.Nk; n0 += 128) {
      float acc[16][4];
#pragma unroll
      for (int nt = 0; nt < 16; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
      for (int k0 = 0; k0 < lay.Qk; k0 += 16) {
        uint32_t a[3][4];
#pragma unroll
        for (int k = 0; k < 3; ++k)
          load_a_trans(a[k], xw + k * xterm, lay.xst, k0, p0, lane);
#pragma unroll
        for (int nt = 0; nt < 16; nt += 2) {
          if (n0 + 8 * nt < lay.Nk) {
            uint32_t bf[4];
            load_b_pair(bf, bs, lay.bst, k0, n0 + 8 * nt, lane);
#pragma unroll
            for (int k = 0; k < 3; ++k) {
              hopper::mma_m16n8k16(acc[nt], a[k], bf[0], bf[1]);
              hopper::mma_m16n8k16(acc[nt + 1], a[k], bf[2], bf[3]);
            }
          }
        }
      }
      const int t2 = 2 * (lane % 4);
#pragma unroll
      for (int nt = 0; nt < 16; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int p = p0 + lane / 4 + (e < 2 ? 0 : 8);
          const int n = n0 + 8 * nt + t2 + (e & 1);
          if (p < P && n < N) out[p * N + n] = acc[nt][e];
        }
      }
    }
  }
  if (tid == 0)
    decays[(static_cast<size_t>(b) * nc + c) * H + h] = expf(l_last);
}

// ------------------------------------------------- phase 3: chunk scan
// shared memory: C.B^T in fragment order (16 B a lane, 32 lanes a 16 x 8
// tile, stripe s holding tiles 0 .. 2 s + 1), C [Qk][Nk + 8] bf16, then a
// region that first holds B [Qk][Nk + 8] and, once C.B^T is in, each warp
// group's buffers: L and dt [Qk] f32, x [Qk][Pk + 8] and h_in's hi, mid
// and lo terms [Pk][Nk + 8] in bf16 (Nk = N to 16, Pk = P to 16).
struct ScanSmem {
  int Qk, nst, Nk, Pk, cst, xst, hst, groups;
  __host__ __device__ ScanSmem(int Q, int N, int P, int groups_)
      : Qk(round_up(Q, 16)), nst(round_up(Q, 16) / 16), Nk(round_up(N, 16)),
        Pk(round_up(P, 16)), cst(round_up(N, 16) + 8),
        xst(round_up(P, 16) + 8), hst(round_up(N, 16) + 8),
        groups(groups_) {}
  __host__ __device__ int cb_bytes() const { return nst * (nst + 1) * 512; }
  __host__ __device__ int c_bytes() const { return 2 * Qk * cst; }
  __host__ __device__ int group_bytes() const {
    return 8 * Qk + 2 * Qk * xst + 6 * Pk * hst;
  }
  __host__ __device__ int bytes() const {
    return cb_bytes() + c_bytes() + max_of(c_bytes(), groups * group_bytes());
  }
};

// stripe k (0 or 1) of warp w: w and nst - 1 - w, each stripe to the one
// warp w = min(s, nst - 1 - s) (nst <= 8, so w < 4); -1 if none
__device__ __forceinline__ int own_stripe(int w, int k, int nst) {
  if (k == 0) return 2 * w <= nst - 1 ? w : -1;
  return nst - 1 - w > w ? nst - 1 - w : -1;
}

// a[i] for a run-time i in 0 .. 3, without indexing registers
__device__ __forceinline__ float sel4(float a0, float a1, float a2,
                                      float a3, int i) {
  return i == 0 ? a0 : i == 1 ? a1 : i == 2 ? a2 : a3;
}

// grid (chunks, G x slices, B), groups x 128 threads. ``vec``: x's, B's
// and C's rows can be copied, and y's written, 16 bytes at a time.
__global__ void __launch_bounds__(kMaxGroups * kGroup)
ssd_chunk_scan_bf16(const uint16_t* __restrict__ x,
                    const float* __restrict__ dt, const float* __restrict__ A,
                    const uint16_t* __restrict__ Bm,
                    const uint16_t* __restrict__ Cm,
                    const float* __restrict__ Dv,
                    const float* __restrict__ states,
                    __nv_bfloat16* __restrict__ y, int S, int H, int P,
                    int G, int N, int Q, int HS, int vec) {
  extern __shared__ float4 smem4[];
  const ScanSmem lay(Q, N, P, blockDim.x / kGroup);
  float4* cbf = smem4;                                      // C.B^T
  uint16_t* cs = reinterpret_cast<uint16_t*>(
      reinterpret_cast<char*>(smem4) + lay.cb_bytes());     // C
  char* region = reinterpret_cast<char*>(cs) + lay.c_bytes();
  uint16_t* bs = reinterpret_cast<uint16_t*>(region);       // B, at first

  const int tid = threadIdx.x, group = tid / kGroup;
  const int warp = tid % kGroup / 32, lane = tid % 32;
  const int gr = lane / 4, t2 = 2 * (lane % 4);
  const int c = blockIdx.x, b = blockIdx.z, nc = gridDim.x;
  int g, h_lo, h_hi;
  block_heads(H, G, HS, g, h_lo, h_hi);
  const int c0 = c * Q, len = min(Q, S - c0);
  const size_t row0 = static_cast<size_t>(b) * S + c0;

  copy_rows(cs, lay.cst, Cm + (row0 * G + g) * N, static_cast<size_t>(G) * N,
            lay.Qk, len, N, lay.Nk, vec, tid, blockDim.x);
  copy_rows(bs, lay.cst, Bm + (row0 * G + g) * N, static_cast<size_t>(G) * N,
            lay.Qk, len, N, lay.Nk, vec, tid, blockDim.x);
  hopper::cp_async_wait_all();
  __syncthreads();

  // C . B^T of group 0's stripes, once for every head of the block: rows
  // 16 s .. 16 s + 15 against keys 0 .. 16 s + 15, K = N in steps of 16
  for (int k = 0; k < 2 && group == 0; ++k) {
    const int s = own_stripe(warp, k, lay.nst);
    if (s < 0) continue;
    float acc[16][4];
#pragma unroll
    for (int jt = 0; jt < 16; ++jt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[jt][e] = 0.f;
    for (int k0 = 0; k0 < lay.Nk; k0 += 16) {
      uint32_t a[4];
      load_a(a, cs, lay.cst, 16 * s, k0, lane);
#pragma unroll
      for (int jt = 0; jt < 16; ++jt) {
        if (jt < 2 * s + 2) {
          const uint16_t* br = bs + (8 * jt + gr) * lay.cst + k0 + t2;
          hopper::mma_m16n8k16(acc[jt], a, ld32(br), ld32(br + 8));
        }
      }
    }
    float4* dst = cbf + s * (s + 1) * 32 + lane;
#pragma unroll
    for (int jt = 0; jt < 16; ++jt)
      if (jt < 2 * s + 2)
        dst[jt * 32] = make_float4(acc[jt][0], acc[jt][1], acc[jt][2],
                                   acc[jt][3]);
  }
  __syncthreads();   // C.B^T is in, B is read: the region is the groups'

  char* mine = region + group * lay.group_bytes();
  float* Ls = reinterpret_cast<float*>(mine);               // [Qk]
  float* dts = Ls + lay.Qk;                                 // [Qk]
  uint16_t* xs = reinterpret_cast<uint16_t*>(dts + lay.Qk);  // [Qk][xst]
  uint16_t* hs = xs + lay.Qk * lay.xst;      // h_in: hi, mid, lo terms
  const int hterm = lay.Pk * lay.hst;        // one term's elements
  const int gtid = tid % kGroup;

  for (int h = h_lo + group; h < h_hi; h += lay.groups) {
    group_sync(group);   // the group's last head's readers are done
    copy_dt(dts, dt, row0, H, h, lay.Qk, len, gtid, kGroup);
    copy_rows(xs, lay.xst, x + (row0 * H + h) * P,
              static_cast<size_t>(H) * P, lay.Qk, len, P, lay.Pk, vec, gtid,
              kGroup);
    // the incoming state, as hi + mid + lo in bf16, while x comes in:
    // four float4 loads in flight a thread where N % 4 == 0
    const float* hin =
        states + ((static_cast<size_t>(b) * nc + c) * H + h) * P * N;
    if (N % 4 == 0) {
      const int per = lay.Nk / 4, total = lay.Pk * per;
      for (int e0 = gtid; e0 < total; e0 += 4 * kGroup) {
        float4 v[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int e = e0 + u * kGroup, p = e / per, n = 4 * (e % per);
          v[u] = e < total && p < P && n < N
                     ? *reinterpret_cast<const float4*>(hin + p * N + n)
                     : make_float4(0.f, 0.f, 0.f, 0.f);
        }
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int e = e0 + u * kGroup, p = e / per, n = 4 * (e % per);
          if (e >= total) break;
          const float f[4] = {v[u].x, v[u].y, v[u].z, v[u].w};
          uint16_t t[4][3];
#pragma unroll
          for (int q = 0; q < 4; ++q) split3(f[q], t[q]);
#pragma unroll
          for (int k = 0; k < 3; ++k)
            *reinterpret_cast<uint2*>(hs + k * hterm + p * lay.hst + n) =
                make_uint2(t[0][k] | static_cast<uint32_t>(t[1][k]) << 16,
                           t[2][k] | static_cast<uint32_t>(t[3][k]) << 16);
        }
      }
    } else {
      for (int e = gtid; e < lay.Pk * lay.Nk; e += kGroup) {
        const int p = e / lay.Nk, n = e % lay.Nk;
        uint16_t t[3];
        split3(p < P && n < N ? hin[p * N + n] : 0.f, t);
#pragma unroll
        for (int k = 0; k < 3; ++k) hs[k * hterm + p * lay.hst + n] = t[k];
      }
    }
    hopper::cp_async_wait_all();
    group_sync(group);
    if (warp == 0) chunk_cumsum(dts, A[h], Ls, lay.Qk);
    group_sync(group);

    const float dh = Dv[h];
    for (int k = 0; k < 2; ++k) {
      const int s = own_stripe(warp, k, lay.nst);
      if (s < 0 || 16 * s >= len) continue;
      const int r0 = 16 * s + gr, r1 = r0 + 8;   // this thread's rows
      const float L0 = Ls[r0], L1 = Ls[r1];
      const float el0 = expf(L0), el1 = expf(L1);
      const float4* cb = cbf + s * (s + 1) * 32 + lane;
      for (int pb = 0; pb < lay.Pk; pb += 64) {
        float acc[8][4];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[nt][e] = 0.f;
        // the incoming state: C . h_in^T over its three terms
        for (int k0 = 0; k0 < lay.Nk; k0 += 16) {
          uint32_t a[4];
          load_a(a, cs, lay.cst, 16 * s, k0, lane);
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
            if (pb + 8 * nt < lay.Pk) {
              const uint16_t* hr = hs + (pb + 8 * nt + gr) * lay.hst + k0 + t2;
#pragma unroll
              for (int t = 0; t < 3; ++t)
                hopper::mma_m16n8k16(acc[nt], a, ld32(hr + t * hterm),
                                     ld32(hr + t * hterm + 8));
            }
          }
        }
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          acc[nt][0] *= el0;
          acc[nt][1] *= el0;
          acc[nt][2] *= el1;
          acc[nt][3] *= el1;
        }
        // scores . x over the keys 0 .. 16 s + 15, 16 at a time: the
        // C.B^T accumulators of key tiles 2 kk and 2 kk + 1, decayed and
        // selected below the diagonal, are the A fragment in place, as
        // hi + mid + lo in bf16; x's fragments come by ldmatrix.trans
        for (int kk = 0; kk <= s; ++kk) {
          const float4 u = cb[2 * kk * 32], v = cb[(2 * kk + 1) * 32];
          const int j0 = 16 * kk + t2;
          const float cbv[8] = {u.x, u.y, u.z, u.w, v.x, v.y, v.z, v.w};
          float sc[8];
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            const int j = j0 + (e >> 2) * 8 + (e & 1);
            const int i = (e & 2) ? r1 : r0;
            const float Li = (e & 2) ? L1 : L0;
            sc[e] = j <= i ? cbv[e] * expf(Li - Ls[j]) * dts[j] : 0.f;
          }
          uint32_t a[3][4];   // the hi, mid and lo fragments
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            uint16_t u0[3], u1[3];
            split3(sc[2 * e], u0);
            split3(sc[2 * e + 1], u1);
#pragma unroll
            for (int t = 0; t < 3; ++t)
              a[t][e] = static_cast<uint32_t>(u0[t]) |
                        static_cast<uint32_t>(u1[t]) << 16;
          }
#pragma unroll
          for (int nt = 0; nt < 8; nt += 2) {
            if (pb + 8 * nt < lay.Pk) {
              uint32_t bf[4];
              load_b_pair(bf, xs, lay.xst, 16 * kk, pb + 8 * nt, lane);
#pragma unroll
              for (int t = 0; t < 3; ++t) {
                hopper::mma_m16n8k16(acc[nt], a[t], bf[0], bf[1]);
                hopper::mma_m16n8k16(acc[nt + 1], a[t], bf[2], bf[3]);
              }
            }
          }
        }
        // + D x, rounded to bf16
        if (vec) {
          // a quad's four threads trade their column pairs so that thread
          // t holds 8 whole columns (8 t .., 32 + 8 t ..) of rows r0, r1:
          // in round k it sends the pairs that thread t ^ k needs
          const int t = lane % 4, quad = lane & ~3;
#pragma unroll
          for (int half = 0; half < 2; ++half) {
#pragma unroll
            for (int blk = 0; blk < 2; ++blk) {
              float got[4][2];   // [k]: from thread t ^ k
#pragma unroll
              for (int k = 0; k < 4; ++k) {
#pragma unroll
                for (int e = 0; e < 2; ++e) {
                  const int ei = 2 * half + e;
                  const float send = sel4(acc[4 * blk][ei], acc[4 * blk + 1][ei],
                                          acc[4 * blk + 2][ei],
                                          acc[4 * blk + 3][ei], t ^ k);
                  got[k][e] = __shfl_sync(0xffffffffu, send, quad | (t ^ k));
                }
              }
              const int r = half ? r1 : r0;
              const int p0 = pb + 8 * (4 * blk + t);
              if (r >= len || p0 >= P) continue;
              const uint4 xv =
                  *reinterpret_cast<const uint4*>(xs + r * lay.xst + p0);
              const uint32_t xw[4] = {xv.x, xv.y, xv.z, xv.w};
              uint32_t out[4];
#pragma unroll
              for (int sq = 0; sq < 4; ++sq) {   // columns 2 sq, 2 sq + 1
                const float v0 = sel4(got[0][0], got[1][0], got[2][0],
                                      got[3][0], sq ^ t);
                const float v1 = sel4(got[0][1], got[1][1], got[2][1],
                                      got[3][1], sq ^ t);
                out[sq] = hopper::pack_bf16(
                    v0 + bits_to_float(xw[sq] & 0xffffu) * dh,
                    v1 + bits_to_float(xw[sq] >> 16) * dh);
              }
              *reinterpret_cast<uint4*>(y + ((row0 + r) * H + h) * P + p0) =
                  make_uint4(out[0], out[1], out[2], out[3]);
            }
          }
        } else {
#pragma unroll
          for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int r = e < 2 ? r0 : r1;
              const int p = pb + 8 * nt + t2 + (e & 1);
              if (r < len && p < P)
                y[((row0 + r) * H + h) * P + p] = __float2bfloat16_rn(
                    acc[nt][e] + bits_to_float(xs[r * lay.xst + p]) * dh);
            }
          }
        }
      }
    }
  }
}

}  // namespace tc

// whether the rows of a bf16 tensor whose innermost dim is ``n`` can move
// 16 bytes at a time: n % 8 == 0 and the data 16-byte aligned
bool rows16(const void* p, int n) {
  return n % 8 == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

bool bad_shape(int B, int S, int H, int P, int G, int N, int Q) {
  return B <= 0 || S <= 0 || H <= 0 || P <= 0 || N <= 0 || G <= 0 ||
         H % G != 0 || Q < 1 || Q > kQMax || H > 65535 || B > 65535;
}

// raise a kernel's dynamic shared memory limit to ``bytes``; ``allowed``
// remembers the limit set (one device a process), so a launch that needs
// no more sets nothing
template <typename K>
cudaError_t allow_smem(K kernel, int bytes, int& allowed) {
  if (bytes <= allowed) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess) allowed = bytes;
  return err;
}

}  // namespace

extern "C" {

// Dynamic shared memory (bytes) a block takes in phase 1 (the chunk
// state) or phase 3 (the chunk scan, with ``groups`` warp groups in bf16),
// dtype 0 f32 or 1 bf16, at chunk Q, state N, head dim P; -1 for another
// phase or dtype. ops.py mirrors it.
int ssd_smem_bytes(int phase, int dtype, int Q, int N, int P, int groups) {
  if (phase == 1 && dtype == 0) return StateSmemF32(Q, N, P).bytes();
  if (phase == 1 && dtype == 1) return tc::StateSmem(Q, N, P).bytes();
  if (phase == 3 && dtype == 0) return ScanSmemF32(Q, N, P).bytes();
  if (phase == 3 && dtype == 1) return tc::ScanSmem(Q, N, P, groups).bytes();
  return -1;
}

// Inputs, all contiguous on the device: x (B, S, H, P), dt (B, S, H) f32,
// A (H,) f32, Bm/Cm (B, S, G, N), Dv (H,) f32; x, Bm, Cm (and y) f32
// (dtype 0) or bf16 (dtype 1). Scratch: states (B, nc, H, P, N) f32 and
// decays (B, nc, H) f32 with nc = ceil(S / Q), 1 <= Q <= 128. Each launch
// returns cudaGetLastError() after it (or the error that stopped it).

// phase 1: each chunk's own state into states, exp(L_last) into decays
int ssd_chunk_state_launch(const void* x, const void* dt, const void* A,
                           const void* Bm, void* states, void* decays,
                           int dtype, int B, int S, int H, int P, int G,
                           int N, int Q, void* stream) {
  if (bad_shape(B, S, H, P, G, N, Q))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((S + Q - 1) / Q, H, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    const int bytes = StateSmemF32(Q, N, P).bytes();
    static int allowed = 0;
    err = allow_smem(ssd_chunk_state_f32, bytes, allowed);
    if (err != cudaSuccess) return static_cast<int>(err);
    ssd_chunk_state_f32<<<grid, kThreads, bytes, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(dt),
        static_cast<const float*>(A), static_cast<const float*>(Bm),
        static_cast<float*>(states), static_cast<float*>(decays), S, H, P, G,
        N, Q);
  } else if (dtype == 1) {
    const int bytes = tc::StateSmem(Q, N, P).bytes();
    static int allowed = 0;
    err = allow_smem(tc::ssd_chunk_state_bf16, bytes, allowed);
    if (err != cudaSuccess) return static_cast<int>(err);
    tc::ssd_chunk_state_bf16<<<grid, kGroup, bytes, st>>>(
        static_cast<const uint16_t*>(x), static_cast<const float*>(dt),
        static_cast<const float*>(A), static_cast<const uint16_t*>(Bm),
        static_cast<float*>(states), static_cast<float*>(decays), S, H, P, G,
        N, Q, rows16(x, P) && rows16(Bm, N));
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// phase 2: states become the states entering each chunk; hout (B, H, P,
// N) f32 the final state
int ssd_state_pass_launch(void* states, const void* decays, void* hout,
                          int B, int H, int P, int N, int nc, void* stream) {
  if (B <= 0 || H <= 0 || P <= 0 || N <= 0 || nc <= 0 || H > 65535 ||
      B > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int PN = P * N;
  const dim3 grid((PN + kThreads - 1) / kThreads, H, B);
  ssd_state_pass<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(states), static_cast<const float*>(decays),
      static_cast<float*>(hout), H, PN, nc);
  return static_cast<int>(cudaGetLastError());
}

// phase 3: y (B, S, H, P) in x's dtype; a block owns HS heads of a group,
// and in bf16 runs ``groups`` (1 to 4) warp groups (f32: one 256-thread
// block, ``groups`` must be 1)
int ssd_chunk_scan_launch(const void* x, const void* dt, const void* A,
                          const void* Bm, const void* Cm, const void* Dv,
                          const void* states, void* y, int dtype, int B,
                          int S, int H, int P, int G, int N, int Q, int HS,
                          int groups, void* stream) {
  if (bad_shape(B, S, H, P, G, N, Q) || HS < 1 || groups < 1 ||
      groups > kMaxGroups || (dtype == 0 && groups != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  const int slices = (H / G + HS - 1) / HS;
  if (G * slices > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((S + Q - 1) / Q, G * slices, B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (dtype == 0) {
    const int bytes = ScanSmemF32(Q, N, P).bytes();
    static int allowed = 0;
    err = allow_smem(ssd_chunk_scan_f32, bytes, allowed);
    if (err != cudaSuccess) return static_cast<int>(err);
    ssd_chunk_scan_f32<<<grid, kThreads, bytes, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(dt),
        static_cast<const float*>(A), static_cast<const float*>(Bm),
        static_cast<const float*>(Cm), static_cast<const float*>(Dv),
        static_cast<const float*>(states), static_cast<float*>(y), S, H, P,
        G, N, Q, HS);
  } else if (dtype == 1) {
    const int bytes = tc::ScanSmem(Q, N, P, groups).bytes();
    static int allowed = 0;
    err = allow_smem(tc::ssd_chunk_scan_bf16, bytes, allowed);
    if (err != cudaSuccess) return static_cast<int>(err);
    tc::ssd_chunk_scan_bf16<<<grid, groups * kGroup, bytes, st>>>(
        static_cast<const uint16_t*>(x), static_cast<const float*>(dt),
        static_cast<const float*>(A), static_cast<const uint16_t*>(Bm),
        static_cast<const uint16_t*>(Cm), static_cast<const float*>(Dv),
        static_cast<const float*>(states), static_cast<__nv_bfloat16*>(y), S,
        H, P, G, N, Q, HS,
        rows16(x, P) && rows16(y, P) && rows16(Bm, N) && rows16(Cm, N));
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* ssd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
