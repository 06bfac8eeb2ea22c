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
// f32 inputs: the same three phases, every product on the tensor cores as
// mma.sync m16n8k8 (tf32 x tf32 -> f32) taken three times, hi.hi + hi.lo
// + lo.hi of operands split as hi = tf32(v), lo = tf32(v - hi) (3xTF32),
// so that f32 meets 2e-5 whatever torch's allow_tf32 says; exp in IEEE
// expf. The f32 section below says how (namespace f32).
//
// Chunks: Q <= 128 steps (the wrapper halves Q where shared memory needs
// it; the function does not depend on Q). Any S: the last chunk may be
// short, its missing steps read as zero. The scratch states cost traffic
// the bound does not count: B chunks H P N 4 bytes, written by phase 1,
// read and written by phase 2, read by phase 3 (6.6 MB each pass at
// hymba's shape, 50 MB at mamba2-130m's N 128, in either dtype: both keep
// Q 128 there).

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

// the heads [h_lo, h_hi) of group g that a chunk-scan block owns: grid.y
// is G x slices, a slice HS heads of one group
__device__ __forceinline__ void block_heads(int H, int G, int HS, int& g,
                                            int& h_lo, int& h_hi) {
  const int slices = gridDim.y / G, hpg = H / G;
  g = blockIdx.y / slices;
  h_lo = g * hpg + (blockIdx.y % slices) * HS;
  h_hi = min(h_lo + HS, (g + 1) * hpg);
}

// dt of one head over the chunk's steps, zero past len
__device__ __forceinline__ void copy_dt(float* dst, const float* dt,
                                        size_t row0, int H, int h, int n,
                                        int len, int t, int nthr) {
  for (int i = t; i < n; i += nthr)
    hopper::cp_async4(dst + i, i < len ? dt + (row0 + i) * H + h : dt,
                      i < len ? 4u : 0u);
}

// stripe k (0 or 1) of warp w: w and nst - 1 - w, each stripe to the one
// warp w = min(s, nst - 1 - s) (nst <= 8, so w < 4); -1 if none
__device__ __forceinline__ int own_stripe(int w, int k, int nst) {
  if (k == 0) return 2 * w <= nst - 1 ? w : -1;
  return nst - 1 - w > w ? nst - 1 - w : -1;
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

// ------------------------------------------- the f32 (3xTF32) path
// Every product of phases 1 and 3 runs as mma.sync m16n8k8 (tf32 x tf32
// -> f32), three of them a product: hi.hi + hi.lo + lo.hi (lo.lo, 2^-22 of
// the product, dropped), each operand split as hi = tf32(v), lo = tf32(v -
// hi). A 3xTF32 product is three times the work of one: at mamba2-130m's
// shape (B 2, S 4096, H 24, P 64, N 128) the scan's 8.26 GFLOP are 0.050
// ms at the 495 TFLOP/s of the TF32 tensor cores against a 0.033 ms bytes
// bound (on the CUDA cores' 67 TFLOP/s the same flops alone would take
// 0.123 ms). What the design does:
//   * Short sums through the tensor cores, whose adder truncates where the
//     f32 ALU rounds: every product's contraction runs from zero 16 terms
//     at a time (six mma into a zeroed accumulator; scores . x 8 terms,
//     three mma, which keeps the chunk scan inside the 128 registers a
//     thread that 16 warps a SM leave), and the runs are added in f32
//     registers.
//   * The contraction order is permuted the same way for both operands (a
//     sum does not care), so that fragments come as few shared loads as
//     possible. Where the contraction runs along a tile's rows (K-major:
//     C, B and h_in over N), k-step 2 j takes columns 16 j + 4 t + {0, 1}
//     and k-step 2 j + 1 columns 16 j + 4 t + {2, 3} (t = lane % 4): one
//     float4 gives a lane its fragment of two k-steps; rows of stride
//     16 mod 32 floats put a quarter-warp's float4s on distinct banks.
//     Where it runs down the tile's columns (N-major: x and B over the
//     chunk's steps), k-step j takes rows 8 j + 2 t as fragment column t and
//     8 j + 2 t + 1 as column t + 4; rows of stride 4 mod 16 floats put the
//     lanes' single loads on distinct banks. In the chunk scan this order
//     makes C.B^T's accumulator of 8 keys, register for register, the A
//     fragment of scores . x over those keys: the scores never leave the
//     registers of the thread that applies their decay.
//   * Phase 1, grid (chunks, H, B), 8 warps: x and B come by cp.async, L
//     by a warp scan and w = exp(L_last - L) dt beside it; s = (x w)^T . B
//     in 32 x 32 tiles a warp, both operands split as their fragments
//     load, each A fragment used for 4 column tiles and each B fragment
//     for 2 row tiles. Where the state has fewer tiles than there are
//     warps (hymba's 64 x 16: two), the warps of a tile split its steps
//     and their sums are added in a fixed order through shared memory.
//   * Phase 3, grid (chunks, G x head slices, B), one block of 16 warps a
//     SM, on one head at a time: a warp owns one 16-row stripe of the
//     chunk and 32 of the 64 head-dim columns an item covers (P > 64 runs
//     in items of 64 columns). Warps w, w + 4, w + 8, w + 12 share a SM
//     sub-partition and hold stripes w and 7 - w, each twice (the
//     triangle's short and long rows): every sub-partition the same work.
//     (Each stripe's scores are decayed by its two warps. A stripe pair a
//     warp over 16 columns, every warp the same work, decays them four
//     times and took longer: the decay and the splits, not the mma, set
//     the pace.)
//     C.B^T is computed once a block and kept in fragment order in shared
//     memory (a stripe's key tiles split between its two warps). Per item,
//     in order: the incoming state's product C . h_in^T while x comes in
//     by cp.async; then exp(L) times it, the scores and scores . x, y = ..
//     + D x, while the next item's h_in and dt come in. Two barriers an
//     item; the cumsum is one warp's work beside the others' C . h_in^T.
//   * Splits: x's fragments in scores . x are read by up to 8 warps a
//     column, so each thread splits the x values it copied, once, into hi
//     and the exact rest v - hi (lo = tf32(rest) at load; x = hi + rest
//     for the D x term). C and h_in are split as their fragments load (C's
//     planes would not fit at N 128; h_in is read once an item by two
//     warps a row), each fragment serving all four column tiles or both
//     k-steps of a warp.
//   Shared memory (ScanSmemF32): C.B^T 36,864 B at Q 128, C [Qk][N + pad],
//   then a region that holds B for C.B^T and x's two planes after it,
//   h_in [64][N + pad], dt twice and L: 222,720 B at mamba2's N 128,
//   120,320 at hymba's N 16; one block a SM either way.
namespace f32 {

constexpr int kPass = 64;   // head-dim columns a chunk-scan item covers

// row strides (floats) of f32 tiles in shared memory, as above: K-major
// tiles (contraction along the row, float4 loads) 16 mod 32, N-major ones
// (contraction down the columns, single loads) 4 mod 16
__host__ __device__ constexpr int kmajor_stride(int n) {
  return round_up(n, 16) % 32 == 0 ? round_up(n, 16) + 16 : round_up(n, 16);
}
__host__ __device__ constexpr int nmajor_stride(int n) {
  return round_up(n, 16) + 4;
}

constexpr int kScanThreads = 512;   // the chunk scan's 16 warps

// phase 1: x [Qk][P + pad], B [Qk][N + pad] (whose room, once they are
// read, takes the warps' partial sums where kparts > 1: 8 warps x 32
// accumulators x 32 lanes), then L, dt, w [Qk]. kparts: the warps that
// share a 32 x 32 tile of the state: 8, 4 or 2 where it has 1, 2 or 3-4
// tiles.
struct StateSmemF32 {
  int Qk, xst, bst, kparts;
  __host__ __device__ StateSmemF32(int Q, int N, int P)
      : Qk(round_up(Q, 16)), xst(nmajor_stride(P)), bst(nmajor_stride(N)),
        kparts(0) {
    const int tiles = (P + 31) / 32 * ((N + 31) / 32);
    kparts = tiles == 1 ? 8 : tiles == 2 ? 4 : tiles <= 4 ? 2 : 1;
  }
  __host__ __device__ int tile_floats() const {
    return max_of(Qk * (xst + bst), kparts > 1 ? 8 * 32 * 32 : 0);
  }
  __host__ __device__ int bytes() const {
    return 4 * (tile_floats() + 3 * Qk);
  }
};

// phase 3: C.B^T in fragment order (as tc::ScanSmem), C [Qk][cst], the
// region (B [Qk][cst], then x's hi [Qk][xst] and its rest after it),
// h_in [kPass][cst], dt [2][Qk], L [Qk]
struct ScanSmemF32 {
  int Qk, nst, cst, xst;
  __host__ __device__ ScanSmemF32(int Q, int N)
      : Qk(round_up(Q, 16)), nst(round_up(Q, 16) / 16),
        cst(kmajor_stride(N)), xst(nmajor_stride(kPass)) {}
  __host__ __device__ int cb_bytes() const { return nst * (nst + 1) * 512; }
  __host__ __device__ int region_floats() const {
    return max_of(Qk * cst, 2 * Qk * xst);
  }
  __host__ __device__ int bytes() const {
    return cb_bytes() +
           4 * (Qk * cst + region_floats() + kPass * cst + 3 * Qk);
  }
};

// Rows [0, rows) of ``cols`` floats into shared memory (row r at dst + r
// dst_stride), row r read at src + r src_stride, rows >= valid zero; by
// threads t, t + nthr, .. of the caller, as cp.async copies that the
// caller commits and waits for: 16 bytes each with ``vec`` (cols % 4 ==
// 0, src and its rows 16-byte aligned), else 4. Columns past cols are not
// written.
__device__ __forceinline__ void copy_rows(float* dst, int dst_stride,
                                          const float* src,
                                          size_t src_stride, int rows,
                                          int valid, int cols, bool vec,
                                          int t, int nthr) {
  if (vec) {
    const int per = cols / 4;
    for (int e = t; e < rows * per; e += nthr) {
      const int r = e / per, c = 4 * (e % per);
      hopper::cp_async16(dst + r * dst_stride + c,
                         r < valid ? src + r * src_stride + c : src,
                         r < valid ? 16u : 0u);
    }
  } else {
    for (int e = t; e < rows * cols; e += nthr) {
      const int r = e / cols, c = e % cols;
      hopper::cp_async4(dst + r * dst_stride + c,
                        r < valid ? src + r * src_stride + c : src,
                        r < valid ? 4u : 0u);
    }
  }
}

// The values copy_rows copied for thread t, once they have landed (the
// same arguments): each v becomes hi = tf32(v) in place, and the exact
// rest v - hi goes to the same place in ``rest``.
__device__ __forceinline__ void split_rows(float* dst, float* rest,
                                           int dst_stride, int rows,
                                           int cols, bool vec, int t,
                                           int nthr) {
  auto hi = [](float v) { return __uint_as_float(hopper::to_tf32(v)); };
  if (vec) {
    const int per = cols / 4;
    for (int e = t; e < rows * per; e += nthr) {
      const int off = e / per * dst_stride + 4 * (e % per);
      const float4 v = *reinterpret_cast<const float4*>(dst + off);
      const float4 h = make_float4(hi(v.x), hi(v.y), hi(v.z), hi(v.w));
      *reinterpret_cast<float4*>(dst + off) = h;
      *reinterpret_cast<float4*>(rest + off) =
          make_float4(v.x - h.x, v.y - h.y, v.z - h.z, v.w - h.w);
    }
  } else {
    for (int e = t; e < rows * cols; e += nthr) {
      const int off = e / cols * dst_stride + e % cols;
      const float v = dst[off], h = hi(v);
      dst[off] = h;
      rest[off] = v - h;
    }
  }
}

// the A fragment of k-step ks (0 or 1) from float4s of a K-major tile's
// rows g and g + 8 (see above), split
__device__ __forceinline__ void split_a(const float4& r0, const float4& r1,
                                        int ks, uint32_t (&ah)[4],
                                        uint32_t (&al)[4]) {
  const float a[4] = {ks ? r0.z : r0.x, ks ? r1.z : r1.x,
                      ks ? r0.w : r0.y, ks ? r1.w : r1.y};
#pragma unroll
  for (int i = 0; i < 4; ++i) hopper::split_tf32(a[i], ah[i], al[i]);
}

// ------------------------------------------------ phase 1: chunk state
// grid (chunks, H, B). ``vec``: bit 0, x's rows can be copied 16 bytes at
// a time; bit 1, B's.
__global__ void __launch_bounds__(kThreads, 2)
ssd_chunk_state(const float* __restrict__ x, const float* __restrict__ dt,
                const float* __restrict__ A, const float* __restrict__ Bm,
                float* __restrict__ states, float* __restrict__ decays,
                int S, int H, int P, int G, int N, int Q, int vec) {
  extern __shared__ float4 smem4[];
  const StateSmemF32 lay(Q, N, P);
  float* xs = reinterpret_cast<float*>(smem4);   // [Qk][xst]
  float* bs = xs + lay.Qk * lay.xst;             // [Qk][bst]
  float* Ls = xs + lay.tile_floats();            // [Qk]
  float* dts = Ls + lay.Qk;                      // [Qk]
  float* ws = dts + lay.Qk;                      // [Qk] exp(L_last - L) dt

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  const int c = blockIdx.x, h = blockIdx.y, b = blockIdx.z, nc = gridDim.x;
  const int c0 = c * Q, len = min(Q, S - c0);
  const int grp = h / (H / G);
  const size_t row0 = static_cast<size_t>(b) * S + c0;

  copy_dt(dts, dt, row0, H, h, lay.Qk, len, tid, kThreads);
  copy_rows(xs, lay.xst, x + (row0 * H + h) * P, static_cast<size_t>(H) * P,
            lay.Qk, len, P, vec & 1, tid, kThreads);
  copy_rows(bs, lay.bst, Bm + (row0 * G + grp) * N,
            static_cast<size_t>(G) * N, lay.Qk, len, N, vec & 2, tid,
            kThreads);
  hopper::cp_async_wait_all();
  __syncthreads();
  if (warp == 0) {
    chunk_cumsum(dts, A[h], Ls, lay.Qk);
    __syncwarp();
    const float l_last = Ls[len - 1];
    for (int j = lane; j < lay.Qk; j += 32)
      ws[j] = j < len ? expf(l_last - Ls[j]) * dts[j] : 0.f;
  }
  __syncthreads();

  // s[p][n] = sum_j (x w)[j][p] B[j][n] in 32 x 32 tiles, rows p0 + 16 mt
  // + .., columns n0 + 8 nt + ..: one warp a tile, or, where there are at
  // most 4 tiles, kparts warps a tile, each over its own steps, their sums
  // added in a fixed order
  float* out = states + ((static_cast<size_t>(b) * nc + c) * H + h) * P * N;
  const int ntn = (N + 31) / 32, tiles = (P + 31) / 32 * ntn;
  const int kparts = lay.kparts, span = round_up(lay.Qk / kparts, 16);
  auto tile = [&](int wt, int j_lo, int j_hi, float (&acc)[2][4][4]) {
    const int p0 = wt / ntn * 32, n0 = wt % ntn * 32;
    const bool two = p0 + 16 < P;   // the second 16-row tile holds rows
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;
    for (int j0 = j_lo; j0 < min(len, j_hi); j0 += 16) {
      float part[2][4][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[mt][nt][e] = 0.f;
#pragma unroll
      for (int ks = 0; ks < 2; ++ks) {
        const int j = j0 + 8 * ks + 2 * t;   // steps j (column t), j + 1
        const float w0 = ws[j], w1 = ws[j + 1];
        const float* br = bs + j * lay.bst + n0 + g;
        uint32_t bh[4][2], bl[4][2];
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const bool in = n0 + 8 * nt < N;
          hopper::split_tf32(in ? br[8 * nt] : 0.f, bh[nt][0], bl[nt][0]);
          hopper::split_tf32(in ? br[lay.bst + 8 * nt] : 0.f, bh[nt][1],
                             bl[nt][1]);
        }
        const float* xr = xs + j * lay.xst + p0 + g;
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          if (mt == 1 && !two) break;
          const float a[4] = {xr[16 * mt] * w0, xr[16 * mt + 8] * w0,
                              xr[lay.xst + 16 * mt] * w1,
                              xr[lay.xst + 16 * mt + 8] * w1};
          uint32_t ah[4], al[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) hopper::split_tf32(a[i], ah[i], al[i]);
          hopper::mma3_tf32<4>(part[mt], ah, al, bh, bl);
        }
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] += part[mt][nt][e];
    }
  };
  auto store = [&](int wt, const float (&acc)[2][4][4]) {
    const int p0 = wt / ntn * 32, n0 = wt % ntn * 32;
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int p = p0 + 16 * mt + g + (e < 2 ? 0 : 8);
          const int n = n0 + 8 * nt + 2 * t + (e & 1);
          if (p < P && n < N) out[p * N + n] = acc[mt][nt][e];
        }
  };
  float acc[2][4][4];
  if (kparts == 1) {
    for (int wt = warp; wt < tiles; wt += kThreads / 32) {
      tile(wt, 0, lay.Qk, acc);
      store(wt, acc);
    }
  } else {
    const int wt = warp / kparts, kp = warp % kparts;
    const bool busy = wt < tiles;
    if (busy) tile(wt, kp * span, (kp + 1) * span, acc);
    __syncthreads();   // x and B are read: their room takes the parts
    float* parts = xs;   // [warp][32 accumulators][32 lanes]
    if (busy && kp > 0) {
#pragma unroll
      for (int r = 0; r < 32; ++r)
        parts[(warp * 32 + r) * 32 + lane] = acc[r / 16][r / 4 % 4][r % 4];
    }
    __syncthreads();
    if (busy && kp == 0) {
      for (int q = 1; q < kparts; ++q) {
#pragma unroll
        for (int r = 0; r < 32; ++r)
          acc[r / 16][r / 4 % 4][r % 4] +=
              parts[((warp + q) * 32 + r) * 32 + lane];
      }
      store(wt, acc);
    }
  }
  if (tid == 0)
    decays[(static_cast<size_t>(b) * nc + c) * H + h] = expf(Ls[len - 1]);
}

// ------------------------------------------------- phase 3: chunk scan
// grid (chunks, G x slices, B), 16 warps. ``vec``: bit 0, x's rows can be
// copied 16 bytes at a time; bit 1, B's and C's; bit 2, h_in's (N % 4 ==
// 0); bit 3, y can be written two floats at a time (P even, y 8-byte
// aligned).
__global__ void __launch_bounds__(kScanThreads, 1)
ssd_chunk_scan(const float* __restrict__ x, const float* __restrict__ dt,
               const float* __restrict__ A, const float* __restrict__ Bm,
               const float* __restrict__ Cm, const float* __restrict__ Dv,
               const float* __restrict__ states, float* __restrict__ y,
               int S, int H, int P, int G, int N, int Q, int HS, int vec) {
  extern __shared__ float4 smem4[];
  const ScanSmemF32 lay(Q, N);
  const int Qk = lay.Qk, cst = lay.cst, xst = lay.xst;
  float4* cbf = smem4;                                    // C.B^T
  float* cs = reinterpret_cast<float*>(
      reinterpret_cast<char*>(smem4) + lay.cb_bytes());   // C [Qk][cst]
  float* bs = cs + Qk * cst;         // B [Qk][cst], at first
  float* xs = bs;                    // then x's hi [Qk][xst]
  float* xr = xs + Qk * xst;         // and its rest
  float* hs = bs + lay.region_floats();   // h_in [kPass][cst]
  float* dts = hs + kPass * cst;     // [2][Qk], by item parity
  float* Ls = dts + 2 * Qk;          // [Qk]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;
  // this warp's stripe (rows 16 st ..; -1: none) and columns pw .. pw + 31
  // of an item; warps w, w + 4, w + 8, w + 12 share a SM sub-partition and
  // hold stripes w, 7 - w (twice): the same work for each sub-partition
  const int st = own_stripe(warp % 4, warp / 4 % 2, lay.nst);
  const int pw = 32 * (warp / 8);
  const int c = blockIdx.x, b = blockIdx.z, nc = gridDim.x;
  int grp, h_lo, h_hi;
  block_heads(H, G, HS, grp, h_lo, h_hi);
  const int c0 = c * Q, len = min(Q, S - c0);
  const bool on = st >= 0 && 16 * st < len;   // the stripe holds rows
  const size_t row0 = static_cast<size_t>(b) * S + c0;
  const int Nk = round_up(N, 16);
  const int passes = (P + kPass - 1) / kPass;
  const int items = (h_hi - h_lo) * passes;
  const bool xvec = vec & 1, hvec = vec & 4, y2 = vec & 8;

  // the item's h_in rows (the state entering this chunk, P x N, rows of
  // the item's columns) and its head's dt, into buffer it & 1
  auto fetch_state = [&](int it) {
    const int h = h_lo + it / passes, p0 = it % passes * kPass;
    copy_rows(hs, cst,
              states + ((static_cast<size_t>(b) * nc + c) * H + h) * P * N +
                  static_cast<size_t>(p0) * N,
              N, kPass, min(kPass, P - p0), N, hvec, tid, kScanThreads);
    copy_dt(dts + (it & 1) * Qk, dt, row0, H, h, Qk, len, tid,
            kScanThreads);
    hopper::cp_async_commit();
  };

  // the contraction's pad, columns [N, Nk) of C, B and h_in: zero, and
  // never written by the copies
  for (int e = tid; e < (2 * Qk + kPass) * (Nk - N); e += kScanThreads) {
    const int r = e / (Nk - N), col = N + e % (Nk - N);
    float* row = r < Qk ? cs + r * cst
                        : r < 2 * Qk ? bs + (r - Qk) * cst
                                     : hs + (r - 2 * Qk) * cst;
    row[col] = 0.f;
  }
  copy_rows(cs, cst, Cm + (row0 * G + grp) * N, static_cast<size_t>(G) * N,
            Qk, len, N, vec & 2, tid, kScanThreads);
  copy_rows(bs, cst, Bm + (row0 * G + grp) * N, static_cast<size_t>(G) * N,
            Qk, len, N, vec & 2, tid, kScanThreads);
  hopper::cp_async_commit();
  fetch_state(0);
  hopper::cp_async_wait<1>();
  __syncthreads();

  // C . B^T once for every head of the block: stripe st (rows 16 st ..)
  // against key tiles 0 .. 2 st + 1, the first st + 1 of them by the warp
  // of columns 0 .. 31, the rest by the warp of columns 32 ..; 4 key
  // tiles at a time
  if (st >= 0) {
    const int lo = pw ? st + 1 : 0, hi = lo + st + 1;
    const float* cr = cs + (16 * st + g) * cst + 4 * t;
#pragma unroll 1
    for (int j0 = lo; j0 < hi; j0 += 4) {
      float acc[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
#pragma unroll 1
      for (int kb = 0; kb < Nk; kb += 16) {
        const float4 c0v = *reinterpret_cast<const float4*>(cr + kb);
        const float4 c1v = *reinterpret_cast<const float4*>(cr + 8 * cst + kb);
        float4 bv[4];
#pragma unroll
        for (int n = 0; n < 4; ++n)
          bv[n] = j0 + n < hi
                      ? *reinterpret_cast<const float4*>(
                            bs + (8 * (j0 + n) + g) * cst + kb + 4 * t)
                      : make_float4(0.f, 0.f, 0.f, 0.f);
        float part[4][4];
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[n][e] = 0.f;
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          uint32_t ah[4], al[4], bh[4][2], bl[4][2];
          split_a(c0v, c1v, ks, ah, al);
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            hopper::split_tf32(ks ? bv[n].z : bv[n].x, bh[n][0], bl[n][0]);
            hopper::split_tf32(ks ? bv[n].w : bv[n].y, bh[n][1], bl[n][1]);
          }
          hopper::mma3_tf32<4>(part, ah, al, bh, bl);
        }
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[n][e] += part[n][e];
      }
#pragma unroll
      for (int n = 0; n < 4; ++n)
        if (j0 + n < hi)
          cbf[st * (st + 1) * 32 + (j0 + n) * 32 + lane] =
              make_float4(acc[n][0], acc[n][1], acc[n][2], acc[n][3]);
    }
  }

#pragma unroll 1
  for (int it = 0; it < items; ++it) {
    const int h = h_lo + it / passes, p0 = it % passes * kPass;
    const int pc = min(kPass, P - p0);   // the item's columns
    const bool busy = on && pw < pc;     // this warp has some of them
    hopper::cp_async_wait<0>();          // h_in and dt of item it
    __syncthreads();   // .. are in; x, L and dt of item it - 1 are read
    copy_rows(xs, xst, x + (row0 * H + h) * P + p0,
              static_cast<size_t>(H) * P, Qk, len, pc, xvec, tid,
              kScanThreads);
    hopper::cp_async_commit();
    const float* dtc = dts + (it & 1) * Qk;
    if (warp == 0) chunk_cumsum(dtc, A[h], Ls, Qk);

    // the incoming state: C . h_in^T, rows of the stripe, columns pw ..
    // pw + 31 of the item
    float acc[4][4];
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
    if (busy) {
      const float* cr = cs + (16 * st + g) * cst + 4 * t;
      const float* hr = hs + (pw + g) * cst + 4 * t;
#pragma unroll 1
      for (int kb = 0; kb < Nk; kb += 16) {
        const float4 c0v = *reinterpret_cast<const float4*>(cr + kb);
        const float4 c1v = *reinterpret_cast<const float4*>(cr + 8 * cst + kb);
        float4 hv[4];
#pragma unroll
        for (int n = 0; n < 4; ++n)
          hv[n] = *reinterpret_cast<const float4*>(hr + 8 * n * cst + kb);
        float part[4][4];
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[n][e] = 0.f;
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          uint32_t ah[4], al[4], bh[4][2], bl[4][2];
          split_a(c0v, c1v, ks, ah, al);
#pragma unroll
          for (int n = 0; n < 4; ++n) {
            hopper::split_tf32(ks ? hv[n].z : hv[n].x, bh[n][0], bl[n][0]);
            hopper::split_tf32(ks ? hv[n].w : hv[n].y, bh[n][1], bl[n][1]);
          }
          hopper::mma3_tf32<4>(part, ah, al, bh, bl);
        }
#pragma unroll
        for (int n = 0; n < 4; ++n)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[n][e] += part[n][e];
      }
    }

    hopper::cp_async_wait<0>();   // x of item it, split once
    split_rows(xs, xr, xst, Qk, pc, xvec, tid, kScanThreads);
    __syncthreads();   // x, L and C.B^T are in; h_in is read
    if (it + 1 < items) fetch_state(it + 1);
    if (!busy) continue;

    // exp(L) on the incoming state's part, row by row
    const int i0 = 16 * st + g, i1 = i0 + 8;   // this thread's rows
    const float L0 = Ls[i0], L1 = Ls[i1];
    const float el0 = expf(L0), el1 = expf(L1);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      acc[n][0] *= el0;
      acc[n][1] *= el0;
      acc[n][2] *= el1;
      acc[n][3] *= el1;
    }

    // scores . x over keys 0 .. 16 st + 15, one tile of 8 keys at a time
    // (each tile's sum from zero, added in f32); each key tile's C.B^T
    // accumulator, decayed and selected below the diagonal, is the A
    // fragment in place
    const float4* cb = cbf + st * (st + 1) * 32 + lane;
#pragma unroll 1
    for (int jt = 0; jt < 2 * st + 2; ++jt) {
      const int j = 8 * jt + 2 * t;   // keys j (column t), j + 1 (t + 4)
      uint32_t bh[4][2], bl[4][2];
      const int xo = j * xst + pw + g;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          bh[n][r] = __float_as_uint(xs[xo + r * xst + 8 * n]);
          bl[n][r] = hopper::to_tf32(xr[xo + r * xst + 8 * n]);
        }
      }
      const float Lj0 = Ls[j], Lj1 = Ls[j + 1];
      const float d0 = dtc[j], d1 = dtc[j + 1];
      const float4 s = cb[jt * 32];
      // (i0, j), (i1, j), (i0, j + 1), (i1, j + 1)
      const float a[4] = {j <= i0 ? s.x * expf(L0 - Lj0) * d0 : 0.f,
                          j <= i1 ? s.z * expf(L1 - Lj0) * d0 : 0.f,
                          j + 1 <= i0 ? s.y * expf(L0 - Lj1) * d1 : 0.f,
                          j + 1 <= i1 ? s.w * expf(L1 - Lj1) * d1 : 0.f};
      uint32_t ah[4], al[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) hopper::split_tf32(a[i], ah[i], al[i]);
      float part[4][4];
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[n][e] = 0.f;
      hopper::mma3_tf32<4>(part, ah, al, bh, bl);
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[n][e] += part[n][e];
    }

    // y = .. + D x (x = hi + rest): rows i0, i1, columns 2 t, 2 t + 1 of
    // each 8-column tile
    const float dh = Dv[h];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int i = r ? i1 : i0;
      if (i >= len) continue;
      float* yr = y + ((row0 + i) * H + h) * P + p0;
#pragma unroll
      for (int n = 0; n < 4; ++n) {
        const int col = pw + 8 * n + 2 * t;
        if (col >= pc) continue;
        const int xo = i * xst + col;
        const float v0 = acc[n][2 * r] + (xs[xo] + xr[xo]) * dh;
        const float v1 = acc[n][2 * r + 1] + (xs[xo + 1] + xr[xo + 1]) * dh;
        if (y2 && col + 1 < pc) {
          *reinterpret_cast<float2*>(yr + col) = make_float2(v0, v1);
        } else {
          yr[col] = v0;
          if (col + 1 < pc) yr[col + 1] = v1;
        }
      }
    }
  }
}

}  // namespace f32

// whether the rows of a bf16 tensor whose innermost dim is ``n`` can move
// 16 bytes at a time: n % 8 == 0 and the data 16-byte aligned
bool rows16(const void* p, int n) {
  return n % 8 == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

// the same for an f32 tensor: n % 4 == 0 and the data 16-byte aligned
bool rows16_f32(const void* p, int n) {
  return n % 4 == 0 && reinterpret_cast<uintptr_t>(p) % 16 == 0;
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
  if (phase == 1 && dtype == 0) return f32::StateSmemF32(Q, N, P).bytes();
  if (phase == 1 && dtype == 1) return tc::StateSmem(Q, N, P).bytes();
  if (phase == 3 && dtype == 0) return f32::ScanSmemF32(Q, N).bytes();
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
    const int bytes = f32::StateSmemF32(Q, N, P).bytes();
    static int allowed = 0;
    err = allow_smem(f32::ssd_chunk_state, bytes, allowed);
    if (err != cudaSuccess) return static_cast<int>(err);
    f32::ssd_chunk_state<<<grid, kThreads, bytes, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(dt),
        static_cast<const float*>(A), static_cast<const float*>(Bm),
        static_cast<float*>(states), static_cast<float*>(decays), S, H, P, G,
        N, Q, rows16_f32(x, P) | rows16_f32(Bm, N) << 1);
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
// and in bf16 runs ``groups`` (1 to 4) warp groups (f32: 16 warps on one
// head at a time, ``groups`` must be 1)
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
    const int bytes = f32::ScanSmemF32(Q, N).bytes();
    const int vec = rows16_f32(x, P) |
                    (rows16_f32(Bm, N) && rows16_f32(Cm, N)) << 1 |
                    rows16_f32(states, N) << 2 |
                    (P % 2 == 0 && reinterpret_cast<uintptr_t>(y) % 8 == 0)
                        << 3;
    static int allowed = 0;
    err = allow_smem(f32::ssd_chunk_scan, bytes, allowed);
    if (err != cudaSuccess) return static_cast<int>(err);
    f32::ssd_chunk_scan<<<grid, f32::kScanThreads, bytes, st>>>(
        static_cast<const float*>(x), static_cast<const float*>(dt),
        static_cast<const float*>(A), static_cast<const float*>(Bm),
        static_cast<const float*>(Cm), static_cast<const float*>(Dv),
        static_cast<const float*>(states), static_cast<float*>(y), S, H, P,
        G, N, Q, HS, vec);
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
