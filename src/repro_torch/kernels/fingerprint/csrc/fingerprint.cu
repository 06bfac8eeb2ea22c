// Chunk fingerprint on Hopper (sm_90a): the paper's change detector (C1)
// on the device.
//
// Replaces the Pallas TPU kernel src/repro/kernels/fingerprint/kernel.py
// (_fp_kernel, launched by fingerprint_lanes). It computes the same
// function, not the same block structure:
//
//   lane u at position pos in its chunk row:
//     m = (u * C1) ^ (pos * C2 + C3);  m ^= m >> 15 (logical);  m *= C3
//   row fingerprint = (xor of m, sum of m mod 2^32), as int32 bit patterns.
//
// A row is `width` u32 lanes; lane p holds the little-endian value of the
// leaf's bytes [(row*width + p)*lb, +lb) with lb = min(itemsize, 4), so 8-
// and 16-bit values widen, bool reads as its 0/1 byte and 64-bit values
// split into low then high word (numpy's view(np.uint32) order). Lanes past
// the leaf's bytes are zero and are still mixed (the zero padding of a
// ragged last chunk is part of the fingerprint).
//
// Bound: bytes. Every leaf byte is read once (12.1 GB for full-width yi-6b
// in bf16), about 3.6 ms at the H100's 3.35 TB/s; the mix is ~9 integer
// operations per 32-bit lane. What the design does about it:
//   * Leaves are read IN PLACE through a small device table (pointer, bytes,
//     first row, width, lane bytes); the TPU path's padded
//     (total_chunks, max_lanes) u32 buffer is never built, which on a tree
//     of bf16 next to f32 leaves would double the bytes moved.
//   * One launch covers the whole tree: block b owns one 32 KiB tile of one
//     row. Each thread keeps 8 aligned 16-byte loads in flight, neighbouring
//     threads on neighbouring addresses.
//   * Blocks run in any order; a block reduces its tile in registers and
//     shared memory, then adds it into its row with one atomicXor and one
//     atomicAdd. Both are associative and commutative on 32-bit words, so
//     the table is bit-exact whatever the order.
//   * Rows that are not 16-byte aligned (odd chunk sizes, unaligned leaves)
//     take a per-lane path with the same result.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr uint32_t kC1 = 0x9E3779B9u;
constexpr uint32_t kC2 = 0x85EBCA6Bu;
constexpr uint32_t kC3 = 0xC2B2AE35u;
constexpr int kThreads = 256;
constexpr int kVecPerThread = 8;
constexpr int kTileBytes = kThreads * kVecPerThread * 16;  // 32 KiB

// One row of the (n_leaves, 6) uint64 table that ops.py builds.
struct Leaf {
  uint64_t data;        // device address of the leaf's first byte
  uint64_t n_bytes;     // bytes of data; lanes past them read as zero
  uint64_t first_row;   // first output row this leaf owns
  uint64_t width;       // lanes per row
  uint64_t lane_bytes;  // 1, 2 or 4
  uint64_t vec;         // 1: base and rows 16-byte aligned
};

__device__ __forceinline__ uint32_t mix(uint32_t u, uint32_t pos) {
  uint32_t m = (u * kC1) ^ (pos * kC2 + kC3);
  m ^= m >> 15;  // unsigned: a logical shift
  return m * kC3;
}

template <int LB>
__device__ __forceinline__ void mix_vec(uint4 v, uint32_t pos, uint32_t& x,
                                        uint32_t& s) {
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int k = 0; k < 4 / LB; ++k) {
      uint32_t u;
      if constexpr (LB == 4) u = w[i];
      else u = (w[i] >> (8 * LB * k)) & ((1u << (8 * LB)) - 1u);
      const uint32_t m = mix(u, pos + i * (4 / LB) + k);
      x ^= m;
      s += m;
    }
  }
}

// 16-byte path: the row is read as uint4 vectors.
template <int LB>
__device__ __forceinline__ void tile_vec(const Leaf& L, uint64_t row,
                                         uint32_t tile, uint32_t& x,
                                         uint32_t& s) {
  const uint8_t* base = reinterpret_cast<const uint8_t*>(L.data);
  const uint64_t row_bytes = L.width * LB;
  const uint64_t row_off = row * row_bytes;
  const uint64_t tile_off = static_cast<uint64_t>(tile) * kTileBytes;
  uint4 v[kVecPerThread];
#pragma unroll
  for (int i = 0; i < kVecPerThread; ++i) {
    const uint64_t off = tile_off + (uint64_t(i) * kThreads + threadIdx.x) * 16;
    v[i] = make_uint4(0u, 0u, 0u, 0u);
    if (off >= row_bytes) continue;
    const uint64_t g = row_off + off;
    if (g + 16 <= L.n_bytes) {
      v[i] = __ldg(reinterpret_cast<const uint4*>(base + g));
    } else if (g < L.n_bytes) {  // the leaf ends inside this vector
      uint32_t w[4] = {0u, 0u, 0u, 0u};
      for (uint64_t b = g; b < L.n_bytes; ++b)
        w[(b - g) >> 2] |= uint32_t(base[b]) << (8 * ((b - g) & 3));
      v[i] = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
#pragma unroll
  for (int i = 0; i < kVecPerThread; ++i) {
    const uint64_t off = tile_off + (uint64_t(i) * kThreads + threadIdx.x) * 16;
    if (off < row_bytes) mix_vec<LB>(v[i], static_cast<uint32_t>(off / LB), x, s);
  }
}

// Per-lane path for rows that are not 16-byte aligned.
__device__ __forceinline__ void tile_lane(const Leaf& L, uint64_t row,
                                          uint32_t tile, uint32_t& x,
                                          uint32_t& s) {
  const uint8_t* base = reinterpret_cast<const uint8_t*>(L.data);
  const uint64_t lb = L.lane_bytes;
  const uint64_t per_tile = kTileBytes / lb;
  const uint64_t p0 = uint64_t(tile) * per_tile;
  const uint64_t p1 = p0 + per_tile < L.width ? p0 + per_tile : L.width;
  for (uint64_t p = p0 + threadIdx.x; p < p1; p += kThreads) {
    const uint64_t off = (row * L.width + p) * lb;
    uint32_t u = 0u;
    if (off < L.n_bytes) {
      if (lb == 4) u = *reinterpret_cast<const uint32_t*>(base + off);
      else if (lb == 2) u = *reinterpret_cast<const uint16_t*>(base + off);
      else u = base[off];
    }
    const uint32_t m = mix(u, static_cast<uint32_t>(p));
    x ^= m;
    s += m;
  }
}

__global__ void __launch_bounds__(kThreads)
fp_kernel(const Leaf* __restrict__ leaves, int n_leaves,
          uint64_t tiles_per_row, uint32_t* __restrict__ out) {
  const uint64_t bid = blockIdx.x;
  const uint64_t grow = bid / tiles_per_row;
  const uint32_t tile = static_cast<uint32_t>(bid % tiles_per_row);
  int lo = 0, hi = n_leaves - 1;  // the last leaf whose first row <= grow
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (leaves[mid].first_row <= grow) lo = mid; else hi = mid - 1;
  }
  const Leaf L = leaves[lo];
  // tiles past this leaf's row width: nothing to add (uniform per block)
  if (uint64_t(tile) * kTileBytes >= L.width * L.lane_bytes) return;
  const uint64_t row = grow - L.first_row;

  uint32_t x = 0u, s = 0u;
  if (L.vec) {
    if (L.lane_bytes == 4) tile_vec<4>(L, row, tile, x, s);
    else if (L.lane_bytes == 2) tile_vec<2>(L, row, tile, x, s);
    else tile_vec<1>(L, row, tile, x, s);
  } else {
    tile_lane(L, row, tile, x, s);
  }

#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    x ^= __shfl_xor_sync(0xffffffffu, x, o);
    s += __shfl_xor_sync(0xffffffffu, s, o);
  }
  __shared__ uint32_t sx[kThreads / 32], ss[kThreads / 32];
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) {
    sx[warp] = x;
    ss[warp] = s;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kThreads / 32; ++w) {
      x ^= sx[w];
      s += ss[w];
    }
    atomicXor(out + 2 * grow, x);
    atomicAdd(out + 2 * grow + 1, s);
  }
}

}  // namespace

extern "C" {

int fp_tile_bytes() { return kTileBytes; }

// leaves: device (n_leaves, 6) uint64 table; out: device (total_rows, 2)
// int32, zeroed by the caller. Returns cudaGetLastError() after the launch.
int fp_launch(const void* leaves, int n_leaves, unsigned long long total_rows,
              unsigned long long tiles_per_row, void* out, void* stream) {
  const unsigned long long blocks = total_rows * tiles_per_row;
  if (blocks == 0 || n_leaves <= 0) return 0;
  if (blocks > 0x7fffffffULL) return static_cast<int>(cudaErrorInvalidConfiguration);
  fp_kernel<<<static_cast<unsigned int>(blocks), kThreads, 0,
              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const Leaf*>(leaves), n_leaves, tiles_per_row,
      static_cast<uint32_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

const char* fp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
