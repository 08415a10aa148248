// Helpers shared by the attention forward and backward kernels
// (attention_fwd.cu, attention_bwd.cu), all routes: the dropout keep-mask,
// and the f32 tile arithmetic of the FMA route (f32 inputs, or bf16 with a
// head dim over 256). The tensor-core routes' pieces are in
// attention_mma.cuh.
//
// Layout: q, k, v (and do, dq, dk, dv) are (B, T, H) with H = heads * d,
// head h in columns [d h, d h + d), d any multiple of 8. A block of the
// FMA route stages 64 x 64 pieces of one head (64 rows, 64 of its d
// columns) as f32 in shared memory with the odd row stride 65, so the 16
// rows a warp touches fall in distinct banks; a head dim over 64 is walked
// in such pieces, and so is T, so the route takes any d and any T in
// 49,920 bytes of shared memory.
//
// Dropout keep-mask: the counter hash of the JAX package's interpret mode
// (imagegenerator_tpu/ops/pallas/attention.py::_hash_bits, _keep_mask).
// For batch row b, head h, query r and key c:
//   salt = seed + b * 1000003 + h * 7919            (wrapping 32-bit)
//   x    = r * 0x9E3779B9 + c * 0x85EBCA6B + salt * 0xC2B2AE35
//   x    = murmur3 finalizer of x
//   keep = x >= thresh,  thresh = min(rate * 2^32, 2^32 - 1)
// Forward, backward and the plain PyTorch version draw the same bits, so
// no mask is stored and the kernels can be held to the plain version with
// dropout on.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stddef.h>

namespace attn {

constexpr int kTile = 64;              // rows (queries or keys) and head dims of a piece
constexpr int kThreads = 128;          // two threads per row of a piece
constexpr int kStride = kTile + 1;     // shared-memory row stride of a piece
constexpr int kCols = kTile / 2;       // columns each thread owns in a piece
constexpr float kBigNeg = -3e7f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float round_as(float x, float) { return x; }
__device__ __forceinline__ float round_as(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(x));
}

// The salt of (seed, batch row, head), wrapping as the JAX int32 sum does.
__device__ __forceinline__ unsigned dropout_salt(int seed, int b, int head) {
  return (unsigned)seed + (unsigned)b * 1000003u + (unsigned)head * 7919u;
}

// The murmur3 finalizer.
__device__ __forceinline__ unsigned hash_finish(unsigned x) {
  x ^= x >> 16;
  x *= 0x7FEB352Du;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 16;
  return x;
}

__device__ __forceinline__ unsigned hash_bits(unsigned r, unsigned c, unsigned salt) {
  return hash_finish(r * 0x9E3779B9u + c * 0x85EBCA6Bu + salt * 0xC2B2AE35u);
}

// Dropout arguments passed by value from the wrapper.
struct Dropout {
  int on;           // 0: rate 0, no mask
  int seed;         // base seed (int32)
  unsigned thresh;  // keep iff bits >= thresh
  float inv_keep;   // 1 / (1 - rate) as f32
};

// keep * inv_keep for (query r, key c): inv_keep or 0.
__device__ __forceinline__ float keep_scale(const Dropout& dr, unsigned salt, int r, int c) {
  return hash_bits((unsigned)r, (unsigned)c, salt) >= dr.thresh ? dr.inv_keep : 0.f;
}

// A scaled score with the key-padding mask applied (-3e7 where mask <= 0).
__device__ __forceinline__ float masked_score(float dot, float scale, const int* mask_row, int col) {
  return mask_row != nullptr && mask_row[col] <= 0 ? kBigNeg : dot * scale;
}

// ------------------------------------------------------------- FMA route
//
// A block of kThreads works on 64 rows of one (batch row, head); thread
// tid owns row tid / 2 and the 32 interleaved columns 2 c + tid % 2 of a
// 64-wide piece, with one shared-memory load per FMA.

// Rows [row0, row0 + 64) and columns [col0, col0 + 64) of one head's
// (T, d) slice into shared memory as f32; rows at or past T and columns
// at or past d read as zero. src points at (b, 0, d * head).
template <typename T>
__device__ __forceinline__ void load_piece(float* dst, const T* __restrict__ src, int row0, int col0,
                                           int seq, int hidden, int dim) {
  for (int i = threadIdx.x; i < kTile * kTile; i += kThreads) {
    const int r = i / kTile;
    const int c = i % kTile;
    const int row = row0 + r;
    const int col = col0 + c;
    dst[r * kStride + c] = row < seq && col < dim ? to_f32(src[(size_t)row * hidden + col]) : 0.f;
  }
}

// acc[c] += A[a0 + row] . B[b0 + 2 c + half] over the head's d columns,
// for the thread's row and columns: A and B are two (T, d) slices, walked
// in 64-wide pieces of d through the shared tiles as_ and bs_. Starts and
// ends with the block in step (it begins with a barrier).
template <typename T>
__device__ __forceinline__ void fma_nt(float (&acc)[kCols], float* as_, float* bs_,
                                       const T* __restrict__ a, int a0, const T* __restrict__ b,
                                       int b0, int seq, int hidden, int dim) {
  const int row = threadIdx.x >> 1;
  const int half = threadIdx.x & 1;
  for (int c0 = 0; c0 < dim; c0 += kTile) {
    __syncthreads();
    load_piece(as_, a, a0, c0, seq, hidden, dim);
    load_piece(bs_, b, b0, c0, seq, hidden, dim);
    __syncthreads();
    const int n = min(kTile, dim - c0);
    for (int d = 0; d < n; ++d) {
      const float x = as_[row * kStride + d];
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[c] = fmaf(x, bs_[(2 * c + half) * kStride + d], acc[c]);
    }
  }
}

// acc[c] += sum_j P[row][j] X[x0 + j][c0 + 2 c + half]: P a 64 x 64 tile
// the block wrote to shared memory (ps), X a (T, d) slice staged 64 rows
// and 64 columns at a time through xs. Begins with a barrier, so the
// writes to ps before the call are seen.
template <typename T>
__device__ __forceinline__ void fma_nn(float (&acc)[kCols], const float* ps, float* xs,
                                       const T* __restrict__ x, int x0, int c0, int seq, int hidden,
                                       int dim) {
  const int row = threadIdx.x >> 1;
  const int half = threadIdx.x & 1;
  __syncthreads();
  load_piece(xs, x, x0, c0, seq, hidden, dim);
  __syncthreads();
  const int n = min(kTile, seq - x0);
  for (int j = 0; j < n; ++j) {
    const float p = ps[row * kStride + j];
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[c] = fmaf(p, xs[j * kStride + 2 * c + half], acc[c]);
  }
}

// The thread's 32 columns of a 64-wide piece of an output row, those
// before d, divided by div (1 leaves them as they are), as T.
template <typename T>
__device__ __forceinline__ void store_piece(T* __restrict__ dst_row, const float (&acc)[kCols],
                                            int c0, int dim, float div) {
  const int half = threadIdx.x & 1;
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const int col = c0 + 2 * c + half;
    if (col < dim) store(dst_row + col, acc[c] / div);
  }
}

}  // namespace attn
