// Helpers shared by the attention forward and backward kernels
// (attention_fwd.cu, attention_bwd.cu), both routes: the dropout
// keep-mask, and the f32 tile staging of the FMA route (f32 inputs, or
// 128 < T <= 512). The tensor-core route's pieces are in attention_mma.cuh.
//
// Layout: q, k, v (and do, dq, dk, dv) are (B, T, H) with H = heads * 64,
// head h in columns [64h, 64h + 64). A block of the FMA route stages
// 64-row tiles of one head as f32 in shared memory with the odd row stride
// 65, so the 16 rows a warp touches fall in distinct banks.
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

constexpr int kHeadDim = 64;
constexpr int kTile = 64;              // rows per tile (queries or keys)
constexpr int kThreads = 128;          // two threads per tile row
constexpr int kStride = kHeadDim + 1;  // shared-memory row stride of a tile
constexpr int kCols = kTile / 2;       // columns each thread owns in a tile
constexpr float kBigNeg = -3e7f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ float round_as(float x, float) { return x; }
__device__ __forceinline__ float round_as(float x, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(x));
}

// Rows [row0, row0 + kTile) of one head's (T, 64) slice into shared memory
// as f32; rows at or past T read as zero. src points at (b, 0, 64 * head).
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          int row0, int seq, int hidden) {
  for (int i = threadIdx.x; i < kTile * kHeadDim; i += kThreads) {
    const int r = i / kHeadDim;
    const int d = i % kHeadDim;
    const int row = row0 + r;
    dst[r * kStride + d] = row < seq ? to_f32(src[(size_t)row * hidden + d]) : 0.f;
  }
}

__device__ __forceinline__ float warp_max(float x) {
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
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

}  // namespace attn
