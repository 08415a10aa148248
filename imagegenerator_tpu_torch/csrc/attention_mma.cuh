// Tensor-core building blocks of the bf16 attention kernels for T <= 128
// (attention_fwd.cu, attention_bwd.cu): cp.async tile loads, ldmatrix
// fragment loads, the mma.sync m16n8k16 product and the three products
// the kernels are made of.
//
// Shared-memory layout: one head's (T, 64) slice of q, k, v or do is a
// tile of bf16 rows of kRow = 72 elements (144 bytes: 64 values and 16
// bytes of padding); a (T, T) tile has rows of kPRow = 136 elements (272
// bytes). Both strides are an odd number of 16-byte units, so the eight
// row addresses of an ldmatrix fall in eight different bank groups and
// the fragment stores of a warp (8 rows x 4 lanes x 4 bytes) in 32
// different banks. Rows at or past T are zero.
//
// Fragments of mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32, for
// lane = 4 g + t:
//   A (16 x 16): a0 = (row g, k 2t..2t+1), a1 = (row g + 8, same k),
//                a2 = (row g, k 2t+8..2t+9), a3 = (row g + 8, same k)
//   B (16 x 8):  b0 = (k 2t..2t+1, n g), b1 = (k 2t+8..2t+9, n g)
//   C (16 x 8):  c0, c1 = (row g, n 2t, 2t+1), c2, c3 = (row g + 8, same n)
// A warp owns 16 rows of a product. Its C tiles over 128 columns (16 tiles
// of 8) are 64 f32 registers a thread; two neighbouring C tiles, rounded to
// bf16, are the A fragment of the next product with no trip through shared
// memory (pack_a).

#pragma once

#include "attention_common.cuh"

#include <stdint.h>

namespace attn {
namespace mma {

constexpr int kMaxSeq = 128;         // queries and keys of one head
constexpr int kRow = kHeadDim + 8;   // bf16 per shared-memory row of a (T, 64) tile
constexpr int kPRow = kMaxSeq + 8;   // bf16 per shared-memory row of a (T, T) tile
constexpr int kKeyTiles = kMaxSeq / 8;   // C tiles of 8 keys over a score row
constexpr int kDimTiles = kHeadDim / 8;  // C tiles of 8 head dims

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from device memory to shared memory, or 16 zero bytes.
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(smem_addr(dst)), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Rows [row0, row0 + kRows) of one head's (T, 64) slice into a shared
// tile, 16 bytes a thread; rows at or past T are zero-filled. src points
// at (b, 0, 64 * head). The copies are asynchronous: commit, wait, then
// __syncthreads() before reading.
template <int kRows, int kBlockThreads>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* __restrict__ src, int row0,
                                                int seq, int hidden) {
  for (int c = threadIdx.x; c < kRows * 8; c += kBlockThreads) {
    const int r = c >> 3;
    const int chunk = (c & 7) * 8;
    const int row = row0 + r;
    const bool in = row < seq;
    cp_async16(dst + r * kRow + chunk, src + (size_t)(in ? row : 0) * hidden + chunk, in);
  }
}

// Four 8 x 8 bf16 matrices; lane i gives the address of row i % 8 of
// matrix i / 8, and register j receives matrix j as (row g, columns 2t,
// 2t + 1), or with .trans as (rows 2t, 2t + 1; column g).
__device__ __forceinline__ void ldmatrix4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void ldmatrix4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p))
               : "memory");
}

__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// (lo, hi) rounded to bf16, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&h);
}

// The max or sum over the four lanes that share a C row.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// The A fragments of rows [r0, r0 + 16) of a (T, 64) tile: one per 16 head
// dims.
__device__ __forceinline__ void load_a(uint32_t (&a)[4][4], const bf16* x, int r0, int lane) {
  const bf16* p = x + (r0 + (lane & 15)) * kRow + ((lane >> 4) << 3);
#pragma unroll
  for (int kt = 0; kt < 4; ++kt) ldmatrix4(a[kt], p + kt * 16);
}

// acc (16 x 128) += A X^T: A the warp's 16 rows over the 64 head dims,
// X a (T, 64) tile, so the columns of acc are X's rows (keys). S = Q K^T
// and dP = dO V^T. Key tiles wholly past T are skipped and stay as they
// were.
__device__ __forceinline__ void product_nt(float (&acc)[kKeyTiles][4], const uint32_t (&a)[4][4],
                                           const bf16* x, int seq, int lane) {
  const bf16* p = x + ((lane & 7) + ((lane >> 4) << 3)) * kRow + (((lane >> 3) & 1) << 3);
#pragma unroll
  for (int np = 0; np < kKeyTiles / 2; ++np) {
    if (np * 16 < seq) {
#pragma unroll
      for (int kt = 0; kt < 4; ++kt) {
        uint32_t b[4];  // b0, b1 of key tile 2 np, then of key tile 2 np + 1
        ldmatrix4(b, p + np * 16 * kRow + kt * 16);
        mma16816(acc[2 * np], a[kt], b[0], b[1]);
        mma16816(acc[2 * np + 1], a[kt], b[2], b[3]);
      }
    }
  }
}

// acc (16 x 64) += P X: P the warp's 16 rows over 128 keys as A fragments
// (one per 16 keys), X a (T, 64) tile read through ldmatrix.trans.
// O = P V and dQ = ds K.
__device__ __forceinline__ void product_nn(float (&acc)[kDimTiles][4],
                                           const uint32_t (&p)[kKeyTiles / 2][4], const bf16* x,
                                           int seq, int lane) {
  const bf16* base = x + (lane & 15) * kRow + ((lane >> 4) << 3);
#pragma unroll
  for (int kk = 0; kk < kKeyTiles / 2; ++kk) {
    if (kk * 16 < seq) {
#pragma unroll
      for (int dp = 0; dp < kDimTiles / 2; ++dp) {
        uint32_t b[4];  // b0, b1 of dim tile 2 dp, then of dim tile 2 dp + 1
        ldmatrix4_trans(b, base + kk * 16 * kRow + dp * 16);
        mma16816(acc[2 * dp], p[kk], b[0], b[1]);
        mma16816(acc[2 * dp + 1], p[kk], b[2], b[3]);
      }
    }
  }
}

// acc (16 x 64) += P^T X for the 16 columns [c0, c0 + 16) of P: P a
// (T, T) tile stored [query][key], X a (T, 64) tile, both read through
// ldmatrix.trans; the sum runs over the ceil(T / 16) query tiles.
// dV = pd^T dO and dK = ds^T Q.
__device__ __forceinline__ void product_tn(float (&acc)[kDimTiles][4], const bf16* p,
                                           const bf16* x, int c0, int seq, int lane) {
  const bf16* pa = p + ((lane & 7) + ((lane >> 4) << 3)) * kPRow + c0 + (((lane >> 3) & 1) << 3);
  const bf16* pb = x + (lane & 15) * kRow + ((lane >> 4) << 3);
  const int tiles = (seq + 15) >> 4;
  for (int qt = 0; qt < tiles; ++qt) {
    uint32_t a[4];
    ldmatrix4_trans(a, pa + qt * 16 * kPRow);
#pragma unroll
    for (int dp = 0; dp < kDimTiles / 2; ++dp) {
      uint32_t b[4];
      ldmatrix4_trans(b, pb + qt * 16 * kRow + dp * 16);
      mma16816(acc[2 * dp], a, b[0], b[1]);
      mma16816(acc[2 * dp + 1], a, b[2], b[3]);
    }
  }
}

// What each key column is, for the 32 columns 8 j + 2 t + e a thread holds
// (bit 2 j + e): masked by the key-padding mask (scored -3e7), or padding
// past T (scored -inf, so it adds exactly 0 to every sum). kind[c] is 1 for
// a kept key, 0 for a masked one, -1 for padding.
struct Columns {
  unsigned masked;
  unsigned pad;
};

__device__ __forceinline__ void fill_kinds(int* kind, const int* __restrict__ mask_row, int seq) {
  for (int c = threadIdx.x; c < kMaxSeq; c += blockDim.x)
    kind[c] = c >= seq ? -1 : (mask_row == nullptr || mask_row[c] > 0) ? 1 : 0;
}

__device__ __forceinline__ Columns read_kinds(const int* kind, int lane) {
  Columns cols{0u, 0u};
  const int t = lane & 3;
#pragma unroll
  for (int j = 0; j < kKeyTiles; ++j) {
    const int2 k2 = *reinterpret_cast<const int2*>(kind + 8 * j + 2 * t);
    cols.masked |= (unsigned)(k2.x == 0) << (2 * j) | (unsigned)(k2.y == 0) << (2 * j + 1);
    cols.pad |= (unsigned)(k2.x < 0) << (2 * j) | (unsigned)(k2.y < 0) << (2 * j + 1);
  }
  return cols;
}

// The warp's 16 x 64 f32 result, rounded to bf16, through rows
// [r0, r0 + 16) of a shared tile that no other warp touches, then to
// device memory 16 bytes a lane; rows at or past T are not stored. dst
// points at (b, 0, 64 * head), rows [row0, ...) of it belong to the tile.
__device__ __forceinline__ void store_rows(bf16* tile, bf16* __restrict__ dst,
                                           const float (&acc)[kDimTiles][4], int r0, int row0,
                                           int seq, int hidden, int lane) {
  const int g = lane >> 2;
  const int t = lane & 3;
  __syncwarp();
#pragma unroll
  for (int n = 0; n < kDimTiles; ++n) {
    *reinterpret_cast<uint32_t*>(tile + (r0 + g) * kRow + 8 * n + 2 * t) =
        pack_bf16(acc[n][0], acc[n][1]);
    *reinterpret_cast<uint32_t*>(tile + (r0 + g + 8) * kRow + 8 * n + 2 * t) =
        pack_bf16(acc[n][2], acc[n][3]);
  }
  __syncwarp();
  for (int c = lane; c < 16 * 8; c += 32) {
    const int r = r0 + (c >> 3);
    const int chunk = (c & 7) * 8;
    if (row0 + r < seq)
      *reinterpret_cast<uint4*>(dst + (size_t)(row0 + r) * hidden + chunk) =
          *reinterpret_cast<const uint4*>(tile + r * kRow + chunk);
  }
}

// The keep-mask hash with the row's part summed once: bits of (r, c) are
// hash_finish(row_term(r, salt) + c * 0x85EBCA6B), the value of hash_bits.
__device__ __forceinline__ unsigned row_term(unsigned r, unsigned salt) {
  return r * 0x9E3779B9u + salt * 0xC2B2AE35u;
}

__device__ __forceinline__ float keep_scale_row(const Dropout& dr, unsigned row, int c) {
  return hash_finish(row + (unsigned)c * 0x85EBCA6Bu) >= dr.thresh ? dr.inv_keep : 0.f;
}

}  // namespace mma
}  // namespace attn
