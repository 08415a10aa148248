// Tensor-core building blocks of the bf16 attention kernels
// (attention_fwd.cu, attention_bwd.cu): cp.async tile loads, ldmatrix
// fragment loads, the mma.sync m16n8k16 product and the products the
// kernels are made of.
//
// The tiled kernels take any T and any head dim d <= 256 with d % 8 == 0,
// templated on kDim, the head dim rounded up to 32, 64, 128 or 256: a
// shared tile holds some rows of a (T, d) slice in rows of kDim + 8 bf16.
// Only the first ceil(d / 16) * 16 columns are loaded, those at or past d
// as zeros, which makes the contraction over d in steps of 16 exact; the
// products (tile_nt, tile_nn) skip the steps and output columns past
// that. The whole-head kernels (d = kHeadDim = 64, T <= kMaxSeq = 128) use
// the same products on whole (T, 64) tiles of kRow = 72 bf16 a row (144
// bytes: 64 values and 16 bytes of padding), plus load_tile_async,
// product_tn over (T, T) tiles of kPRow = 136 bf16 a row (272 bytes) and
// store_rows.
//
// Every row stride is an odd number of 16-byte units, so the eight row
// addresses of an ldmatrix fall in eight different bank groups and the
// fragment stores of a warp (8 rows x 4 lanes x 4 bytes) in 32 different
// banks. Rows at or past T are zero.
//
// Fragments of mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32, for
// lane = 4 g + t:
//   A (16 x 16): a0 = (row g, k 2t..2t+1), a1 = (row g + 8, same k),
//                a2 = (row g, k 2t+8..2t+9), a3 = (row g + 8, same k)
//   B (16 x 8):  b0 = (k 2t..2t+1, n g), b1 = (k 2t+8..2t+9, n g)
//   C (16 x 8):  c0, c1 = (row g, n 2t, 2t+1), c2, c3 = (row g + 8, same n)
// A warp owns 16 rows of a product. Two neighbouring C tiles, rounded to
// bf16, are the A fragment of the next product with no trip through shared
// memory (pack_bf16).

#pragma once

#include "attention_common.cuh"

#include <stdint.h>

namespace attn {
namespace mma {

constexpr int kHeadDim = 64;         // the whole-head kernels' head dim
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

// What each key column of a tile is, for the columns 8 j + 2 t + e a
// thread holds (bit 2 j + e): masked by the key-padding mask (scored -3e7),
// or padding past T (scored -inf, so it adds exactly 0 to every sum). In
// shared memory a kind per key: 1 kept, 0 masked, -1 padding
// (fill_tile_kinds, read_tile_kinds).
struct Columns {
  unsigned masked;
  unsigned pad;
};

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

// ------------------------------------------------- the tiled kernels
//
// kDim: the head dim rounded up to a bucket (32, 64, 128, 256); d itself,
// a multiple of 8, is a runtime argument, and nk = ceil(d / 16) is the
// number of 16-wide steps the products take over it. Every block has
// kWarps warps (a template argument of each kernel) of 16 rows each.

template <int kDim>
struct Tiled {
  static constexpr int kRowT = kDim + 8;  // bf16 per shared-memory row
};

// Rows [row0, row0 + kRows) of one head's (T, d) slice into a shared tile,
// the first nk * 16 columns, 16 bytes a thread; columns at or past d and
// rows at or past T are zero-filled. src points at (b, 0, d * head).
// Asynchronous: commit, wait, then __syncthreads() before reading.
template <int kDim, int kRows>
__device__ __forceinline__ void load_rows_async(bf16* dst, const bf16* __restrict__ src, int row0,
                                                int seq, int hidden, int dim) {
  constexpr int kRowT = Tiled<kDim>::kRowT;
  const int chunks = ((dim + 15) >> 4) << 1;  // 16-byte pieces a row
  for (int c = threadIdx.x; c < kRows * chunks; c += blockDim.x) {
    const int r = c / chunks;
    const int col = (c - r * chunks) * 8;
    const int row = row0 + r;
    const bool in = row < seq && col < dim;
    cp_async16(dst + r * kRowT + col, src + (in ? (size_t)row * hidden + col : 0), in);
  }
}

// acc (16 x kN) += A X^T: A rows [r0, r0 + 16) of a tile, X a tile of kN
// rows, both over the head dims, so the columns of acc are X's rows.
// Column pairs of tiles at or past n_valid (X's rows past T) are skipped
// and stay as they were. S = Q K^T, dP = dO V^T, and in the dk, dv kernel
// S^T = K Q^T and dP^T = V dO^T.
template <int kDim, int kN>
__device__ __forceinline__ void tile_nt(float (&acc)[kN / 8][4], const bf16* xa, int r0,
                                           const bf16* xb, int nk, int n_valid, int lane) {
  constexpr int kRowT = Tiled<kDim>::kRowT;
  const bf16* pa = xa + (r0 + (lane & 15)) * kRowT + ((lane >> 4) << 3);
  const bf16* pb = xb + ((lane & 7) + ((lane >> 4) << 3)) * kRowT + (((lane >> 3) & 1) << 3);
#pragma unroll
  for (int kt = 0; kt < kDim / 16; ++kt) {
    if (kt < nk) {
      uint32_t a[4];
      ldmatrix4(a, pa + kt * 16);
#pragma unroll
      for (int np = 0; np < kN / 16; ++np) {
        if (np * 16 < n_valid) {
          uint32_t b[4];  // b0, b1 of column tile 2 np, then of 2 np + 1
          ldmatrix4(b, pb + np * 16 * kRowT + kt * 16);
          mma16816(acc[2 * np], a, b[0], b[1]);
          mma16816(acc[2 * np + 1], a, b[2], b[3]);
        }
      }
    }
  }
}

// acc (16 x kOut) += P X[:, c0 : c0 + kOut): P the warp's 16 rows over
// the kK rows of X as A fragments (one per 16), X a tile read through
// ldmatrix.trans. Rows of X at or past n_valid and columns at or past
// nk * 16 are skipped. O = P V and dQ = ds K; dV = pd^T dO and
// dK = ds^T Q in the dk, dv kernel.
template <int kDim, int kK, int kOut>
__device__ __forceinline__ void tile_nn(float (&acc)[kOut / 8][4],
                                           const uint32_t (&p)[kK / 16][4], const bf16* x, int c0,
                                           int nk, int n_valid, int lane) {
  constexpr int kRowT = Tiled<kDim>::kRowT;
  const bf16* base = x + (lane & 15) * kRowT + ((lane >> 4) << 3) + c0;
#pragma unroll
  for (int kk = 0; kk < kK / 16; ++kk) {
    if (kk * 16 < n_valid) {
#pragma unroll
      for (int dp = 0; dp < kOut / 16; ++dp) {
        if ((c0 >> 4) + dp < nk) {
          uint32_t b[4];  // b0, b1 of column tile 2 dp, then of 2 dp + 1
          ldmatrix4_trans(b, base + kk * 16 * kRowT + dp * 16);
          mma16816(acc[2 * dp], p[kk], b[0], b[1]);
          mma16816(acc[2 * dp + 1], p[kk], b[2], b[3]);
        }
      }
    }
  }
}

// The kinds of the kN key columns [k0, k0 + kN) into kind (1 kept, 0
// masked, -1 past T), written by the whole block.
template <int kN>
__device__ __forceinline__ void fill_tile_kinds(int* kind, const int* __restrict__ mask_row, int k0,
                                                int seq) {
  for (int c = threadIdx.x; c < kN; c += blockDim.x) {
    const int col = k0 + c;
    kind[c] = col >= seq ? -1 : (mask_row == nullptr || mask_row[col] > 0) ? 1 : 0;
  }
}

// What each of the thread's columns 8 j + 2 t + e of a kN-column tile is
// (bit 2 j + e).
template <int kN>
__device__ __forceinline__ Columns read_tile_kinds(const int* kind, int lane) {
  static_assert(kN <= 128, "a column kind is a bit of a 32-bit word");
  Columns cols{0u, 0u};
  const int t = lane & 3;
#pragma unroll
  for (int j = 0; j < kN / 8; ++j) {
    const int2 k2 = *reinterpret_cast<const int2*>(kind + 8 * j + 2 * t);
    cols.masked |= (unsigned)(k2.x == 0) << (2 * j) | (unsigned)(k2.y == 0) << (2 * j + 1);
    cols.pad |= (unsigned)(k2.x < 0) << (2 * j) | (unsigned)(k2.y < 0) << (2 * j + 1);
  }
  return cols;
}

constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the special-function unit (ex2.approx.ftz: within 2 ulp; 2^-inf
// is 0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Folds the row max over the thread's columns of a kN-column tile of raw
// scores (q . k) into m0 (row g) and m1 (row g + 8), each score scaled,
// masked keys at -3e7 and columns past T left out. Where none of the
// thread's columns is masked or past T it scales the max of the raw
// scores, which is the max of the scaled ones (rounding is monotonic).
template <int kN>
__device__ __forceinline__ void tile_row_max(const float (&s)[kN / 8][4], const Columns& cols,
                                             float scale, float& m0, float& m1) {
  float a = -INFINITY, b = -INFINITY;
  if (!(cols.masked | cols.pad)) {
#pragma unroll
    for (int j = 0; j < kN / 8; ++j) {
      a = fmaxf(a, fmaxf(s[j][0], s[j][1]));
      b = fmaxf(b, fmaxf(s[j][2], s[j][3]));
    }
    m0 = fmaxf(m0, a * scale);
    m1 = fmaxf(m1, b * scale);
    return;
  }
#pragma unroll
  for (int j = 0; j < kN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float x0 = s[j][e] * scale;
      float x1 = s[j][2 + e] * scale;
      if ((cols.masked >> (2 * j + e)) & 1u) x0 = x1 = kBigNeg;
      if ((cols.pad >> (2 * j + e)) & 1u) x0 = x1 = -INFINITY;
      a = fmaxf(a, x0);
      b = fmaxf(b, x1);
    }
  }
  m0 = fmaxf(m0, a);
  m1 = fmaxf(m1, b);
}

// exp(scale s - m) in place of the thread's raw scores s of a kN-column
// tile, as 2^(s (scale log2 e) - m log2 e): one FMA and one ex2 a score.
// A masked key gives exp(-3e7 - m) (1 in a fully masked row, else 0), a
// column past T 0. sl2e = scale log2 e; for rows g and g + 8, ml = m log2 e
// and mb = (-3e7 - m) log2 e. Within about 1e-6 relative of expf(scale
// s - m) for scaled scores in the tens (the rounding of scale log2 e
// grows with the score); the forward and both backward launches form p
// the same way.
template <int kN>
__device__ __forceinline__ void tile_exp(float (&s)[kN / 8][4], const Columns& cols, float sl2e,
                                         float ml0, float ml1, float mb0, float mb1) {
  if (!(cols.masked | cols.pad)) {
#pragma unroll
    for (int j = 0; j < kN / 8; ++j) {
      s[j][0] = ex2(fmaf(s[j][0], sl2e, -ml0));
      s[j][1] = ex2(fmaf(s[j][1], sl2e, -ml0));
      s[j][2] = ex2(fmaf(s[j][2], sl2e, -ml1));
      s[j][3] = ex2(fmaf(s[j][3], sl2e, -ml1));
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < kN / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float x0 = fmaf(s[j][e], sl2e, -ml0);
      float x1 = fmaf(s[j][2 + e], sl2e, -ml1);
      if ((cols.masked >> (2 * j + e)) & 1u) {
        x0 = mb0;
        x1 = mb1;
      }
      if ((cols.pad >> (2 * j + e)) & 1u) x0 = x1 = -INFINITY;
      s[j][e] = ex2(x0);
      s[j][2 + e] = ex2(x1);
    }
  }
}

// The warp's 16 x kOut f32 result for columns [c0, c0 + kOut) of a
// (T, d) slice, rounded to bf16, stored two values a lane (rows row_a and
// row_b = row_a + 8 of the slice); rows at or past T and columns at or
// past d are not stored. dst points at (b, 0, d * head).
template <int kOut>
__device__ __forceinline__ void store_frags(bf16* __restrict__ dst, const float (&acc)[kOut / 8][4],
                                            int row_a, int c0, int seq, int hidden, int dim,
                                            int lane) {
  const int row_b = row_a + 8;
  const int t = lane & 3;
#pragma unroll
  for (int n = 0; n < kOut / 8; ++n) {
    const int col = c0 + 8 * n + 2 * t;
    if (col < dim) {
      if (row_a < seq)
        *reinterpret_cast<uint32_t*>(dst + (size_t)row_a * hidden + col) = pack_bf16(acc[n][0], acc[n][1]);
      if (row_b < seq)
        *reinterpret_cast<uint32_t*>(dst + (size_t)row_b * hidden + col) = pack_bf16(acc[n][2], acc[n][3]);
    }
  }
}

}  // namespace mma
}  // namespace attn
