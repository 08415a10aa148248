// Nearest-codebook search for Hopper (sm_90a), on the tensor cores.
//
// Replaces imagegenerator_tpu/ops/pallas/vq_kernel.py::
// nearest_codebook_indices_pallas (kernel body _vq_kernel): for each row
// x_i of x (N, d) it returns
//   argmin_k ( ||c_k||^2 - 2 x_i . c_k )        over the codebook (K, d),
// the nearest code by squared distance with the row-constant ||x_i||^2
// left out. The (N, K) score matrix is never stored: it lives in
// registers one 64 x 128 tile at a time. Ties go to the lowest index. A
// code row past K scores +inf and is never chosen. x is f32 or bf16, the
// codebook f32, any N, K and d.
//
// What bounds it: operations. The codebook of the ImageNet VQGAN is 16 MB,
// which the card reads in 5 us, while 2 N K d f32 operations at N = 64
// take 8 us at the f32 peak of the FMA units; a larger N only adds
// operations. So the product runs on the tensor cores, whose widest
// float type is TF32 (10 bits of mantissa). One TF32 product is not
// enough to name the nearest code (it misses by up to 5e-5 of a row's
// score range), so each f32 operand v is split as
//   hi = tf32(v)   (to nearest, ties away from zero, as cvt.rna.tf32.f32),
//   lo = v - hi    (exact in f32; the tensor core reads its top 10 bits of
//                   mantissa and ignores the rest, which costs no
//                   instruction: the split is on the integer pipe, which
//                   the kernel keeps busiest),
// and x . c is three mma.sync.m16n8k8 products into one f32 accumulator,
// small terms first: lo * hi, hi * lo, hi * hi. What is dropped (lo * lo
// and the low bits of lo) is below 2^-21 of a product, and of either sign.
// Integers up to 2^10 have lo = 0 and exact products, so exact ties stay
// exact. A bf16 x is
// its own hi, and its route leaves the lo * hi product out. ||c_k||^2 is
// summed in f32 on the FMA units from the same staged tile, two threads
// a code.
//
// Design for the card, not the TPU's sequential K grid: the grid is
// (row tiles of 64, K splits). At the default image size N is 64, one row
// tile, so the K axis is split over blocks as well: each block walks its
// own range of 128-code tiles with a running (score, index) per row, and
// the blocks' partial results meet in a 64-bit atomicMin on
// (orderable score bits << 32 | index) per row. min over such keys is
// "lower score wins, equal scores -> lower index", exact and independent
// of the order in which blocks arrive, so the result is deterministic.
//
// One launch a call: the keys and one ticket per row tile live in a
// scratch buffer that every call finds at its initial values (keys all
// ones, tickets 0) and leaves so. A block adds one to its row tile's
// ticket after its atomicMins; the block that draws the last ticket reads
// the 64 minima, writes the indices, and puts keys and ticket back. Calls
// that share a scratch buffer must be ordered on one stream (the
// wrapper's rule).
//
// A block has 8 warps as 2 (rows) x 4 (codes); a warp owns a 32 x 32 tile
// of scores as 2 x 4 mma tiles (32 accumulator registers a thread). x and
// codebook go through shared memory 32 columns of d at a time in a ring of
// three stages filled by cp.async (16 bytes a copy when d and the pointers
// allow, else plain loads into the same ring), one barrier a stage. Rows
// are padded to 36 words (f32) or 40 bf16 so that the eight rows and four
// columns of a fragment load fall in 32 different banks; fragments are
// read raw and split in registers. Rows past N or K and columns past d
// are zero-filled.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;      // rows of x per block
constexpr int kCodes = 128;    // codes per tile
constexpr int kDepth = 32;     // columns of d per stage
constexpr int kStages = 3;
constexpr int kThreads = 256;
constexpr int kCStride = kDepth + 4;  // f32 words per staged codebook row
constexpr int kMaxDevices = 64;

// One stage of the ring: 128 codebook rows of 36 f32, then 64 rows of x of
// 36 f32 or 40 bf16 (every row a multiple of 16 bytes).
template <typename T>
struct Stage {
  static constexpr int kXStride = kDepth + 16 / sizeof(T);
  static constexpr int kCBytes = sizeof(float) * kCodes * kCStride;
  static constexpr int kBytes = kCBytes + sizeof(T) * kRows * kXStride;
  static constexpr int kRingBytes = kStages * kBytes;
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// Order-preserving map of a float onto uint32 (-0 is first made +0).
__device__ __forceinline__ unsigned int orderable(float f) {
  unsigned int u = __float_as_uint(f + 0.0f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ unsigned long long pack(float score, int index) {
  return (static_cast<unsigned long long>(orderable(score)) << 32) |
         static_cast<unsigned int>(index);
}

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

// A finite v rounded to TF32 (nearest, ties away from zero), as the bits
// of an f32: what cvt.rna.tf32.f32 gives, without its test for inf and NaN
// (two more instructions an element; the inputs are finite).
__device__ __forceinline__ uint32_t tf32(float v) {
  return (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
}

// lo is left as the f32 it is: the mma reads its sign, exponent and top
// 10 bits of mantissa.
__device__ __forceinline__ void split(float v, uint32_t& hi, uint32_t& lo) {
  hi = tf32(v);
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// c (16 x 8) += a (16 x 8, row-major) * b (8 x 8, column-major), TF32 in,
// f32 out. For lane = 4 g + t: a0 = (row g, k t), a1 = (row g + 8, k t),
// a2 = (row g, k t + 4), a3 = (row g + 8, k t + 4); b0 = (k t, n g),
// b1 = (k t + 4, n g); c0, c1 = (row g, n 2t, 2t + 1), c2, c3 = (row g + 8,
// same n).
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Columns [d0, d0 + 32) of kTileRows rows of src (rows, d), from row
// first on, into a staged tile of kStride elements a row; rows at or past
// `rows` and columns at or past d are zero. kVec: by 16-byte cp.async (d in
// whole 16-byte pieces, src aligned); else by plain loads, one element
// each. Every loop has a trip count known to the compiler, and a thread's
// copies share one column, so the addresses cost one multiplication.
template <typename T, int kTileRows, int kStride, bool kVec>
__device__ __forceinline__ void load_tile(T* dst, const T* __restrict__ src, int first, int d0,
                                          int rows, int d) {
  const int tid = threadIdx.x;
  constexpr int kWidth = kVec ? 16 / sizeof(T) : 1;  // elements a copy
  constexpr int kPieces = kDepth / kWidth;           // copies a staged row
  constexpr int kRowsPerPass = kThreads / kPieces;
  const int r = tid / kPieces, c = (tid % kPieces) * kWidth;
  const bool col_ok = d0 + c < d;
  const T* from = src + static_cast<size_t>(first + r) * d + d0 + c;
  const size_t pass_stride = static_cast<size_t>(kRowsPerPass) * d;
  T* to = dst + r * kStride + c;
#pragma unroll
  for (int i = 0; i < kTileRows / kRowsPerPass; ++i) {
    const bool ok = col_ok && first + r + i * kRowsPerPass < rows;
    if constexpr (kVec) {
      cp_async16(to + i * kRowsPerPass * kStride, ok ? from + i * pass_stride : src, ok);
    } else {
      to[i * kRowsPerPass * kStride] = ok ? from[i * pass_stride] : T(0.0f);
    }
  }
}

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
vq_argmin_kernel(const T* __restrict__ x, const float* __restrict__ cb,
                 unsigned long long* best, unsigned int* tickets, int* __restrict__ out, int n,
                 int k, int d, int tiles_per_block) {
  constexpr bool kSplitX = sizeof(T) == 4;  // a bf16 value is a TF32 value: no lo part
  constexpr int kXStride = Stage<T>::kXStride;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float c2s[kCodes];
  __shared__ unsigned long long row_best[kRows][4];
  __shared__ bool last_block;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rm = (warp >> 2) * 32;  // the warp's rows within the block's 64
  const int cn = (warp & 3) * 32;   // the warp's codes within the tile's 128
  const int row0 = blockIdx.x * kRows;
  const int k_tiles = (k + kCodes - 1) / kCodes;
  const int tile_begin = blockIdx.y * tiles_per_block;
  const int tile_end = min(tile_begin + tiles_per_block, k_tiles);
  const int chunks = (d + kDepth - 1) / kDepth;
  const int steps = (tile_end - tile_begin) * chunks;

  auto stage_c = [&](int s) { return reinterpret_cast<float*>(smem + s * Stage<T>::kBytes); };
  auto stage_x = [&](int s) {
    return reinterpret_cast<T*>(smem + s * Stage<T>::kBytes + Stage<T>::kCBytes);
  };
  // the step being loaded runs kStages - 1 ahead of the step being computed
  int next_tile = tile_begin, next_chunk = 0, load_at = 0;
  auto load_next = [&]() {
    if (next_tile < tile_end) {
      load_tile<float, kCodes, kCStride, kVec>(stage_c(load_at), cb, next_tile * kCodes,
                                               next_chunk * kDepth, k, d);
      load_tile<T, kRows, kXStride, kVec>(stage_x(load_at), x, row0, next_chunk * kDepth, n, d);
      if (++next_chunk == chunks) next_chunk = 0, ++next_tile;
      load_at = load_at + 1 == kStages ? 0 : load_at + 1;
    }
    cp_async_commit();  // an empty group past the end keeps the count in step
  };

  unsigned long long mine[4];  // rows rm + 16 mt + 8 h + g, at index 2 mt + h
#pragma unroll
  for (int i = 0; i < 4; ++i) mine[i] = ~0ull;
  float acc[2][4][4];
  float c2 = 0.0f;  // this thread's half of ||c||^2 of code tid / 2

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) load_next();

  int tile = tile_begin, chunk = 0, at = 0;
  for (int step = 0; step < steps; ++step) {
    cp_async_wait<kStages - 2>();  // this step's stage has landed
    __syncthreads();               // for every thread, and the stage of step - 1 is free
    load_next();

    if (chunk == 0) {
      c2 = 0.0f;
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[mt][nt][i] = 0.0f;
    }
    const float* cs = stage_c(at);
    const T* xs = stage_x(at);

    {  // ||c||^2: thread (code tid / 2, half tid % 2) sums 16 of the 32 columns
      const float4* p = reinterpret_cast<const float4*>(cs + (tid >> 1) * kCStride + (tid & 1) * 16);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 q = p[i];
        c2 = fmaf(q.x, q.x, c2);
        c2 = fmaf(q.y, q.y, c2);
        c2 = fmaf(q.z, q.z, c2);
        c2 = fmaf(q.w, q.w, c2);
      }
    }

#pragma unroll
    for (int k0 = 0; k0 < kDepth; k0 += 8) {
      uint32_t a_hi[2][4], a_lo[2][4], b_hi[4][2], b_lo[4][2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        const T* p = xs + (rm + 16 * mt + g) * kXStride + k0 + t;
        const float v[4] = {to_float(p[0]), to_float(p[8 * kXStride]), to_float(p[4]),
                            to_float(p[8 * kXStride + 4])};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          if constexpr (kSplitX) {
            split(v[i], a_hi[mt][i], a_lo[mt][i]);
          } else {
            a_hi[mt][i] = __float_as_uint(v[i]);
            a_lo[mt][i] = 0u;
          }
        }
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const float* p = cs + (cn + 8 * nt + g) * kCStride + k0 + t;
        split(p[0], b_hi[nt][0], b_lo[nt][0]);
        split(p[4], b_hi[nt][1], b_lo[nt][1]);
      }
      // small terms first; one product over all eight tiles before the
      // next, so that a tile's three dependent mma are eight instructions apart
      if constexpr (kSplitX) {
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt) mma_tf32(acc[mt][nt], a_lo[mt], b_hi[nt]);
      }
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_tf32(acc[mt][nt], a_hi[mt], b_lo[nt]);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) mma_tf32(acc[mt][nt], a_hi[mt], b_hi[nt]);
    }

    if (chunk == chunks - 1) {  // the tile's scores are whole: fold them into the running minima
      const int code0 = tile * kCodes;
      c2 += __shfl_xor_sync(0xffffffffu, c2, 1);
      if ((tid & 1) == 0) c2s[tid >> 1] = (code0 + (tid >> 1) < k) ? c2 : CUDART_INF_F;
      __syncthreads();
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = cn + 8 * nt + 2 * t;
        const float cc0 = c2s[col], cc1 = c2s[col + 1];
#pragma unroll
        for (int mt = 0; mt < 2; ++mt)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const unsigned long long c0 = pack(cc0 - 2.0f * acc[mt][nt][2 * h], code0 + col);
            const unsigned long long c1 = pack(cc1 - 2.0f * acc[mt][nt][2 * h + 1], code0 + col + 1);
            const unsigned long long c = c0 < c1 ? c0 : c1;
            mine[2 * mt + h] = c < mine[2 * mt + h] ? c : mine[2 * mt + h];
          }
      }
      // c2s is rewritten at the end of the next tile, past at least one
      // of the loop's barriers
    }
    if (++chunk == chunks) chunk = 0, ++tile;
    at = at + 1 == kStages ? 0 : at + 1;
  }
  cp_async_wait<0>();

  // the four lanes of a quad hold the same rows; then the four warps along the codes
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    unsigned long long m = mine[i];
    unsigned long long o = __shfl_xor_sync(0xffffffffu, m, 1);
    m = o < m ? o : m;
    o = __shfl_xor_sync(0xffffffffu, m, 2);
    m = o < m ? o : m;
    if (t == 0) row_best[rm + 16 * (i >> 1) + 8 * (i & 1) + g][warp & 3] = m;
  }
  __syncthreads();
  if (tid < kRows && row0 + tid < n) {
    unsigned long long m = row_best[tid][0];
#pragma unroll
    for (int w = 1; w < 4; ++w) m = row_best[tid][w] < m ? row_best[tid][w] : m;
    atomicMin(best + row0 + tid, m);
  }

  // the last block to arrive for this row tile writes the indices and
  // leaves keys and ticket as the next call expects them
  __threadfence();
  __syncthreads();
  if (tid == 0) last_block = atomicAdd(tickets + blockIdx.x, 1u) == gridDim.y - 1;
  __syncthreads();
  if (last_block) {
    __threadfence();
    if (tid < kRows && row0 + tid < n) {
      out[row0 + tid] = static_cast<int>(__ldcg(best + row0 + tid) & 0xFFFFFFFFull);
      best[row0 + tid] = ~0ull;
    }
    if (tid == 0) tickets[blockIdx.x] = 0u;
  }
}

template <typename T, bool kVec>
cudaError_t launch(const void* x, const void* cb, void* best, void* tickets, void* out, int n,
                   int k, int d, int k_splits, cudaStream_t stream) {
  // more than 48 KB of dynamic shared memory has to be asked for, once a device
  static bool asked[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device >= kMaxDevices || !asked[device]) {
    err = cudaFuncSetAttribute(vq_argmin_kernel<T, kVec>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               Stage<T>::kRingBytes);
    if (err != cudaSuccess) return err;
    if (device < kMaxDevices) asked[device] = true;
  }
  const int k_tiles = (k + kCodes - 1) / kCodes;
  const int tiles_per_block = (k_tiles + k_splits - 1) / k_splits;
  dim3 grid((n + kRows - 1) / kRows, (k_tiles + tiles_per_block - 1) / tiles_per_block);
  vq_argmin_kernel<T, kVec><<<grid, kThreads, Stage<T>::kRingBytes, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(cb),
      static_cast<unsigned long long*>(best), static_cast<unsigned int*>(tickets),
      static_cast<int*>(out), n, k, d, tiles_per_block);
  return cudaGetLastError();
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

}  // namespace

// x (n, d) f32 (dtype 0) or bf16 (dtype 1), cb (k, d) f32, out (n) int32.
// Scratch: best (at least n) u64, all ones, and tickets (at least
// ceil(n / 64)) u32, zero; the kernel leaves both so. Returns the CUDA
// error of the launch, 0 for none.
extern "C" int vq_argmin(const void* x, const void* cb, void* best, void* tickets, void* out,
                         int n, int k, int d, int dtype, int k_splits, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const bool vec = d % (dtype == 0 ? 4 : 8) == 0 && aligned16(x) && aligned16(cb);
  cudaError_t err;
  if (dtype == 0) {
    err = vec ? launch<float, true>(x, cb, best, tickets, out, n, k, d, k_splits, stream)
              : launch<float, false>(x, cb, best, tickets, out, n, k, d, k_splits, stream);
  } else {
    err = vec ? launch<__nv_bfloat16, true>(x, cb, best, tickets, out, n, k, d, k_splits, stream)
              : launch<__nv_bfloat16, false>(x, cb, best, tickets, out, n, k, d, k_splits, stream);
  }
  return static_cast<int>(err);
}

// Rows and codes per tile, for the wrapper's grid rule.
extern "C" int vq_argmin_rows() { return kRows; }
extern "C" int vq_argmin_codes() { return kCodes; }
