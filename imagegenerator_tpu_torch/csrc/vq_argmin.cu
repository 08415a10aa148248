// Nearest-codebook search for Hopper (sm_90a).
//
// Replaces imagegenerator_tpu/ops/pallas/vq_kernel.py::
// nearest_codebook_indices_pallas (kernel body _vq_kernel): for each row
// x_i of x (N, d) it returns
//   argmin_k ( ||c_k||^2 - 2 x_i . c_k )        over the codebook (K, d),
// the nearest code by squared distance with the row-constant ||x_i||^2
// left out. The (N, K) score matrix is never stored: it lives in
// registers one 64 x 64 tile at a time. Ties go to the lowest index. A
// code row past K scores +inf and is never chosen. x is f32 or bf16 and
// is widened to f32 as it is loaded; the codebook is f32; products and
// sums are f32 on the FMA units.
//
// What bounds it: operations, on the FMA units. The codebook of the
// ImageNet VQGAN is 16 MB, which the card reads in 5 us, while
// 2 N K d f32 operations at N = 64 take 8 us at the f32 peak; a larger N
// only adds operations. Tensor cores (TF32 would round the operands) and
// TMA are later work.
//
// Design for the card, not the TPU's sequential K grid: the grid is
// (row tiles, K splits). At the default image size N is 64, one row tile,
// so the K axis is split over blocks as well: each block walks its own
// range of 64-code tiles with a running (score, index) per row, and the
// blocks' partial results meet in a 64-bit atomicMin on
// (orderable score bits << 32 | index) per row. min over such keys is
// "lower score wins, equal scores -> lower index", exact and independent
// of the order in which blocks arrive, so the result is deterministic. A
// second small kernel unpacks the index.
//
// A block has 256 threads as 16 x 16; thread (ty, tx) owns rows
// ty + 16 i and codes tx + 16 j (i, j < 4), a 4 x 4 register tile. x and
// codebook tiles go through shared memory 32 columns of d at a time,
// stored transposed with an odd stride (65) so that both the transposing
// stores and the strided reads are free of bank conflicts. ||c_k||^2 is
// summed from the same shared tile by the first 64 threads.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;     // rows of x, and codes, per tile
constexpr int kDepth = 32;    // columns of d per shared-memory chunk
constexpr int kStride = kTile + 1;
constexpr int kThreads = 256;

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

template <typename T>
__global__ void __launch_bounds__(kThreads)
vq_argmin_kernel(const T* __restrict__ x, const float* __restrict__ cb,
                 unsigned long long* __restrict__ best, int n, int k, int d,
                 int tiles_per_block) {
  __shared__ float xs[kDepth][kStride];
  __shared__ float cs[kDepth][kStride];
  __shared__ float c2s[kTile];
  __shared__ unsigned long long row_best[kTile][16];

  const int tid = threadIdx.x;
  const int tx = tid & 15, ty = tid >> 4;
  const int row0 = blockIdx.x * kTile;
  const int k_tiles = (k + kTile - 1) / kTile;
  const int tile_begin = blockIdx.y * tiles_per_block;
  const int tile_end = min(tile_begin + tiles_per_block, k_tiles);

  unsigned long long mine[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) mine[i] = ~0ull;

  for (int tile = tile_begin; tile < tile_end; ++tile) {
    const int k0 = tile * kTile;
    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.0f;
    float c2 = 0.0f;  // threads 0..63: ||c_{k0 + tid}||^2

    for (int d0 = 0; d0 < d; d0 += kDepth) {
      // 64 x 32 elements of each operand, 8 per thread; neighbouring
      // threads read neighbouring columns of one row
#pragma unroll
      for (int e = 0; e < (kTile * kDepth) / kThreads; ++e) {
        const int idx = tid + e * kThreads;
        const int r = idx / kDepth, c = idx % kDepth;
        const bool col_ok = d0 + c < d;
        const int xr = row0 + r, cr = k0 + r;
        xs[c][r] = (col_ok && xr < n) ? to_float(x[static_cast<size_t>(xr) * d + d0 + c]) : 0.0f;
        cs[c][r] = (col_ok && cr < k) ? cb[static_cast<size_t>(cr) * d + d0 + c] : 0.0f;
      }
      __syncthreads();
      if (tid < kTile) {
#pragma unroll
        for (int c = 0; c < kDepth; ++c) c2 = fmaf(cs[c][tid], cs[c][tid], c2);
      }
#pragma unroll
      for (int c = 0; c < kDepth; ++c) {
        float a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = xs[c][ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = cs[c][tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
    if (tid < kTile) c2s[tid] = (k0 + tid < k) ? c2 : CUDART_INF_F;
    __syncthreads();
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = tx + 16 * j;
      const float cc = c2s[col];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const unsigned long long cand = pack(cc - 2.0f * acc[i][j], k0 + col);
        mine[i] = cand < mine[i] ? cand : mine[i];
      }
    }
    // c2s is rewritten only after the next tile's chunk loop, which
    // synchronises, so no barrier is needed here
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) row_best[ty + 16 * i][tx] = mine[i];
  __syncthreads();
  if (tid < kTile && row0 + tid < n) {
    unsigned long long m = row_best[tid][0];
#pragma unroll
    for (int t = 1; t < 16; ++t) m = row_best[tid][t] < m ? row_best[tid][t] : m;
    atomicMin(best + row0 + tid, m);
  }
}

__global__ void vq_unpack_kernel(const unsigned long long* __restrict__ best,
                                 int* __restrict__ out, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < n) out[i] = static_cast<int>(best[i] & 0xFFFFFFFFull);
}

}  // namespace

// x (n, d) f32 (dtype 0) or bf16 (dtype 1), cb (k, d) f32, best (n) u64
// scratch, out (n) int32. Returns cudaGetLastError() after the launches.
extern "C" int vq_argmin(const void* x, const void* cb, void* best, void* out,
                         int n, int k, int d, int dtype, int k_splits, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  auto* scratch = static_cast<unsigned long long*>(best);
  cudaError_t err = cudaMemsetAsync(scratch, 0xFF, sizeof(unsigned long long) * n, stream);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int k_tiles = (k + kTile - 1) / kTile;
  const int tiles_per_block = (k_tiles + k_splits - 1) / k_splits;
  dim3 grid((n + kTile - 1) / kTile, (k_tiles + tiles_per_block - 1) / tiles_per_block);
  if (dtype == 0) {
    vq_argmin_kernel<float><<<grid, kThreads, 0, stream>>>(
        static_cast<const float*>(x), static_cast<const float*>(cb), scratch, n, k, d,
        tiles_per_block);
  } else {
    vq_argmin_kernel<__nv_bfloat16><<<grid, kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(x), static_cast<const float*>(cb), scratch, n, k, d,
        tiles_per_block);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  vq_unpack_kernel<<<(n + 255) / 256, 256, 0, stream>>>(scratch, static_cast<int*>(out), n);
  return static_cast<int>(cudaGetLastError());
}
