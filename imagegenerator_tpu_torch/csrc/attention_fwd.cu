// Fused multi-head self-attention forward for Hopper (sm_90a).
//
// Replaces imagegenerator_tpu/ops/pallas/attention.py::_pallas_fwd
// (kernel body _fwd_kernel): per (batch row, head) it computes
//   S = scale * Q K^T, key-padding mask filled with -3e7 (not -inf),
//   m = rowmax(S), p = exp(S - m), l = rowsum(p),
//   p *= keep / (1 - rate)          (attention-prob dropout, rate > 0),
//   O = (p V) / l,
// and writes O in the input dtype plus m and l in f32, kept apart (not as
// a log-sum-exp) so the backward recomputes p with no reductions. l sums
// p before dropout, as on the TPU. A fully masked row comes out uniform.
// The keep-mask is the counter hash of attention_common.cuh, addressed by
// (seed, batch row, head, query, key), so the backward replays it.
//
// Operands stay in the packed-head layout of the BERT Dense outputs:
// q, k, v are (B, T, H) with H = heads * 64, head h in columns
// [64h, 64h + 64). No transpose is made before or after the kernel.
//
// What bounds it: at BERT's T = 128 the (T, T) scores of one head are
// 64 KB in f32; the plain version writes and rereads them in device memory
// between a dozen small kernels. Here one block owns one (batch row, head,
// 64-query tile); its scores and probabilities live only in shared memory,
// and device memory sees q, k, v read once per query tile and o, m, l
// written once. The products run on the FMA units in f32 (no tensor cores
// yet) with one shared-memory load per FMA, so this first version is bound
// by shared-memory loads feeding the FMAs, not by device memory. Dropout
// adds about ten integer operations per score.
//
// Design: 128 threads per block. Phases 1 and 3 give each thread one
// query row and 32 interleaved columns (2c + half), so the two threads of
// a row read neighbouring banks. Q, K and V tiles are converted to f32 in
// shared memory with an odd row stride (65) and the score rows with an odd
// stride (T + 1), which keeps the 16 rows a warp touches in distinct
// banks. Keys are walked in tiles of 64, so any T <= 512 fits:
// shared memory is 66 KB at T = 128 and 165 KB at T = 512.
//
// Rounding follows the TPU kernel: products accumulate in f32, l sums the
// unrounded p, and p (after dropout) is rounded to the dtype of v before
// p V.

#include "attention_common.cuh"

namespace {

using namespace attn;

template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int* __restrict__ mask,
                     T* __restrict__ o, float* __restrict__ m_out,
                     float* __restrict__ l_out, int seq, int hidden, int heads,
                     float scale, Dropout dr) {
  extern __shared__ float smem[];
  const int s_stride = seq + 1;           // odd: score rows in distinct banks
  float* qs = smem;                       // kTile x kStride
  float* kv = qs + kTile * kStride;       // kTile x kStride: a K tile, later a V tile
  float* s = kv + kTile * kStride;        // kTile x s_stride: scores, then p
  float* ls = s + kTile * s_stride;       // kTile row sums

  const int q0 = blockIdx.x * kTile;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const size_t base = (size_t)b * seq * hidden + (size_t)head * kHeadDim;
  const int* mrow = mask ? mask + (size_t)b * seq : nullptr;
  const unsigned salt = dropout_salt(dr.seed, b, head);

  const int tid = threadIdx.x;
  const int row = tid >> 1;   // query row of the tile this thread owns
  const int half = tid & 1;   // it owns columns 2c + half, c < kCols

  load_tile(qs, q + base, q0, seq, hidden);

  // Phase 1: S = scale * Q K^T over key tiles, masked columns filled.
  for (int k0 = 0; k0 < seq; k0 += kTile) {
    __syncthreads();
    load_tile(kv, k + base, k0, seq, hidden);
    __syncthreads();
    float acc[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[c] = 0.f;
    for (int d = 0; d < kHeadDim; ++d) {
      const float qd = qs[row * kStride + d];
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[c] = fmaf(qd, kv[(2 * c + half) * kStride + d], acc[c]);
    }
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = k0 + 2 * c + half;
      if (col < seq) {
        float sc = acc[c] * scale;
        if (mrow != nullptr && mrow[col] <= 0) sc = kBigNeg;
        s[row * s_stride + col] = sc;
      }
    }
  }
  __syncthreads();

  // Phase 2: one warp per row: m = max, p = exp(S - m), l = sum(p), then
  // the dropout keep-mask on p.
  const int warp = tid >> 5;
  const int lane = tid & 31;
  for (int r = warp; r < kTile; r += kThreads / 32) {
    float* sr = s + r * s_stride;
    float mx = -INFINITY;
    for (int j = lane; j < seq; j += 32) mx = fmaxf(mx, sr[j]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < seq; j += 32) {
      float p = expf(sr[j] - mx);
      sum += p;
      if (dr.on) p *= keep_scale(dr, salt, q0 + r, j);
      sr[j] = round_as(p, T());
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      ls[r] = sum;
      const int qrow = q0 + r;
      if (qrow < seq) {
        const size_t idx = ((size_t)b * heads + head) * seq + qrow;
        m_out[idx] = mx;
        l_out[idx] = sum;
      }
    }
  }

  // Phase 3: O = (p V) / l over key tiles.
  float acc[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) acc[c] = 0.f;
  for (int k0 = 0; k0 < seq; k0 += kTile) {
    __syncthreads();
    load_tile(kv, v + base, k0, seq, hidden);
    __syncthreads();
    const int n = min(kTile, seq - k0);
    for (int j = 0; j < n; ++j) {
      const float p = s[row * s_stride + k0 + j];
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[c] = fmaf(p, kv[j * kStride + 2 * c + half], acc[c]);
    }
  }
  const int qrow = q0 + row;
  if (qrow < seq) {
    const float l = ls[row];
    T* orow = o + base + (size_t)qrow * hidden;
#pragma unroll
    for (int c = 0; c < kCols; ++c) store(orow + 2 * c + half, acc[c] / l);
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* mask, void* o,
           void* m, void* l, int batch, int seq, int hidden, int heads, float scale,
           Dropout dr, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((size_t)2 * kTile * kStride + (size_t)kTile * (seq + 1) + kTile);
  cudaError_t err = cudaFuncSetAttribute(attention_fwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((seq + kTile - 1) / kTile, heads, batch);
  attention_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(mask), static_cast<T*>(o), static_cast<float*>(m),
      static_cast<float*>(l), seq, hidden, heads, scale, dr);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point. dtype: 0 = float32, 1 = bfloat16 (q, k, v and o).
// mask is (B, T) int32 with 1 = keep, or null. dropout = 0 turns the
// keep-mask off; otherwise keep iff hash >= thresh, kept p scaled by
// inv_keep. Shapes are checked by the Python wrapper: head dim 64,
// 0 < T <= 512. Returns the CUDA error code of the launch (0 on success).
extern "C" int attention_fwd(const void* q, const void* k, const void* v,
                             const void* mask, void* o, void* m, void* l,
                             int batch, int seq, int hidden, int heads,
                             int dtype, float scale, int dropout, int seed,
                             unsigned thresh, float inv_keep, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dropout dr{dropout, seed, thresh, inv_keep};
  if (dtype == 0)
    return launch<float>(q, k, v, mask, o, m, l, batch, seq, hidden, heads, scale, dr, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, mask, o, m, l, batch, seq, hidden, heads, scale, dr,
                                 st);
  return (int)cudaErrorInvalidValue;
}
