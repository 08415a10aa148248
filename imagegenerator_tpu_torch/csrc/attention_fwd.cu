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
// What bounds it: bytes. Per head the two products are 128 x 128 x 64, a
// few microseconds of tensor-core time on one SM, and q, k, v, o each cross
// device memory once; the (T, T) scores never leave the SM.
//
// Two routes, chosen by the Python wrapper from (dtype, T):
//
// 1. Tensor cores: bf16, T <= 128 (attention_fwd_mma_kernel). One block of
//    4 warps per (batch row, head, 64-query tile). The Q tile and the whole
//    head's K and V stay bf16 in shared memory (45 KB), copied 16 bytes a
//    thread with cp.async into rows padded to 144 bytes, which ldmatrix
//    reads without bank conflicts; there is no key-tile loop. Each warp
//    owns 16 queries. Its scores are the 16 x 128 f32 accumulators of
//    mma.sync m16n8k16 (64 registers a thread); the row max and sum are two
//    shuffles over the four lanes of a row; the mask fill, expf, the
//    dropout hash (addressed by the accumulator's own (query, key)) and the
//    rounding to bf16 happen in registers, and the rounded p is repacked as
//    the A fragments of P V. V is read through ldmatrix.trans. A padded key
//    column (past T) scores -inf and adds exactly 0 to l; a masked one
//    scores -3e7. The result leaves through the warp's own rows of the Q
//    tile as 16-byte stores.
//
// 2. FMA units: f32 inputs (tensor cores would mean TF32) and
//    128 < T <= 512 (attention_fwd_kernel). 128 threads per (batch row,
//    head, 64-query tile); Q, K and V tiles are widened to f32 in shared
//    memory with an odd row stride (65), the score rows with stride T + 1,
//    and the keys are walked in tiles of 64 (66 KB of shared memory at
//    T = 128, 165 KB at T = 512). Each thread owns one query row and 32
//    interleaved columns, with one shared-memory load per FMA: this route
//    is bound by those loads, not by device memory.
//
// Rounding follows the TPU kernel on both routes: products accumulate in
// f32, l sums the unrounded p, and p (after dropout) is rounded to the
// dtype of v before p V. Both use expf, as the backward does.

#include "attention_common.cuh"
#include "attention_mma.cuh"

namespace {

using namespace attn;

// ------------------------------------------------- tensor cores, T <= 128

constexpr int kMmaWarps = 4;                  // 16 queries each
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr int kMmaQueries = 16 * kMmaWarps;   // per block
constexpr size_t kMmaSmem =
    sizeof(mma::bf16) * (kMmaQueries + 2 * mma::kMaxSeq) * mma::kRow + sizeof(int) * mma::kMaxSeq;

__global__ void __launch_bounds__(kMmaThreads)
attention_fwd_mma_kernel(const mma::bf16* __restrict__ q, const mma::bf16* __restrict__ k,
                         const mma::bf16* __restrict__ v, const int* __restrict__ mask,
                         mma::bf16* __restrict__ o, float* __restrict__ m_out,
                         float* __restrict__ l_out, int seq, int hidden, int heads, float scale,
                         Dropout dr) {
  using namespace mma;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // kMmaQueries x kRow
  bf16* ks = qs + kMmaQueries * kRow;             // kMaxSeq x kRow
  bf16* vs = ks + kMaxSeq * kRow;                 // kMaxSeq x kRow
  int* kind = reinterpret_cast<int*>(vs + kMaxSeq * kRow);  // kMaxSeq

  const int q0 = blockIdx.x * kMmaQueries;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const size_t base = (size_t)b * seq * hidden + (size_t)head * kHeadDim;

  load_tile_async<kMmaQueries, kMmaThreads>(qs, q + base, q0, seq, hidden);
  load_tile_async<kMaxSeq, kMmaThreads>(ks, k + base, 0, seq, hidden);
  load_tile_async<kMaxSeq, kMmaThreads>(vs, v + base, 0, seq, hidden);
  cp_async_commit();
  fill_kinds(kind, mask ? mask + (size_t)b * seq : nullptr, seq);
  cp_async_wait<0>();
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * 16;  // the warp's rows of the Q tile
  if (q0 + r0 >= seq) return;              // no barrier follows
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row0 = q0 + r0 + g;  // the thread's two queries
  const int row1 = row0 + 8;

  // S = Q K^T
  float s[kKeyTiles][4];
#pragma unroll
  for (int j = 0; j < kKeyTiles; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
  {
    uint32_t a[4][4];
    load_a(a, qs, r0, lane);
    product_nt(s, a, ks, seq, lane);
  }

  // scale, mask fill, row max
  const Columns cols = read_kinds(kind, lane);
  float m0 = -INFINITY, m1 = -INFINITY;
#pragma unroll
  for (int j = 0; j < kKeyTiles; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float x0 = s[j][e] * scale;
      float x1 = s[j][2 + e] * scale;
      if ((cols.masked >> (2 * j + e)) & 1u) x0 = x1 = kBigNeg;
      if ((cols.pad >> (2 * j + e)) & 1u) x0 = x1 = -INFINITY;
      s[j][e] = x0;
      s[j][2 + e] = x1;
      m0 = fmaxf(m0, x0);
      m1 = fmaxf(m1, x1);
    }
  }
  m0 = quad_max(m0);
  m1 = quad_max(m1);

  // p = exp(S - m), l = rowsum(p) before dropout and rounding; then the
  // keep-mask, and p rounded to bf16 as the A fragments of P V
  const unsigned salt = dropout_salt(dr.seed, b, head);
  const unsigned hrow0 = row_term((unsigned)row0, salt);
  const unsigned hrow1 = row_term((unsigned)row1, salt);
  float l0 = 0.f, l1 = 0.f;
  uint32_t p[kKeyTiles / 2][4];
#pragma unroll
  for (int j = 0; j < kKeyTiles; ++j) {
    float pr[4];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int col = 8 * j + 2 * t + e;
      float p0 = expf(s[j][e] - m0);
      float p1 = expf(s[j][2 + e] - m1);
      l0 += p0;
      l1 += p1;
      if (dr.on) {
        p0 *= keep_scale_row(dr, hrow0, col);
        p1 *= keep_scale_row(dr, hrow1, col);
      }
      pr[e] = p0;
      pr[2 + e] = p1;
    }
    p[j >> 1][(j & 1) * 2] = pack_bf16(pr[0], pr[1]);      // row g
    p[j >> 1][(j & 1) * 2 + 1] = pack_bf16(pr[2], pr[3]);  // row g + 8
  }
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);

  // O = (P V) / l
  float acc[kDimTiles][4];
#pragma unroll
  for (int n = 0; n < kDimTiles; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  product_nn(acc, p, vs, seq, lane);
#pragma unroll
  for (int n = 0; n < kDimTiles; ++n) {
    acc[n][0] /= l0;
    acc[n][1] /= l0;
    acc[n][2] /= l1;
    acc[n][3] /= l1;
  }
  store_rows(qs, o + base, acc, r0, q0, seq, hidden, lane);
  if (t == 0) {
    const size_t stat = ((size_t)b * heads + head) * seq;
    if (row0 < seq) {
      m_out[stat + row0] = m0;
      l_out[stat + row0] = l0;
    }
    if (row1 < seq) {
      m_out[stat + row1] = m1;
      l_out[stat + row1] = l1;
    }
  }
}

int launch_mma(const void* q, const void* k, const void* v, const void* mask, void* o, void* m,
               void* l, int batch, int seq, int hidden, int heads, float scale, Dropout dr,
               cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      attention_fwd_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMmaSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((seq + kMmaQueries - 1) / kMmaQueries, heads, batch);
  attention_fwd_mma_kernel<<<grid, kMmaThreads, kMmaSmem, stream>>>(
      static_cast<const mma::bf16*>(q), static_cast<const mma::bf16*>(k),
      static_cast<const mma::bf16*>(v), static_cast<const int*>(mask),
      static_cast<mma::bf16*>(o), static_cast<float*>(m), static_cast<float*>(l), seq, hidden,
      heads, scale, dr);
  return (int)cudaGetLastError();
}

// ------------------------------------------- FMA units, f32 or T <= 512

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
// route: 0 = FMA units (either dtype, 0 < T <= 512), 1 = tensor cores
// (bfloat16, 0 < T <= 128, tensors 16-byte aligned). mask is (B, T) int32
// with 1 = keep, or null. dropout = 0 turns the keep-mask off; otherwise
// keep iff hash >= thresh, kept p scaled by inv_keep. Shapes are checked
// by the Python wrapper: head dim 64. Returns the CUDA error code of the
// launch (0 on success).
extern "C" int attention_fwd(const void* q, const void* k, const void* v,
                             const void* mask, void* o, void* m, void* l,
                             int batch, int seq, int hidden, int heads,
                             int dtype, int route, float scale, int dropout, int seed,
                             unsigned thresh, float inv_keep, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dropout dr{dropout, seed, thresh, inv_keep};
  if (route == 1) {
    if (dtype != 1 || seq > mma::kMaxSeq) return (int)cudaErrorInvalidValue;
    return launch_mma(q, k, v, mask, o, m, l, batch, seq, hidden, heads, scale, dr, st);
  }
  if (dtype == 0)
    return launch<float>(q, k, v, mask, o, m, l, batch, seq, hidden, heads, scale, dr, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, mask, o, m, l, batch, seq, hidden, heads, scale, dr,
                                 st);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of one block of the tensor-core route, bytes.
extern "C" int attention_fwd_mma_smem(void) { return (int)kMmaSmem; }
