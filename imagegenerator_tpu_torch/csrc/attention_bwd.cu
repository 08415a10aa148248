// Fused multi-head self-attention backward for Hopper (sm_90a).
//
// Replaces imagegenerator_tpu/ops/pallas/attention.py::_pallas_bwd
// (kernel body _bwd_kernel). From the forward's saved (m, l) it recomputes,
// per (batch row, head), with no max or sum over keys:
//   probs = exp(S - m) * (1 / l),     S = scale * Q K^T, masked keys -3e7
//   keep  = the forward's dropout mask times 1 / (1 - rate)
//   pd    = probs * keep, rounded to do's dtype;   dV = pd^T dO
//   dp    = (dO V^T) * keep
//   D     = rowsum(dp * probs)
//   ds    = probs * (dp - D), zero on masked key columns, times scale,
//           rounded to q's dtype;                  dQ = ds K,  dK = ds^T Q
// Products accumulate in f32. The keep-mask is the counter hash of
// attention_common.cuh, the same bits the forward drew; expf is the
// forward's, so the recomputed probabilities are the forward's.
//
// What bounds it: bytes. q, k, v, do are read and dq, dk, dv written once;
// the five 128 x 128 x 64 products of a head are a few microseconds of
// tensor-core time on one SM. No (T, T) tensor and no row term reaches
// device memory.
//
// Two routes, chosen by the Python wrapper from (dtype, T):
//
// 1. Tensor cores: bf16, T <= 128 (attention_bwd_mma_kernel). One launch,
//    one block of 8 warps per (batch row, head), each product once (five
//    per head). Q, K, V and dO of the head stay bf16 in shared memory
//    (72 KB in rows padded to 144 bytes), copied with cp.async in two
//    groups so that S = Q K^T starts while dO and V are still in flight.
//    Step 1, each warp owns 16 queries: S and dP = dO V^T are mma.sync
//    m16n8k16 accumulators (2 x 64 registers a thread); probs from the
//    saved (m, l), the keep-mask hash (once per element), D by two
//    shuffles over the four lanes of a row, and ds all happen in
//    registers; ds, rounded, is repacked as the A fragments of dQ = ds K.
//    pd and ds go to shared memory once as bf16 (T x T each, rows padded
//    to 272 bytes, 68 KB together). Step 2, after the one barrier: each
//    warp owns 16 keys and computes dV = pd^T dO and dK = ds^T Q, reading
//    pd^T and ds^T through ldmatrix.trans. The results leave through the
//    K and V tiles, which step 2 no longer reads, as 16-byte stores.
//    140 KB of shared memory: one block per SM. Padded key columns (past
//    T) score -inf, so probs, pd and ds are exactly 0 there; padded query
//    rows take m = 0 and 1 / l = 0. What is left between it and its bound:
//    with 16 rows a warp, every warp reads the whole of K (twice), V, dO
//    and Q through ldmatrix, two products per 512 bytes read, so the
//    products wait on shared memory and not on the tensor cores; and one
//    block per SM leaves a head's loads, its register arithmetic and its
//    products to run one after the other. Two warps per 16 queries (the
//    keys split between them) and a persistent block that loads the next
//    head while it works on this one were both tried and were no faster.
//
// 2. FMA units: f32 inputs and 128 < T <= 512. The TPU kernel holds a
//    whole (T, T) tile per head; a block cannot at T = 512. So two
//    launches, each recomputing S from (m, l), f32 tiles in shared memory,
//    one shared-memory load per FMA:
//    a. dq: one block per (batch row, head, 64-query tile). It walks the
//       key tiles four times: probs into shared memory (64 x (T + 1) f32),
//       the row term D, ds in place of probs, then dQ = ds K. It writes D
//       (B, heads, T) f32 for launch b.
//    b. dkdv: one block per (batch row, head, 64-key tile). It holds its K
//       and V tiles and walks the query tiles: pd and ds for the (64 key,
//       64 query) tile into shared memory, then dV += pd^T dO and
//       dK += ds^T Q in registers (each thread one key row, 32 of the 64
//       head dims).
//    Shared memory: launch a takes 83 KB at T = 128 and 182 KB at T = 512;
//    launch b takes 101 KB at any T.

#include "attention_common.cuh"
#include "attention_mma.cuh"

namespace {

using namespace attn;

// ------------------------------------------------- tensor cores, T <= 128

constexpr int kMmaWarps = mma::kMaxSeq / 16;  // 16 queries, then 16 keys, each
constexpr int kMmaThreads = 32 * kMmaWarps;
constexpr size_t kMmaSmem = sizeof(mma::bf16) * mma::kMaxSeq * (4 * mma::kRow + 2 * mma::kPRow) +
                            sizeof(int) * mma::kMaxSeq;

__global__ void __launch_bounds__(kMmaThreads, 1)
attention_bwd_mma_kernel(const mma::bf16* __restrict__ q, const mma::bf16* __restrict__ k,
                         const mma::bf16* __restrict__ v, const mma::bf16* __restrict__ dout,
                         const int* __restrict__ mask, const float* __restrict__ m_in,
                         const float* __restrict__ l_in, mma::bf16* __restrict__ dq,
                         mma::bf16* __restrict__ dk, mma::bf16* __restrict__ dv, int seq,
                         int hidden, int heads, float scale, Dropout dr) {
  using namespace mma;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // kMaxSeq x kRow each
  bf16* ks = qs + kMaxSeq * kRow;
  bf16* vs = ks + kMaxSeq * kRow;
  bf16* dos = vs + kMaxSeq * kRow;
  bf16* pds = dos + kMaxSeq * kRow;   // kMaxSeq x kPRow: pd, [query][key]
  bf16* dss = pds + kMaxSeq * kPRow;  // kMaxSeq x kPRow: ds, [query][key]
  int* kind = reinterpret_cast<int*>(dss + kMaxSeq * kPRow);  // kMaxSeq

  const int head = blockIdx.x;
  const int b = blockIdx.y;
  const size_t base = (size_t)b * seq * hidden + (size_t)head * kHeadDim;
  const size_t stat = ((size_t)b * heads + head) * seq;

  load_tile_async<kMaxSeq, kMmaThreads>(qs, q + base, 0, seq, hidden);
  load_tile_async<kMaxSeq, kMmaThreads>(ks, k + base, 0, seq, hidden);
  cp_async_commit();
  load_tile_async<kMaxSeq, kMmaThreads>(dos, dout + base, 0, seq, hidden);
  load_tile_async<kMaxSeq, kMmaThreads>(vs, v + base, 0, seq, hidden);
  cp_async_commit();
  fill_kinds(kind, mask ? mask + (size_t)b * seq : nullptr, seq);

  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * 16;  // the warp's queries, then its keys
  const bool active = r0 < seq;            // the same for the whole warp
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row0 = r0 + g;  // the thread's two queries
  const int row1 = row0 + 8;

  // the rows' statistics travel beside the tiles; a padded row takes m = 0
  // and 1 / l = 0, so its probs are 0
  const float m0 = row0 < seq ? m_in[stat + row0] : 0.f;
  const float m1 = row1 < seq ? m_in[stat + row1] : 0.f;
  const float il0 = row0 < seq ? 1.f / l_in[stat + row0] : 0.f;
  const float il1 = row1 < seq ? 1.f / l_in[stat + row1] : 0.f;

  cp_async_wait<1>();
  __syncthreads();  // Q, K and the column kinds have landed

  // Step 1. S = Q K^T for the warp's 16 queries.
  float s[kKeyTiles][4];
  uint32_t a[4][4];
#pragma unroll
  for (int j = 0; j < kKeyTiles; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
  if (active) {
    load_a(a, qs, r0, lane);
    product_nt(s, a, ks, seq, lane);
  }

  cp_async_wait<0>();
  __syncthreads();  // dO and V have landed

  float dqa[kDimTiles][4];
#pragma unroll
  for (int n = 0; n < kDimTiles; ++n) dqa[n][0] = dqa[n][1] = dqa[n][2] = dqa[n][3] = 0.f;
  if (active) {
    // probs = exp(S - m) / l in place of S; padded rows and columns give 0
    const Columns cols = read_kinds(kind, lane);
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float x0 = s[j][e] * scale;
        float x1 = s[j][2 + e] * scale;
        if ((cols.masked >> (2 * j + e)) & 1u) x0 = x1 = kBigNeg;
        if ((cols.pad >> (2 * j + e)) & 1u) x0 = x1 = -INFINITY;
        s[j][e] = expf(x0 - m0) * il0;
        s[j][2 + e] = expf(x1 - m1) * il1;
      }
    }

    // dP = dO V^T
    float dp[kKeyTiles][4];
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j) dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
    load_a(a, dos, r0, lane);
    product_nt(dp, a, vs, seq, lane);

    // keep-mask on both; pd to shared memory; D = rowsum(dp * probs)
    const unsigned salt = dropout_salt(dr.seed, b, head);
    const unsigned hrow0 = row_term((unsigned)row0, salt);
    const unsigned hrow1 = row_term((unsigned)row1, salt);
    float d0 = 0.f, d1 = 0.f;
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j) {
      float pd[4];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 8 * j + 2 * t + e;
        pd[e] = s[j][e];
        pd[2 + e] = s[j][2 + e];
        if (dr.on) {
          const float k0 = keep_scale_row(dr, hrow0, col);
          const float k1 = keep_scale_row(dr, hrow1, col);
          pd[e] *= k0;
          pd[2 + e] *= k1;
          dp[j][e] *= k0;
          dp[j][2 + e] *= k1;
        }
        d0 = fmaf(dp[j][e], s[j][e], d0);
        d1 = fmaf(dp[j][2 + e], s[j][2 + e], d1);
      }
      *reinterpret_cast<uint32_t*>(pds + row0 * kPRow + 8 * j + 2 * t) = pack_bf16(pd[0], pd[1]);
      *reinterpret_cast<uint32_t*>(pds + row1 * kPRow + 8 * j + 2 * t) = pack_bf16(pd[2], pd[3]);
    }
    d0 = quad_sum(d0);
    d1 = quad_sum(d1);

    // ds = probs * (dp - D) * scale, zero on masked columns, rounded: to
    // shared memory and, as A fragments, into dQ = ds K
    uint32_t dsa[kKeyTiles / 2][4];
#pragma unroll
    for (int j = 0; j < kKeyTiles; ++j) {
      float ds[4];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool masked = (cols.masked >> (2 * j + e)) & 1u;
        ds[e] = masked ? 0.f : s[j][e] * (dp[j][e] - d0) * scale;
        ds[2 + e] = masked ? 0.f : s[j][2 + e] * (dp[j][2 + e] - d1) * scale;
      }
      const uint32_t lo = pack_bf16(ds[0], ds[1]);  // row g
      const uint32_t hi = pack_bf16(ds[2], ds[3]);  // row g + 8
      *reinterpret_cast<uint32_t*>(dss + row0 * kPRow + 8 * j + 2 * t) = lo;
      *reinterpret_cast<uint32_t*>(dss + row1 * kPRow + 8 * j + 2 * t) = hi;
      dsa[j >> 1][(j & 1) * 2] = lo;
      dsa[j >> 1][(j & 1) * 2 + 1] = hi;
    }
    product_nn(dqa, dsa, ks, seq, lane);
  }
  __syncthreads();  // pd and ds are whole; K and V are read no more
  if (!active) return;
  store_rows(ks, dq + base, dqa, r0, 0, seq, hidden, lane);

  // Step 2. dV = pd^T dO and dK = ds^T Q for the warp's 16 keys.
  float acc[kDimTiles][4];
#pragma unroll
  for (int n = 0; n < kDimTiles; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  product_tn(acc, pds, dos, r0, seq, lane);
  store_rows(vs, dv + base, acc, r0, 0, seq, hidden, lane);
#pragma unroll
  for (int n = 0; n < kDimTiles; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  product_tn(acc, dss, qs, r0, seq, lane);
  store_rows(ks, dk + base, acc, r0, 0, seq, hidden, lane);
}

int launch_mma(const void* q, const void* k, const void* v, const void* dout, const void* mask,
               const void* m, const void* l, void* dq, void* dk, void* dv, int batch, int seq,
               int hidden, int heads, float scale, Dropout dr, cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(
      attention_bwd_mma_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kMmaSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(heads, batch);
  attention_bwd_mma_kernel<<<grid, kMmaThreads, kMmaSmem, stream>>>(
      static_cast<const mma::bf16*>(q), static_cast<const mma::bf16*>(k),
      static_cast<const mma::bf16*>(v), static_cast<const mma::bf16*>(dout),
      static_cast<const int*>(mask), static_cast<const float*>(m), static_cast<const float*>(l),
      static_cast<mma::bf16*>(dq), static_cast<mma::bf16*>(dk), static_cast<mma::bf16*>(dv), seq,
      hidden, heads, scale, dr);
  return (int)cudaGetLastError();
}

// ------------------------------------------- FMA units, f32 or T <= 512

template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const int* __restrict__ mask, const float* __restrict__ m_in,
                        const float* __restrict__ l_in, T* __restrict__ dq,
                        float* __restrict__ d_out, int seq, int hidden, int heads,
                        float scale, Dropout dr) {
  extern __shared__ float smem[];
  const int s_stride = seq + 1;
  float* qs = smem;                        // kTile x kStride: Q tile
  float* dos = qs + kTile * kStride;       // kTile x kStride: dO tile
  float* kv = dos + kTile * kStride;       // kTile x kStride: a K or V tile
  float* s = kv + kTile * kStride;         // kTile x s_stride: probs, then ds
  float* ms = s + kTile * s_stride;        // kTile: m of each query row
  float* ils = ms + kTile;                 // kTile: 1 / l of each query row

  const int q0 = blockIdx.x * kTile;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const size_t base = (size_t)b * seq * hidden + (size_t)head * kHeadDim;
  const size_t stat = ((size_t)b * heads + head) * seq;
  const int* mrow = mask ? mask + (size_t)b * seq : nullptr;
  const unsigned salt = dropout_salt(dr.seed, b, head);

  const int tid = threadIdx.x;
  const int row = tid >> 1;
  const int half = tid & 1;
  const int qrow = q0 + row;

  load_tile(qs, q + base, q0, seq, hidden);
  load_tile(dos, dout + base, q0, seq, hidden);
  for (int r = tid; r < kTile; r += kThreads) {
    const bool in = q0 + r < seq;
    ms[r] = in ? m_in[stat + q0 + r] : 0.f;
    ils[r] = in ? 1.f / l_in[stat + q0 + r] : 1.f;
  }

  // Pass 1: probs = exp(S - m) / l into s.
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
        s[row * s_stride + col] = expf(sc - ms[row]) * ils[row];
      }
    }
  }

  // Pass 2: D = rowsum(dp * probs), dp = (dO V^T) * keep.
  float dsum = 0.f;
  for (int k0 = 0; k0 < seq; k0 += kTile) {
    __syncthreads();
    load_tile(kv, v + base, k0, seq, hidden);
    __syncthreads();
    float acc[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[c] = 0.f;
    for (int d = 0; d < kHeadDim; ++d) {
      const float gd = dos[row * kStride + d];
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[c] = fmaf(gd, kv[(2 * c + half) * kStride + d], acc[c]);
    }
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = k0 + 2 * c + half;
      if (col < seq) {
        float dp = acc[c];
        if (dr.on) dp *= keep_scale(dr, salt, qrow, col);
        dsum = fmaf(dp, s[row * s_stride + col], dsum);
      }
    }
  }
  dsum += __shfl_xor_sync(0xffffffffu, dsum, 1);  // the row's two threads
  if (half == 0 && qrow < seq) d_out[stat + qrow] = dsum;

  // Pass 3: ds = probs * (dp - D) * scale in place of probs, rounded to
  // q's dtype; zero on masked key columns.
  for (int k0 = 0; k0 < seq; k0 += kTile) {
    __syncthreads();
    load_tile(kv, v + base, k0, seq, hidden);
    __syncthreads();
    float acc[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[c] = 0.f;
    for (int d = 0; d < kHeadDim; ++d) {
      const float gd = dos[row * kStride + d];
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[c] = fmaf(gd, kv[(2 * c + half) * kStride + d], acc[c]);
    }
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = k0 + 2 * c + half;
      if (col < seq) {
        float dp = acc[c];
        if (dr.on) dp *= keep_scale(dr, salt, qrow, col);
        float* cell = s + row * s_stride + col;
        float ds = *cell * (dp - dsum);
        if (mrow != nullptr && mrow[col] <= 0) ds = 0.f;
        *cell = round_as(ds * scale, T());
      }
    }
  }

  // Pass 4: dQ = ds K.
  float acc[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) acc[c] = 0.f;
  for (int k0 = 0; k0 < seq; k0 += kTile) {
    __syncthreads();
    load_tile(kv, k + base, k0, seq, hidden);
    __syncthreads();
    const int n = min(kTile, seq - k0);
    for (int j = 0; j < n; ++j) {
      const float ds = s[row * s_stride + k0 + j];
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[c] = fmaf(ds, kv[j * kStride + 2 * c + half], acc[c]);
    }
  }
  if (qrow < seq) {
    T* out = dq + base + (size_t)qrow * hidden;
#pragma unroll
    for (int c = 0; c < kCols; ++c) store(out + 2 * c + half, acc[c]);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const int* __restrict__ mask, const float* __restrict__ m_in,
                          const float* __restrict__ l_in, const float* __restrict__ d_in,
                          T* __restrict__ dk, T* __restrict__ dv, int seq, int hidden,
                          int heads, float scale, Dropout dr) {
  extern __shared__ float smem[];
  float* ks = smem;                    // kTile x kStride: this block's K rows
  float* vs = ks + kTile * kStride;    // kTile x kStride: this block's V rows
  float* qs = vs + kTile * kStride;    // kTile x kStride: Q tile
  float* dos = qs + kTile * kStride;   // kTile x kStride: dO tile
  float* pt = dos + kTile * kStride;   // kTile x kStride: pd, [key][query]
  float* dst = pt + kTile * kStride;   // kTile x kStride: probs, then ds, [key][query]
  float* ms = dst + kTile * kStride;   // kTile: m of each query
  float* ils = ms + kTile;             // kTile: 1 / l of each query
  float* ds_row = ils + kTile;         // kTile: D of each query

  const int k0 = blockIdx.x * kTile;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const size_t base = (size_t)b * seq * hidden + (size_t)head * kHeadDim;
  const size_t stat = ((size_t)b * heads + head) * seq;
  const unsigned salt = dropout_salt(dr.seed, b, head);

  const int tid = threadIdx.x;
  const int row = tid >> 1;  // key row of the block this thread owns
  const int half = tid & 1;  // query columns / head dims 2c + half
  const int key = k0 + row;
  const bool key_in = key < seq;
  const bool key_masked = key_in && mask != nullptr && mask[(size_t)b * seq + key] <= 0;

  load_tile(ks, k + base, k0, seq, hidden);
  load_tile(vs, v + base, k0, seq, hidden);

  float dk_acc[kCols], dv_acc[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) dk_acc[c] = dv_acc[c] = 0.f;

  for (int q0 = 0; q0 < seq; q0 += kTile) {
    __syncthreads();
    load_tile(qs, q + base, q0, seq, hidden);
    load_tile(dos, dout + base, q0, seq, hidden);
    for (int r = tid; r < kTile; r += kThreads) {
      const bool in = q0 + r < seq;
      ms[r] = in ? m_in[stat + q0 + r] : 0.f;
      ils[r] = in ? 1.f / l_in[stat + q0 + r] : 1.f;
      ds_row[r] = in ? d_in[stat + q0 + r] : 0.f;
    }
    __syncthreads();

    // probs and pd for (key row, query 2c + half); the keep bits of the
    // 32 cells ride in one register to the ds step.
    unsigned kept = 0u;
    {
      float acc[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[c] = 0.f;
      for (int d = 0; d < kHeadDim; ++d) {
        const float kd = ks[row * kStride + d];
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[c] = fmaf(kd, qs[(2 * c + half) * kStride + d], acc[c]);
      }
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int i = 2 * c + half;
        const int qi = q0 + i;
        float probs = 0.f, pd = 0.f;
        if (key_in && qi < seq) {
          const float sc = key_masked ? kBigNeg : acc[c] * scale;
          probs = expf(sc - ms[i]) * ils[i];
          pd = probs;
          if (dr.on) {
            const float kscale = keep_scale(dr, salt, qi, key);
            if (kscale != 0.f) kept |= 1u << c;
            pd = probs * kscale;
          }
        }
        pt[row * kStride + i] = round_as(pd, T());
        dst[row * kStride + i] = probs;
      }
    }
    // dp = (dO V^T) * keep, then ds = probs * (dp - D), scaled and rounded.
    {
      float acc[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[c] = 0.f;
      for (int d = 0; d < kHeadDim; ++d) {
        const float vd = vs[row * kStride + d];
#pragma unroll
        for (int c = 0; c < kCols; ++c) acc[c] = fmaf(vd, dos[(2 * c + half) * kStride + d], acc[c]);
      }
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int i = 2 * c + half;
        float dp = acc[c];
        if (dr.on) dp = (kept >> c) & 1u ? dp * dr.inv_keep : 0.f;
        float ds = dst[row * kStride + i] * (dp - ds_row[i]);
        if (key_masked || !key_in || q0 + i >= seq) ds = 0.f;
        dst[row * kStride + i] = round_as(ds * scale, T());
      }
    }
    __syncthreads();

    // dV += pd^T dO and dK += ds^T Q for this key row, head dims 2c + half.
    const int n = min(kTile, seq - q0);
    for (int i = 0; i < n; ++i) {
      const float p = pt[row * kStride + i];
      const float g = dst[row * kStride + i];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        dv_acc[c] = fmaf(p, dos[i * kStride + 2 * c + half], dv_acc[c]);
        dk_acc[c] = fmaf(g, qs[i * kStride + 2 * c + half], dk_acc[c]);
      }
    }
  }
  if (key_in) {
    T* dk_row = dk + base + (size_t)key * hidden;
    T* dv_row = dv + base + (size_t)key * hidden;
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      store(dk_row + 2 * c + half, dk_acc[c]);
      store(dv_row + 2 * c + half, dv_acc[c]);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* dout, const void* mask,
           const void* m, const void* l, void* dq, void* dk, void* dv, void* dbuf, int batch,
           int seq, int hidden, int heads, float scale, Dropout dr, cudaStream_t stream) {
  const size_t smem_dq = sizeof(float) * ((size_t)3 * kTile * kStride +
                                          (size_t)kTile * (seq + 1) + 2 * kTile);
  const size_t smem_dkdv = sizeof(float) * ((size_t)6 * kTile * kStride + 3 * kTile);
  cudaError_t err = cudaFuncSetAttribute(attention_bwd_dq_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_dq);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(attention_bwd_dkdv_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dkdv);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((seq + kTile - 1) / kTile, heads, batch);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  const int* mt = static_cast<const int*>(mask);
  const float* mf = static_cast<const float*>(m);
  const float* lf = static_cast<const float*>(l);
  float* df = static_cast<float*>(dbuf);
  attention_bwd_dq_kernel<T><<<grid, kThreads, smem_dq, stream>>>(
      qt, kt, vt, dot, mt, mf, lf, static_cast<T*>(dq), df, seq, hidden, heads, scale, dr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attention_bwd_dkdv_kernel<T><<<grid, kThreads, smem_dkdv, stream>>>(
      qt, kt, vt, dot, mt, mf, lf, df, static_cast<T*>(dk), static_cast<T*>(dv), seq, hidden,
      heads, scale, dr);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point. dtype: 0 = float32, 1 = bfloat16 (q, k, v, dout and the
// three gradients). route: 0 = FMA units (either dtype, 0 < T <= 512; dbuf
// is (B, heads, T) f32 scratch for the row term D), 1 = tensor cores
// (bfloat16, 0 < T <= 128, tensors 16-byte aligned; dbuf is not read and
// may be null). mask is (B, T) int32 with 1 = keep, or null; m and l are
// the forward's (B, heads, T) f32 statistics. The dropout arguments are
// the forward's. Shapes are checked by the Python wrapper. Returns the CUDA
// error code of the launches (0 on success).
extern "C" int attention_bwd(const void* q, const void* k, const void* v, const void* dout,
                             const void* mask, const void* m, const void* l, void* dq,
                             void* dk, void* dv, void* dbuf, int batch, int seq, int hidden,
                             int heads, int dtype, int route, float scale, int dropout,
                             int seed, unsigned thresh, float inv_keep, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dropout dr{dropout, seed, thresh, inv_keep};
  if (route == 1) {
    if (dtype != 1 || seq > mma::kMaxSeq) return (int)cudaErrorInvalidValue;
    return launch_mma(q, k, v, dout, mask, m, l, dq, dk, dv, batch, seq, hidden, heads, scale,
                      dr, st);
  }
  if (dbuf == nullptr) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(q, k, v, dout, mask, m, l, dq, dk, dv, dbuf, batch, seq, hidden,
                         heads, scale, dr, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, dout, mask, m, l, dq, dk, dv, dbuf, batch, seq,
                                 hidden, heads, scale, dr, st);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of one block of the tensor-core route, bytes.
extern "C" int attention_bwd_mma_smem(void) { return (int)kMmaSmem; }
