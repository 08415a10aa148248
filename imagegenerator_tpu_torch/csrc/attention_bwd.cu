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
// attention_common.cuh, the same bits the forward drew.
//
// What bounds it: as in the forward, the (T, T) probabilities never reach
// device memory; products run on the FMA units in f32, one shared-memory
// load per FMA. The TPU kernel holds a whole (T, T) tile per head; a
// Hopper block cannot at T = 512. So two launches, each recomputing S from
// (m, l), with no T x T tensor in device memory:
//   1. dq: one block per (batch row, head, 64-query tile). It walks the key
//      tiles four times: probs into shared memory (64 x (T + 1) f32), the
//      row term D, ds in place of probs, then dQ = ds K. It writes D
//      (B, heads, T) f32 for launch 2.
//   2. dkdv: one block per (batch row, head, 64-key tile). It holds its K
//      and V tiles and walks the query tiles: pd and ds for the (64 key,
//      64 query) tile into shared memory, then dV += pd^T dO and
//      dK += ds^T Q in registers (each thread one key row, 32 of the 64
//      head dims).
// Shared memory: launch 1 takes 83 KB at T = 128 and 182 KB at T = 512;
// launch 2 takes 101 KB at any T. Any 0 < T <= 512 is taken.

#include "attention_common.cuh"

namespace {

using namespace attn;

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
// three gradients). mask is (B, T) int32 with 1 = keep, or null; m and l
// are the forward's (B, heads, T) f32 statistics; dbuf is (B, heads, T)
// f32 scratch for the row term D. The dropout arguments are the forward's.
// Shapes are checked by the Python wrapper. Returns the CUDA error code of
// the launches (0 on success).
extern "C" int attention_bwd(const void* q, const void* k, const void* v, const void* dout,
                             const void* mask, const void* m, const void* l, void* dq,
                             void* dk, void* dv, void* dbuf, int batch, int seq, int hidden,
                             int heads, int dtype, float scale, int dropout, int seed,
                             unsigned thresh, float inv_keep, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dropout dr{dropout, seed, thresh, inv_keep};
  if (dtype == 0)
    return launch<float>(q, k, v, dout, mask, m, l, dq, dk, dv, dbuf, batch, seq, hidden,
                         heads, scale, dr, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, dout, mask, m, l, dq, dk, dv, dbuf, batch, seq,
                                 hidden, heads, scale, dr, st);
  return (int)cudaErrorInvalidValue;
}
