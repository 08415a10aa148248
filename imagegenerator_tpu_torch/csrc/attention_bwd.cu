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
// scale = 1 / sqrt(d) of the actual head dim d. Products accumulate in
// f32. The keep-mask is the counter hash of attention_common.cuh, the same
// bits the forward drew; expf is the forward's, so the recomputed
// probabilities are the forward's.
//
// What bounds it: bytes at T = 128 (q, k, v, do read and dq, dk, dv
// written once, 0.1 ms at (256, 128, 768)), operations from T of a few
// hundred (8 B T^2 H of model products and the recomputed scores). No
// (T, T) tensor reaches device memory, and no sum is made with atomics:
// two runs give the same bits.
//
// Four kernels, chosen as in attention_fwd.cu:
//
// 1. Tensor cores, whole head: bf16, d = 64, T <= 128
//    (attention_bwd_mma_kernel). One launch,
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
// 2. Tensor cores, Hopper: bf16, d = 32, 64 or 128 outside kernel 1's
//    domain (attention_bwd_{dq,dkdv}_wgmma_kernel, the "wgmma" route;
//    machinery in attention_sm90.cuh). The same two launches and the same
//    arithmetic as kernel 3, persistent (one block a SM over units of 128
//    queries, then of 128 keys), each block a producer warp feeding TMA
//    tiles through a ring of mbarriers and two consumer warpgroups running
//    wgmma: launch a forms S = Q K^T and dP = dO V^T from shared memory,
//    writes D = rowsum(dp * probs) in pass 1 and adds dQ += ds K (ds from
//    registers, K read MN-major) in pass 2; launch b forms S^T = K Q^T and
//    dP^T = V dO^T and adds dV += pd^T dO and dK += ds^T Q (pd^T and ds^T
//    from registers, dO and Q read MN-major), the query statistics (m, l,
//    D) read a tile ahead by the producer. No atomics: two runs give the
//    same bits. What bounds it: its load pipeline (K and V twice a query
//    tile in launch a, Q and dO once a key tile in launch b), then the exp
//    and the keep-mask hash, which the two warpgroups take in turns with
//    their score products. At (256, 512,
//    768) it is slower than F.scaled_dot_product_attention's backward
//    (PERF.md). A flash-style backward takes D from dO . O and sums dQ
//    with atomics in one pass over the keys; the JAX kernel's D (from dp
//    and the probabilities) needs a pass of its own, and the bits must
//    repeat, so dQ stays in one block.
//
// 3. Tensor cores, tiled: bf16, 8 <= d <= 256 off kernel 2's head dims. No block can
//    hold a head past T = 128, and D needs a whole row of keys before any
//    ds of that row exists, so two launches, 4 warps a block, every tile
//    through a two-stage cp.async ring, the contraction over d zero-padded
//    to a multiple of 16 in shared memory, p formed as the tiled forward
//    forms it (tile_exp):
//    a. dq (attention_bwd_dq_tiled_kernel): per (batch row, head, 64-query
//       tile), each warp 16 queries, key tiles of 32. Pass 1 over the key
//       tiles: S and dP, probs and the keep-mask in registers, D =
//       rowsum(dp * probs), written to a (B, heads, T) f32 buffer for
//       launch b. Pass 2: S and dP again, ds in registers, rounded and
//       repacked as the A fragments of dQ += ds K. Five products a key
//       tile.
//    b. dk, dv (attention_bwd_dkdv_tiled_kernel): per (batch row, head,
//       64-key tile), each warp 16 keys, the block's K and V resident; over
//       the query tiles S^T = K Q^T and dP^T = V dO^T, probs^T from the
//       queries' (m, l), pd^T and ds^T (with D from launch a) repacked as A
//       fragments of dV += pd^T dO and dK += ds^T Q. Four products a query
//       tile. At kDim 256 the 16 x 256 accumulators of dK and dV do not fit
//       a thread's registers together, so the output's head dims go in two
//       halves of 128, each with its own walk over the queries.
//    dQ is summed inside one block in a fixed order, so it is the same from
//    run to run (f32 atomics would not be). Nine products against the five
//    of the whole-head kernel, each waiting on ldmatrix and on the one
//    before it with 16 rows a warp: at (256, 512, 768) the pair runs at
//    about 15% of the bf16 peak (PERF.md).
//
// 4. FMA units: f32 inputs, or bf16 with d > 256. The same two launches on
//    64 x 64 f32 pieces in shared memory (odd row stride 65), one
//    shared-memory load per FMA, any T and any d: a. dq, pass 1 for D and
//    pass 2 for dQ per 64-wide piece of the head dims; b. dk, dv per 64-key
//    tile, over the query tiles, per 64-wide piece of the head dims (each
//    thread one key row, 32 of the piece's head dims).

#include "attention_common.cuh"
#include "attention_mma.cuh"
#include "attention_sm90.cuh"

namespace {

using namespace attn;

// ------------------------------- tensor cores, whole head: d = 64, T <= 128

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
  fill_tile_kinds<kMaxSeq>(kind, mask ? mask + (size_t)b * seq : nullptr, 0, seq);

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
#pragma unroll
  for (int j = 0; j < kKeyTiles; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
  if (active) tile_nt<kHeadDim, kMaxSeq>(s, qs, r0, ks, kHeadDim / 16, seq, lane);

  cp_async_wait<0>();
  __syncthreads();  // dO and V have landed

  float dqa[kDimTiles][4];
#pragma unroll
  for (int n = 0; n < kDimTiles; ++n) dqa[n][0] = dqa[n][1] = dqa[n][2] = dqa[n][3] = 0.f;
  if (active) {
    // probs = exp(S - m) / l in place of S; padded rows and columns give 0
    const Columns cols = read_tile_kinds<kMaxSeq>(kind, lane);
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
    tile_nt<kHeadDim, kMaxSeq>(dp, dos, r0, vs, kHeadDim / 16, seq, lane);

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
    tile_nn<kHeadDim, kMaxSeq, kHeadDim>(dqa, dsa, ks, 0, kHeadDim / 16, seq, lane);
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

// ---------------------------------------- tensor cores, tiled: d <= 256

// Tiles and warps, picked by timing on an H100 at (256, 512, 768), head
// dim 64: key tiles of 32 in launch a (113 registers against 167 at 64, so
// 4 blocks a SM) were faster; 8 warps in either launch, and query tiles of
// 32 in launch b, slower.
template <int kDim>
constexpr int dq_keys() { return 32; }
template <int kDim>
constexpr int dq_warps() { return 4; }
template <int kDim>
constexpr int dkdv_warps() { return 4; }
template <int kDim>
constexpr int dkdv_queries() { return kDim >= 128 ? 32 : 64; }
template <int kDim>
constexpr int dkdv_chunk() { return kDim >= 256 ? 128 : kDim; }

template <int kDim, int kKeys, int kWarps>
constexpr size_t dq_tiled_smem() {
  return sizeof(mma::bf16) * (2 * 16 * kWarps + 4 * kKeys) * mma::Tiled<kDim>::kRowT +
         sizeof(int) * 2 * kKeys;
}

template <int kDim, int kQueries, int kWarps>
constexpr size_t dkdv_tiled_smem() {
  return sizeof(mma::bf16) * (2 * 16 * kWarps + 4 * kQueries) * mma::Tiled<kDim>::kRowT +
         sizeof(float) * 2 * 4 * kQueries;
}

template <int kDim, int kKeys, int kWarps>
__global__ void __launch_bounds__(32 * kWarps)
attention_bwd_dq_tiled_kernel(const mma::bf16* __restrict__ q, const mma::bf16* __restrict__ k,
                              const mma::bf16* __restrict__ v, const mma::bf16* __restrict__ dout,
                              const int* __restrict__ mask, const float* __restrict__ m_in,
                              const float* __restrict__ l_in, mma::bf16* __restrict__ dq,
                              float* __restrict__ d_out, int seq, int hidden, int heads, int dim,
                              float scale, Dropout dr) {
  using namespace mma;
  constexpr int kRowT = Tiled<kDim>::kRowT;
  constexpr int kTileElems = kKeys * kRowT;
  constexpr int kTiledRows = 16 * kWarps;  // the block's queries
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // kTiledRows x kRowT
  bf16* dos = qs + kTiledRows * kRowT;            // kTiledRows x kRowT
  bf16* ks = dos + kTiledRows * kRowT;            // 2 stages of kKeys x kRowT
  bf16* vs = ks + 2 * kTileElems;                 // 2 stages of kKeys x kRowT
  int* kind = reinterpret_cast<int*>(vs + 2 * kTileElems);  // 2 stages of kKeys

  const int q0 = blockIdx.x * kTiledRows;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const size_t base = (size_t)b * seq * hidden + (size_t)head * dim;
  const size_t stat = ((size_t)b * heads + head) * seq;
  const int* mask_row = mask ? mask + (size_t)b * seq : nullptr;
  const int nk = (dim + 15) >> 4;
  const int tiles = (seq + kKeys - 1) / kKeys;

  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * 16;  // the warp's queries in the tile
  const bool active = q0 + r0 < seq;
  const int t = lane & 3;
  const int row0 = q0 + r0 + (lane >> 2);  // the thread's two queries
  const int row1 = row0 + 8;
  // a padded row takes m = 0 and 1 / l = 0, so its probs are 0
  const float m0 = row0 < seq ? m_in[stat + row0] : 0.f;
  const float m1 = row1 < seq ? m_in[stat + row1] : 0.f;
  const float il0 = row0 < seq ? 1.f / l_in[stat + row0] : 0.f;
  const float il1 = row1 < seq ? 1.f / l_in[stat + row1] : 0.f;
  const unsigned salt = dropout_salt(dr.seed, b, head);
  const unsigned hrow0 = row_term((unsigned)row0, salt);
  const unsigned hrow1 = row_term((unsigned)row1, salt);
  // p as the forward forms it (tile_exp)
  const float sl2e = scale * kLog2e;
  const float ml0 = m0 * kLog2e, ml1 = m1 * kLog2e;
  const float mb0 = (kBigNeg - m0) * kLog2e, mb1 = (kBigNeg - m1) * kLog2e;

  auto stage = [&](int i) {
    const int k0 = i * kKeys;
    load_rows_async<kDim, kKeys>(ks + (i & 1) * kTileElems, k + base, k0, seq, hidden, dim);
    load_rows_async<kDim, kKeys>(vs + (i & 1) * kTileElems, v + base, k0, seq, hidden, dim);
    fill_tile_kinds<kKeys>(kind + (i & 1) * kKeys, mask_row, k0, seq);
    cp_async_commit();
  };
  auto next = [&](int i) {
    if (i + 1 < tiles) {
      stage(i + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
  };
  // probs (in place of S) and dp = (dO V^T) * keep of key tile i, and the
  // column kinds
  auto recompute = [&](float (&s)[kKeys / 8][4], float (&dp)[kKeys / 8][4], int i) {
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) {
      s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
      dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
    }
    const int n_valid = seq - i * kKeys;
    tile_nt<kDim, kKeys>(s, qs, r0, ks + (i & 1) * kTileElems, nk, n_valid, lane);
    tile_nt<kDim, kKeys>(dp, dos, r0, vs + (i & 1) * kTileElems, nk, n_valid, lane);
    const Columns cols = read_tile_kinds<kKeys>(kind + (i & 1) * kKeys, lane);
    tile_exp<kKeys>(s, cols, sl2e, ml0, ml1, mb0, mb1);
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        s[j][e] *= il0;
        s[j][2 + e] *= il1;
        if (dr.on) {
          const int col = i * kKeys + 8 * j + 2 * t + e;
          dp[j][e] *= keep_scale_row(dr, hrow0, col);
          dp[j][2 + e] *= keep_scale_row(dr, hrow1, col);
        }
      }
    }
    return cols;
  };

  load_rows_async<kDim, kTiledRows>(qs, q + base, q0, seq, hidden, dim);
  load_rows_async<kDim, kTiledRows>(dos, dout + base, q0, seq, hidden, dim);
  stage(0);  // one group with the Q and dO tiles

  // Pass 1: D = rowsum(dp * probs).
  float d0 = 0.f, d1 = 0.f;
  for (int i = 0; i < tiles; ++i) {
    next(i);
    if (active) {
      float s[kKeys / 8][4], dp[kKeys / 8][4];
      recompute(s, dp, i);
#pragma unroll
      for (int j = 0; j < kKeys / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          d0 = fmaf(dp[j][e], s[j][e], d0);
          d1 = fmaf(dp[j][2 + e], s[j][2 + e], d1);
        }
      }
    }
    __syncthreads();
  }
  d0 = quad_sum(d0);
  d1 = quad_sum(d1);
  if (active && t == 0) {
    if (row0 < seq) d_out[stat + row0] = d0;
    if (row1 < seq) d_out[stat + row1] = d1;
  }

  // Pass 2: ds = probs * (dp - D) * scale, zero on masked columns, rounded
  // to bf16 as the A fragments of dQ += ds K.
  float acc[kDim / 8][4];
#pragma unroll
  for (int n = 0; n < kDim / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  stage(0);
  for (int i = 0; i < tiles; ++i) {
    next(i);
    if (active) {
      float s[kKeys / 8][4], dp[kKeys / 8][4];
      const Columns cols = recompute(s, dp, i);
      uint32_t dsa[kKeys / 16][4];
#pragma unroll
      for (int j = 0; j < kKeys / 8; ++j) {
        float ds[4];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool masked = (cols.masked >> (2 * j + e)) & 1u;
          ds[e] = masked ? 0.f : s[j][e] * (dp[j][e] - d0) * scale;
          ds[2 + e] = masked ? 0.f : s[j][2 + e] * (dp[j][2 + e] - d1) * scale;
        }
        dsa[j >> 1][(j & 1) * 2] = pack_bf16(ds[0], ds[1]);      // row g
        dsa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);  // row g + 8
      }
      tile_nn<kDim, kKeys, kDim>(acc, dsa, ks + (i & 1) * kTileElems, 0, nk, seq - i * kKeys, lane);
    }
    __syncthreads();
  }
  if (active) store_frags<kDim>(dq + base, acc, row0, 0, seq, hidden, dim, lane);
}

template <int kDim, int kQueries, int kChunk, int kWarps>
__global__ void __launch_bounds__(32 * kWarps)
attention_bwd_dkdv_tiled_kernel(const mma::bf16* __restrict__ q, const mma::bf16* __restrict__ k,
                                const mma::bf16* __restrict__ v,
                                const mma::bf16* __restrict__ dout, const int* __restrict__ mask,
                                const float* __restrict__ m_in, const float* __restrict__ l_in,
                                const float* __restrict__ d_in, mma::bf16* __restrict__ dk,
                                mma::bf16* __restrict__ dv, int seq, int hidden, int heads,
                                int dim, float scale, Dropout dr) {
  using namespace mma;
  constexpr int kRowT = Tiled<kDim>::kRowT;
  constexpr int kTileElems = kQueries * kRowT;
  constexpr int kTiledRows = 16 * kWarps;  // the block's keys
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // kTiledRows x kRowT: the block's keys
  bf16* vs = ks + kTiledRows * kRowT;             // kTiledRows x kRowT
  bf16* qs = vs + kTiledRows * kRowT;             // 2 stages of kQueries x kRowT
  bf16* dos = qs + 2 * kTileElems;                // 2 stages of kQueries x kRowT
  // 2 stages of the queries' m log2 e, (-3e7 - m) log2 e, 1 / l and D
  float* st = reinterpret_cast<float*>(dos + 2 * kTileElems);

  const int k0 = blockIdx.x * kTiledRows;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const size_t base = (size_t)b * seq * hidden + (size_t)head * dim;
  const size_t stat = ((size_t)b * heads + head) * seq;
  const int nk = (dim + 15) >> 4;
  const int tiles = (seq + kQueries - 1) / kQueries;

  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * 16;  // the warp's keys in the tile
  const bool active = k0 + r0 < seq;
  const int t = lane & 3;
  const int key0 = k0 + r0 + (lane >> 2);  // the thread's two keys
  const int key1 = key0 + 8;
  const bool masked0 = key0 < seq && mask != nullptr && mask[(size_t)b * seq + key0] <= 0;
  const bool masked1 = key1 < seq && mask != nullptr && mask[(size_t)b * seq + key1] <= 0;
  // the keep-mask hash of (query r, key c) is hash_finish(r * 0x9E3779B9 +
  // key_term(c)): the key's part summed once
  const unsigned salt = dropout_salt(dr.seed, b, head);
  const unsigned kterm0 = (unsigned)key0 * 0x85EBCA6Bu + salt * 0xC2B2AE35u;
  const unsigned kterm1 = (unsigned)key1 * 0x85EBCA6Bu + salt * 0xC2B2AE35u;
  const float sl2e = scale * kLog2e;

  // query tile i and its statistics into stage i % 2, one group; a query
  // past T takes m = 0, 1 / l = 0 and D = 0, so its probs are 0
  auto stage = [&](int i) {
    const int q0 = i * kQueries;
    load_rows_async<kDim, kQueries>(qs + (i & 1) * kTileElems, q + base, q0, seq, hidden, dim);
    load_rows_async<kDim, kQueries>(dos + (i & 1) * kTileElems, dout + base, q0, seq, hidden, dim);
    float* sp = st + (i & 1) * 4 * kQueries;
    for (int c = threadIdx.x; c < kQueries; c += 32 * kWarps) {
      const bool in = q0 + c < seq;
      const float m = in ? m_in[stat + q0 + c] : 0.f;
      sp[c] = m * kLog2e;
      sp[kQueries + c] = (kBigNeg - m) * kLog2e;
      sp[2 * kQueries + c] = in ? 1.f / l_in[stat + q0 + c] : 0.f;
      sp[3 * kQueries + c] = in ? d_in[stat + q0 + c] : 0.f;
    }
    cp_async_commit();
  };
  auto next = [&](int i) {
    if (i + 1 < tiles) {
      stage(i + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
  };

  load_rows_async<kDim, kTiledRows>(ks, k + base, k0, seq, hidden, dim);
  load_rows_async<kDim, kTiledRows>(vs, v + base, k0, seq, hidden, dim);
  for (int c0 = 0; c0 < dim; c0 += kChunk) {
    stage(0);  // the first time, one group with the K and V tiles
    float acc_dk[kChunk / 8][4], acc_dv[kChunk / 8][4];
#pragma unroll
    for (int n = 0; n < kChunk / 8; ++n) {
      acc_dk[n][0] = acc_dk[n][1] = acc_dk[n][2] = acc_dk[n][3] = 0.f;
      acc_dv[n][0] = acc_dv[n][1] = acc_dv[n][2] = acc_dv[n][3] = 0.f;
    }
    for (int i = 0; i < tiles; ++i) {
      next(i);
      if (active) {
        const int q0 = i * kQueries;
        const bf16* qt = qs + (i & 1) * kTileElems;
        const bf16* dot = dos + (i & 1) * kTileElems;
        const float* sp = st + (i & 1) * 4 * kQueries;
        float s[kQueries / 8][4], dp[kQueries / 8][4];
#pragma unroll
        for (int j = 0; j < kQueries / 8; ++j) {
          s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
          dp[j][0] = dp[j][1] = dp[j][2] = dp[j][3] = 0.f;
        }
        tile_nt<kDim, kQueries>(s, ks, r0, qt, nk, seq - q0, lane);    // S^T = K Q^T
        tile_nt<kDim, kQueries>(dp, vs, r0, dot, nk, seq - q0, lane);  // dP^T = V dO^T
        uint32_t pda[kQueries / 16][4], dsa[kQueries / 16][4];
#pragma unroll
        for (int j = 0; j < kQueries / 8; ++j) {
          float pd[4], ds[4];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int c = 8 * j + 2 * t + e;  // the query, in the tile
            const float ml = sp[c], mb = sp[kQueries + c];
            const float ilq = sp[2 * kQueries + c], dq_row = sp[3 * kQueries + c];
            // p as the forward forms it (tile_exp), for key0 and key1
            const float p0 = ex2(masked0 ? mb : fmaf(s[j][e], sl2e, -ml)) * ilq;
            const float p1 = ex2(masked1 ? mb : fmaf(s[j][2 + e], sl2e, -ml)) * ilq;
            float keep0 = 1.f, keep1 = 1.f;
            if (dr.on) {
              const unsigned qterm = (unsigned)(q0 + c) * 0x9E3779B9u;
              keep0 = hash_finish(qterm + kterm0) >= dr.thresh ? dr.inv_keep : 0.f;
              keep1 = hash_finish(qterm + kterm1) >= dr.thresh ? dr.inv_keep : 0.f;
            }
            pd[e] = dr.on ? p0 * keep0 : p0;
            pd[2 + e] = dr.on ? p1 * keep1 : p1;
            const float dp0 = dr.on ? dp[j][e] * keep0 : dp[j][e];
            const float dp1 = dr.on ? dp[j][2 + e] * keep1 : dp[j][2 + e];
            ds[e] = masked0 ? 0.f : p0 * (dp0 - dq_row) * scale;
            ds[2 + e] = masked1 ? 0.f : p1 * (dp1 - dq_row) * scale;
          }
          pda[j >> 1][(j & 1) * 2] = pack_bf16(pd[0], pd[1]);      // key row g
          pda[j >> 1][(j & 1) * 2 + 1] = pack_bf16(pd[2], pd[3]);  // key row g + 8
          dsa[j >> 1][(j & 1) * 2] = pack_bf16(ds[0], ds[1]);
          dsa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
        }
        tile_nn<kDim, kQueries, kChunk>(acc_dv, pda, dot, c0, nk, seq - q0, lane);  // dV += pd^T dO
        tile_nn<kDim, kQueries, kChunk>(acc_dk, dsa, qt, c0, nk, seq - q0, lane);   // dK += ds^T Q
      }
      __syncthreads();
    }
    if (active) {
      store_frags<kChunk>(dv + base, acc_dv, key0, c0, seq, hidden, dim, lane);
      store_frags<kChunk>(dk + base, acc_dk, key0, c0, seq, hidden, dim, lane);
    }
  }
}

template <int kDim>
int launch_tiled(const void* q, const void* k, const void* v, const void* dout, const void* mask,
                 const void* m, const void* l, void* dq, void* dk, void* dv, void* dbuf, int batch,
                 int seq, int hidden, int heads, int dim, float scale, Dropout dr,
                 cudaStream_t stream) {
  constexpr int kKeys = dq_keys<kDim>();
  constexpr int kQueries = dkdv_queries<kDim>();
  constexpr int kChunk = dkdv_chunk<kDim>();
  constexpr int kDqWarps = dq_warps<kDim>();
  constexpr int kDkdvWarps = dkdv_warps<kDim>();
  constexpr size_t smem_dq = dq_tiled_smem<kDim, kKeys, kDqWarps>();
  constexpr size_t smem_dkdv = dkdv_tiled_smem<kDim, kQueries, kDkdvWarps>();
  auto* dq_kernel = attention_bwd_dq_tiled_kernel<kDim, kKeys, kDqWarps>;
  auto* dkdv_kernel = attention_bwd_dkdv_tiled_kernel<kDim, kQueries, kChunk, kDkdvWarps>;
  cudaError_t err = cudaFuncSetAttribute(dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_dq);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(dkdv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_dkdv);
  if (err != cudaSuccess) return (int)err;
  const mma::bf16* qt = static_cast<const mma::bf16*>(q);
  const mma::bf16* kt = static_cast<const mma::bf16*>(k);
  const mma::bf16* vt = static_cast<const mma::bf16*>(v);
  const mma::bf16* dot = static_cast<const mma::bf16*>(dout);
  const int* mt = static_cast<const int*>(mask);
  const float* mf = static_cast<const float*>(m);
  const float* lf = static_cast<const float*>(l);
  float* df = static_cast<float*>(dbuf);
  const dim3 dq_grid((seq + 16 * kDqWarps - 1) / (16 * kDqWarps), heads, batch);
  dq_kernel<<<dq_grid, 32 * kDqWarps, smem_dq, stream>>>(qt, kt, vt, dot, mt, mf, lf,
                                                 static_cast<mma::bf16*>(dq), df, seq, hidden,
                                                 heads, dim, scale, dr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 dkdv_grid((seq + 16 * kDkdvWarps - 1) / (16 * kDkdvWarps), heads, batch);
  dkdv_kernel<<<dkdv_grid, 32 * kDkdvWarps, smem_dkdv, stream>>>(qt, kt, vt, dot, mt, mf, lf, df,
                                                     static_cast<mma::bf16*>(dk),
                                                     static_cast<mma::bf16*>(dv), seq, hidden,
                                                     heads, dim, scale, dr);
  return (int)cudaGetLastError();
}

// -------------------------------- tensor cores, Hopper: d = 32, 64, 128

namespace hop {

constexpr int kConsumers = 2;                      // warpgroups of 64 rows
constexpr int kRows = 64 * kConsumers;             // queries (launch a) or keys (launch b) of a unit
constexpr int kThreads = 128 * (kConsumers + 1);  // and a producer warpgroup

// Launch a walks key tiles of 64 (S and dP are then 32 registers each).
// (Two slabs of 64 queries a warpgroup, so that each K and V tile served
// twice the queries, were no faster with dropout on; nor was keeping a
// head's K and V in the ring from pass 1 to pass 2.) Launch b walks query tiles of 64, 32 at d = 128, where the dK and dV
// accumulators take 128 registers a thread. Tiles in flight: as many as
// shared memory holds beside two units' resident tiles, up to 6.
constexpr int kDqKeys = 64;
template <int kD>
constexpr int dkdv_queries() { return kD >= 128 ? 32 : 64; }
template <int kD>
constexpr int kDqStages = kD >= 128 ? 3 : 6;
template <int kD>
constexpr int kDkdvStages = kD >= 128 ? 4 : 6;

// Launch a's shared memory from a 1024-byte boundary: two slots of the Q
// and dO tiles (this unit's and the next one's), the K and V tiles of
// each stage, each stage's column bits, the barriers (the slots' full and
// empty, the stages' full and empty).
template <int kD, int kN = kDqKeys, int kStages = kDqStages<kD>>
struct DqSmem {
  static constexpr int kSlot = 2 * kRows * kD * 2;  // Q, then dO
  static constexpr int kK = 2 * kSlot;
  static constexpr int kV = kK + kStages * kN * kD * 2;
  static constexpr int kBits = kV + kStages * kN * kD * 2;
  static constexpr int kBar = kBits + kStages * 4 * 8;
  static constexpr int kBytes = kBar + 8 * (4 + 2 * kStages) + 1024;
};

// Launch b's: two slots of the K and V tiles, the Q and dO tiles of each
// stage, each stage's query statistics (m log2 e, (-3e7 - m) log2 e,
// 1 / l, D), the barriers.
template <int kD, int kQ, int kStages = kDkdvStages<kD>>
struct DkdvSmem {
  static constexpr int kSlot = 2 * kRows * kD * 2;  // K, then V
  static constexpr int kQt = 2 * kSlot;
  static constexpr int kDo = kQt + kStages * kQ * kD * 2;
  static constexpr int kStat = kDo + kStages * kQ * kD * 2;
  static constexpr int kBar = kStat + kStages * 4 * kQ * 4;
  static constexpr int kBytes = kBar + 8 * (4 + 2 * kStages) + 1024;
};

template <int kStages>
__device__ __forceinline__ void advance(int& stage, unsigned& phase) {
  if (++stage == kStages) {
    stage = 0;
    phase ^= 1;
  }
}

}  // namespace hop

// Launch a, persistent: one block a SM walks the units (batch row, head,
// 128-query tile); warpgroups 0 and 1 consume, 64 queries each, one warp
// of warpgroup 2 produces (setmaxnreg hands its registers over). The
// producer loads each unit's Q and dO tiles by TMA into one of two slots,
// then the K and V tiles of every key tile twice through a ring of full /
// empty mbarriers, each with its keys' column bits (the mask read one
// tile ahead). A warpgroup computes S = Q K^T and dP = dO V^T by wgmma
// from shared memory (d / 16 m64n64k16 each) and the exp, in its turn
// (named barriers) with the other warpgroup; pass 1 forms the probabilities from the saved (m, l)
// (tile_exp), the keep-mask on dp and D = rowsum(dp * probs), written for
// launch b; pass 2 forms ds, rounds it to bf16 as register A fragments
// and adds dQ += ds K by wgmma with K read MN-major. dQ is summed in one
// block in a fixed order.
template <int kD>
__global__ void __launch_bounds__(hop::kThreads, 1)
attention_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                              const int* __restrict__ mask, const float* __restrict__ m_in,
                              const float* __restrict__ l_in, mma::bf16* __restrict__ dq,
                              float* __restrict__ d_out, int seq, int hidden, int heads, float scale,
                              Dropout dr, int units) {
  using namespace mma;
  using L = sm90::Layout<kD>;
  using S = hop::DqSmem<kD>;
  constexpr int kN = hop::kDqKeys;
  constexpr int kStages = hop::kDqStages<kD>;
  constexpr int kTile = kN * kD * 2;
  constexpr int kRowTile = hop::kRows * kD * 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = sm90::align1024(smem_raw);
  Columns* bits = reinterpret_cast<Columns*>(sm + S::kBits);
  uint64_t* qfull = reinterpret_cast<uint64_t*>(sm + S::kBar);
  uint64_t* qempty = qfull + 2;
  uint64_t* full = qempty + 2;
  uint64_t* empty = full + kStages;

  const int qtiles = (seq + hop::kRows - 1) / hop::kRows;
  const int tiles = (seq + kN - 1) / kN;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      sm90::bar_init(qfull + s, 1);
      sm90::bar_init(qempty + s, 4 * hop::kConsumers);
    }
    for (int s = 0; s < kStages; ++s) {
      sm90::bar_init(full + s, 1);
      sm90::bar_init(empty + s, 4 * hop::kConsumers);
    }
    sm90::bar_fence_init();
  }
  __syncthreads();

  if (warp >= 4 * hop::kConsumers) {  // the producer warpgroup: one warp works
    sm90::reg_dealloc<sm90::kProducerRegs>();
    if (warp != 4 * hop::kConsumers) return;
    int stage = 0;
    unsigned phase = 0;
    int n = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x, ++n) {
      const sm90::Unit w(u, qtiles, heads);
      const int* mask_row = mask ? mask + (size_t)w.b * seq : nullptr;
      if (lane == 0) {
        unsigned char* slot = sm + (n & 1) * S::kSlot;
        sm90::bar_wait(qempty + (n & 1), ((n >> 1) & 1) ^ 1);
        sm90::bar_arrive_tx(qfull + (n & 1), 2 * kRowTile);
        L::template load<hop::kRows>(slot, &tq, qfull + (n & 1), w.head, w.tile * hop::kRows, w.b);
        L::template load<hop::kRows>(slot + kRowTile, &tdo, qfull + (n & 1), w.head, w.tile * hop::kRows, w.b);
      }
      auto read_mask = [&](int (&mk)[kN / 32], int i) {
#pragma unroll
        for (int c = 0; c < kN / 32; ++c) {
          const int col = i * kN + 32 * c + lane;
          mk[c] = col >= seq ? -1 : (mask_row == nullptr || mask_row[col] > 0) ? 1 : 0;
        }
      };
      int next[kN / 32];
      read_mask(next, 0);
      for (int j = 0; j < 2 * tiles; ++j) {  // pass 1, then pass 2
        const int i = j < tiles ? j : j - tiles;
        int mk[kN / 32];
#pragma unroll
        for (int c = 0; c < kN / 32; ++c) mk[c] = next[c];
        if (j + 1 < 2 * tiles) read_mask(next, (j + 1) % tiles);
        sm90::bar_wait(empty + stage, phase ^ 1);
        if (lane == 0) {
          sm90::bar_expect_tx(full + stage, 2 * kTile);
          L::template load<kN>(sm + S::kK + stage * kTile, &tk, full + stage, w.head, i * kN, w.b);
          L::template load<kN>(sm + S::kV + stage * kTile, &tv, full + stage, w.head, i * kN, w.b);
        }
        sm90::write_tile_bits<kN>(bits + 4 * stage, mk, lane);
        sm90::bar_arrive_warp(full + stage);  // the lanes' bits released with it
        hop::advance<kStages>(stage, phase);
      }
    }
    return;
  }

  sm90::reg_alloc<sm90::kConsumerRegs>();
  const int wg = threadIdx.x >> 7;
  const int t = lane & 3;
  const int r0 = 64 * wg + 16 * (warp & 3) + (lane >> 2);  // the thread's first query in the tile
  const uint32_t k_tiles = smem_addr(sm + S::kK);
  const uint32_t v_tiles = smem_addr(sm + S::kV);
  const float sl2e = scale * kLog2e;
  int stage = 0;
  unsigned phase = 0;
  if (wg == 1) sm90::turn_pass(wg);  // warpgroup 0 goes first
  int n = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x, ++n) {
    const sm90::Unit w(u, qtiles, heads);
    const int row0 = w.tile * hop::kRows + r0;  // the thread's two queries
    const int row1 = row0 + 8;
    const size_t stat = ((size_t)w.b * heads + w.head) * seq;
    // a padded row takes m = 0 and 1 / l = 0, so its probs are 0
    const float m0 = row0 < seq ? m_in[stat + row0] : 0.f;
    const float m1 = row1 < seq ? m_in[stat + row1] : 0.f;
    const float il0 = row0 < seq ? 1.f / l_in[stat + row0] : 0.f;
    const float il1 = row1 < seq ? 1.f / l_in[stat + row1] : 0.f;
    const unsigned salt = dropout_salt(dr.seed, w.b, w.head);
    const unsigned hrow0 = row_term((unsigned)row0, salt);
    const unsigned hrow1 = row_term((unsigned)row1, salt);
    // p as the forward forms it (tile_exp)
    const float ml0 = m0 * kLog2e, ml1 = m1 * kLog2e;
    const float mb0 = (kBigNeg - m0) * kLog2e, mb1 = (kBigNeg - m1) * kLog2e;
    const uint32_t q_rows = smem_addr(sm + (n & 1) * S::kSlot) + 64 * wg * L::kRowBytes;
    const uint32_t do_rows = q_rows + kRowTile;

    // probs (in place of S) and dp = (dO V^T) * keep of key tile i in
    // `stage`, and the column bits; the products and the exp in the
    // warpgroup's turn
    auto recompute = [&](float (&s)[kN / 8][4], float (&dp)[kN / 8][4], int i) {
      sm90::turn_wait(wg);
      sm90::wg_fence();
#pragma unroll
      for (int k = 0; k < kD / 16; ++k)
        sm90::Wgmma<kN>::ss(s, L::template kmajor<hop::kRows>(q_rows, k),
                            L::template kmajor<kN>(k_tiles + stage * kTile, k), k > 0);
#pragma unroll
      for (int k = 0; k < kD / 16; ++k)
        sm90::Wgmma<kN>::ss(dp, L::template kmajor<hop::kRows>(do_rows, k),
                            L::template kmajor<kN>(v_tiles + stage * kTile, k), k > 0);
      sm90::wg_commit();
      sm90::wg_wait<0>();
      sm90::fence_regs(s);
      sm90::fence_regs(dp);
      const Columns cols = sm90::read_tile_bits(bits + 4 * stage, lane);
      sm90::tile_exp<kN>(s, cols, sl2e, ml0, ml1, mb0, mb1);
      sm90::turn_pass(wg);
#pragma unroll
      for (int j = 0; j < kN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          s[j][e] *= il0;
          s[j][2 + e] *= il1;
          if (dr.on) {
            const int col = i * kN + 8 * j + 2 * t + e;
            dp[j][e] *= keep_scale_row(dr, hrow0, col);
            dp[j][2 + e] *= keep_scale_row(dr, hrow1, col);
          }
        }
      }
      return cols;
    };

    sm90::bar_wait(qfull + (n & 1), (n >> 1) & 1);

    // Pass 1: D = rowsum(dp * probs).
    float d0 = 0.f, d1 = 0.f;
    for (int i = 0; i < tiles; ++i) {
      sm90::bar_wait(full + stage, phase);
      float s[kN / 8][4], dp[kN / 8][4];
      recompute(s, dp, i);
      sm90::bar_arrive_warp(empty + stage);
#pragma unroll
      for (int j = 0; j < kN / 8; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          d0 = fmaf(dp[j][e], s[j][e], d0);
          d1 = fmaf(dp[j][2 + e], s[j][2 + e], d1);
        }
      }
      hop::advance<kStages>(stage, phase);
    }
    d0 = quad_sum(d0);
    d1 = quad_sum(d1);
    if (t == 0) {
      if (row0 < seq) d_out[stat + row0] = d0;
      if (row1 < seq) d_out[stat + row1] = d1;
    }

    // Pass 2: ds = probs * (dp - D) * scale, zero on masked columns,
    // rounded to bf16 as the A fragments of dQ += ds K.
    float acc[kD / 8][4];
    sm90::zero(acc);
    for (int i = 0; i < tiles; ++i) {
      sm90::bar_wait(full + stage, phase);
      float s[kN / 8][4], dp[kN / 8][4];
      const Columns cols = recompute(s, dp, i);
      if (i + 1 == tiles) sm90::bar_arrive_warp(qempty + (n & 1));  // Q and dO are read no more
      uint32_t dsa[kN / 16][4];
#pragma unroll
      for (int j = 0; j < kN / 8; ++j) {
        float ds[4];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool masked = (cols.masked >> (2 * j + e)) & 1u;
          ds[e] = masked ? 0.f : s[j][e] * (dp[j][e] - d0) * scale;
          ds[2 + e] = masked ? 0.f : s[j][2 + e] * (dp[j][2 + e] - d1) * scale;
        }
        dsa[j >> 1][(j & 1) * 2] = pack_bf16(ds[0], ds[1]);      // row g
        dsa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);  // row g + 8
      }
      sm90::fence_regs(dsa);
      sm90::fence_regs(acc);
      sm90::wg_fence();
#pragma unroll
      for (int k = 0; k < kN / 16; ++k)
        sm90::Wgmma<kD>::rs(acc, dsa[k], L::template mnmajor<kN>(k_tiles + stage * kTile, k), 1);
      sm90::wg_commit();
      sm90::wg_wait<0>();
      sm90::fence_regs(acc);
      sm90::bar_arrive_warp(empty + stage);
      hop::advance<kStages>(stage, phase);
    }
    store_frags<kD>(dq + (size_t)w.b * seq * hidden + (size_t)w.head * kD, acc, row0, 0, seq, hidden, kD, lane);
  }
  if (wg == 0) sm90::turn_wait(wg);  // warpgroup 1's last turn_pass
}

// Launch b, persistent over the units (batch row, head, 128-key tile):
// two consumer warpgroups of 64 keys, a producer warp. The producer loads
// each unit's K and V tiles by TMA into one of two slots, then the Q and
// dO tiles of every query tile through the ring, each with its queries'
// statistics (m log2 e, (-3e7 - m) log2 e, 1 / l and D from launch a; a
// query past T takes m = 0, 1 / l = 0, D = 0, so its probs are 0). Each
// warpgroup computes S^T = K Q^T and dP^T = V dO^T by wgmma from shared
// memory (in turn with the other), forms probs^T (as the forward forms
// p), the keep-mask of (query, key), pd^T and ds^T in registers, and adds
// dV += pd^T dO and dK += ds^T Q by wgmma with pd^T and ds^T as register A
// fragments and dO and Q read MN-major.
template <int kD, int kQ>
__global__ void __launch_bounds__(hop::kThreads, 1)
attention_bwd_dkdv_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                                const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
                                const int* __restrict__ mask, const float* __restrict__ m_in,
                                const float* __restrict__ l_in, const float* __restrict__ d_in,
                                mma::bf16* __restrict__ dk, mma::bf16* __restrict__ dv, int seq, int hidden,
                                int heads, float scale, Dropout dr, int units) {
  using namespace mma;
  using L = sm90::Layout<kD>;
  using S = hop::DkdvSmem<kD, kQ>;
  constexpr int kStages = hop::kDkdvStages<kD>;
  constexpr int kTile = kQ * kD * 2;
  constexpr int kRowTile = hop::kRows * kD * 2;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = sm90::align1024(smem_raw);
  float* st = reinterpret_cast<float*>(sm + S::kStat);
  uint64_t* kvfull = reinterpret_cast<uint64_t*>(sm + S::kBar);
  uint64_t* kvempty = kvfull + 2;
  uint64_t* full = kvempty + 2;
  uint64_t* empty = full + kStages;

  const int ktiles = (seq + hop::kRows - 1) / hop::kRows;
  const int tiles = (seq + kQ - 1) / kQ;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  if (threadIdx.x == 0) {
    for (int s = 0; s < 2; ++s) {
      sm90::bar_init(kvfull + s, 1);
      sm90::bar_init(kvempty + s, 4 * hop::kConsumers);
    }
    for (int s = 0; s < kStages; ++s) {
      sm90::bar_init(full + s, 1);
      sm90::bar_init(empty + s, 4 * hop::kConsumers);
    }
    sm90::bar_fence_init();
  }
  __syncthreads();

  if (warp >= 4 * hop::kConsumers) {  // the producer warpgroup: one warp works
    sm90::reg_dealloc<sm90::kProducerRegs>();
    if (warp != 4 * hop::kConsumers) return;
    int stage = 0;
    unsigned phase = 0;
    int n = 0;
    for (int u = blockIdx.x; u < units; u += gridDim.x, ++n) {
      const sm90::Unit w(u, ktiles, heads);
      const size_t stat = ((size_t)w.b * heads + w.head) * seq;
      if (lane == 0) {
        unsigned char* slot = sm + (n & 1) * S::kSlot;
        sm90::bar_wait(kvempty + (n & 1), ((n >> 1) & 1) ^ 1);
        sm90::bar_arrive_tx(kvfull + (n & 1), 2 * kRowTile);
        L::template load<hop::kRows>(slot, &tk, kvfull + (n & 1), w.head, w.tile * hop::kRows, w.b);
        L::template load<hop::kRows>(slot + kRowTile, &tv, kvfull + (n & 1), w.head, w.tile * hop::kRows, w.b);
      }
      // the statistics of query tile i's rows 32 c + lane, one tile ahead:
      // m, l and D, or 0, 0, 0 past T
      auto read_stats = [&](float (&m)[kQ / 32], float (&l)[kQ / 32], float (&d)[kQ / 32], int i) {
#pragma unroll
        for (int c = 0; c < kQ / 32; ++c) {
          const int row = i * kQ + 32 * c + lane;
          const bool in = row < seq;
          m[c] = in ? m_in[stat + row] : 0.f;
          l[c] = in ? l_in[stat + row] : 0.f;
          d[c] = in ? d_in[stat + row] : 0.f;
        }
      };
      float nm[kQ / 32], nl[kQ / 32], nd[kQ / 32];
      read_stats(nm, nl, nd, 0);
      for (int i = 0; i < tiles; ++i) {
        float m[kQ / 32], l[kQ / 32], d[kQ / 32];
#pragma unroll
        for (int c = 0; c < kQ / 32; ++c) {
          m[c] = nm[c];
          l[c] = nl[c];
          d[c] = nd[c];
        }
        if (i + 1 < tiles) read_stats(nm, nl, nd, i + 1);
        sm90::bar_wait(empty + stage, phase ^ 1);
        if (lane == 0) {  // the copies first
          sm90::bar_expect_tx(full + stage, 2 * kTile);
          L::template load<kQ>(sm + S::kQt + stage * kTile, &tq, full + stage, w.head, i * kQ, w.b);
          L::template load<kQ>(sm + S::kDo + stage * kTile, &tdo, full + stage, w.head, i * kQ, w.b);
        }
        float* sp = st + stage * 4 * kQ;
#pragma unroll
        for (int c = 0; c < kQ / 32; ++c) {
          const int r = 32 * c + lane;
          sp[r] = m[c] * kLog2e;
          sp[kQ + r] = (kBigNeg - m[c]) * kLog2e;
          sp[2 * kQ + r] = l[c] != 0.f ? 1.f / l[c] : 0.f;
          sp[3 * kQ + r] = d[c];
        }
        sm90::bar_arrive_warp(full + stage);  // the lanes' statistics released with it
        hop::advance<kStages>(stage, phase);
      }
    }
    return;
  }

  sm90::reg_alloc<sm90::kConsumerRegs>();
  const int wg = threadIdx.x >> 7;
  const int t = lane & 3;
  const int r0 = 64 * wg + 16 * (warp & 3) + (lane >> 2);  // the thread's first key in the tile
  const uint32_t q_tiles = smem_addr(sm + S::kQt);
  const uint32_t do_tiles = smem_addr(sm + S::kDo);
  const float sl2e = scale * kLog2e;
  int stage = 0;
  unsigned phase = 0;
  if (wg == 1) sm90::turn_pass(wg);  // warpgroup 0 goes first
  int n = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x, ++n) {
    const sm90::Unit w(u, ktiles, heads);
    const int key0 = w.tile * hop::kRows + r0;  // the thread's two keys
    const int key1 = key0 + 8;
    const bool masked0 = key0 < seq && mask != nullptr && mask[(size_t)w.b * seq + key0] <= 0;
    const bool masked1 = key1 < seq && mask != nullptr && mask[(size_t)w.b * seq + key1] <= 0;
    // the keep-mask hash of (query r, key c) is hash_finish(r * 0x9E3779B9 +
    // key_term(c)): the key's part summed once
    const unsigned salt = dropout_salt(dr.seed, w.b, w.head);
    const unsigned kterm0 = (unsigned)key0 * 0x85EBCA6Bu + salt * 0xC2B2AE35u;
    const unsigned kterm1 = (unsigned)key1 * 0x85EBCA6Bu + salt * 0xC2B2AE35u;
    const uint32_t k_rows = smem_addr(sm + (n & 1) * S::kSlot) + 64 * wg * L::kRowBytes;
    const uint32_t v_rows = k_rows + kRowTile;

    float acc_dk[kD / 8][4], acc_dv[kD / 8][4];
    sm90::zero(acc_dk);
    sm90::zero(acc_dv);
    sm90::bar_wait(kvfull + (n & 1), (n >> 1) & 1);
    for (int i = 0; i < tiles; ++i) {
      sm90::bar_wait(full + stage, phase);
      const uint32_t qt = q_tiles + stage * kTile;
      const uint32_t dot = do_tiles + stage * kTile;
      float s[kQ / 8][4], dp[kQ / 8][4];
      sm90::turn_wait(wg);
      sm90::wg_fence();
#pragma unroll
      for (int k = 0; k < kD / 16; ++k)  // S^T = K Q^T
        sm90::Wgmma<kQ>::ss(s, L::template kmajor<hop::kRows>(k_rows, k), L::template kmajor<kQ>(qt, k), k > 0);
#pragma unroll
      for (int k = 0; k < kD / 16; ++k)  // dP^T = V dO^T
        sm90::Wgmma<kQ>::ss(dp, L::template kmajor<hop::kRows>(v_rows, k), L::template kmajor<kQ>(dot, k),
                            k > 0);
      sm90::wg_commit();
      sm90::wg_wait<0>();
      sm90::fence_regs(s);
      sm90::fence_regs(dp);
      if (i + 1 == tiles) sm90::bar_arrive_warp(kvempty + (n & 1));  // K and V are read no more
      const float* sp = st + stage * 4 * kQ;
      const int q0 = i * kQ;
      uint32_t pda[kQ / 16][4], dsa[kQ / 16][4];
#pragma unroll
      for (int j = 0; j < kQ / 8; ++j) {
        float pd[4], ds[4];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = 8 * j + 2 * t + e;  // the query, in the tile
          const float ml = sp[c], mb = sp[kQ + c];
          const float ilq = sp[2 * kQ + c], dq_row = sp[3 * kQ + c];
          // p as the forward forms it (tile_exp), for key0 and key1
          const float p0 = ex2(masked0 ? mb : fmaf(s[j][e], sl2e, -ml)) * ilq;
          const float p1 = ex2(masked1 ? mb : fmaf(s[j][2 + e], sl2e, -ml)) * ilq;
          float keep0 = 1.f, keep1 = 1.f;
          if (dr.on) {
            const unsigned qterm = (unsigned)(q0 + c) * 0x9E3779B9u;
            keep0 = hash_finish(qterm + kterm0) >= dr.thresh ? dr.inv_keep : 0.f;
            keep1 = hash_finish(qterm + kterm1) >= dr.thresh ? dr.inv_keep : 0.f;
          }
          pd[e] = dr.on ? p0 * keep0 : p0;
          pd[2 + e] = dr.on ? p1 * keep1 : p1;
          const float dp0 = dr.on ? dp[j][e] * keep0 : dp[j][e];
          const float dp1 = dr.on ? dp[j][2 + e] * keep1 : dp[j][2 + e];
          ds[e] = masked0 ? 0.f : p0 * (dp0 - dq_row) * scale;
          ds[2 + e] = masked1 ? 0.f : p1 * (dp1 - dq_row) * scale;
        }
        pda[j >> 1][(j & 1) * 2] = pack_bf16(pd[0], pd[1]);      // key row g
        pda[j >> 1][(j & 1) * 2 + 1] = pack_bf16(pd[2], pd[3]);  // key row g + 8
        dsa[j >> 1][(j & 1) * 2] = pack_bf16(ds[0], ds[1]);
        dsa[j >> 1][(j & 1) * 2 + 1] = pack_bf16(ds[2], ds[3]);
      }
      sm90::turn_pass(wg);  // the turn: the products and the exp
      sm90::fence_regs(pda);
      sm90::fence_regs(dsa);
      sm90::fence_regs(acc_dv);
      sm90::fence_regs(acc_dk);
      sm90::wg_fence();
#pragma unroll
      for (int k = 0; k < kQ / 16; ++k)  // dV += pd^T dO
        sm90::Wgmma<kD>::rs(acc_dv, pda[k], L::template mnmajor<kQ>(dot, k), 1);
#pragma unroll
      for (int k = 0; k < kQ / 16; ++k)  // dK += ds^T Q
        sm90::Wgmma<kD>::rs(acc_dk, dsa[k], L::template mnmajor<kQ>(qt, k), 1);
      sm90::wg_commit();
      sm90::wg_wait<0>();
      sm90::fence_regs(acc_dv);
      sm90::fence_regs(acc_dk);
      sm90::bar_arrive_warp(empty + stage);
      hop::advance<kStages>(stage, phase);
    }
    const size_t base = (size_t)w.b * seq * hidden + (size_t)w.head * kD;
    store_frags<kD>(dv + base, acc_dv, key0, 0, seq, hidden, kD, lane);
    store_frags<kD>(dk + base, acc_dk, key0, 0, seq, hidden, kD, lane);
  }
  if (wg == 0) sm90::turn_wait(wg);  // warpgroup 1's last turn_pass
}

template <int kD>
int launch_wgmma(const void* q, const void* k, const void* v, const void* dout, const void* mask,
                 const void* m, const void* l, void* dq, void* dk, void* dv, void* dbuf, int batch, int seq,
                 int hidden, int heads, float scale, Dropout dr, cudaStream_t stream) {
  constexpr int kN = hop::kDqKeys;
  constexpr int kQ = hop::dkdv_queries<kD>();
  constexpr int kCB = sm90::Layout<kD>::kCB;
  // launch a reads Q and dO in tiles of the unit's rows and K, V in key
  // tiles; launch b the other way round
  CUtensorMap rows[4], tiles[4];
  const void* ptrs[4] = {q, k, v, dout};
  for (int i = 0; i < 4; ++i) {
    int err = sm90::encode_map(&rows[i], ptrs[i], batch, seq, hidden, kCB, hop::kRows);
    if (!err) err = sm90::encode_map(&tiles[i], ptrs[i], batch, seq, hidden, kCB, i == 1 || i == 2 ? kN : kQ);
    if (err) return err;
  }
  auto* dq_kernel = attention_bwd_dq_wgmma_kernel<kD>;
  auto* dkdv_kernel = attention_bwd_dkdv_wgmma_kernel<kD, kQ>;
  constexpr int smem_dq = hop::DqSmem<kD>::kBytes;
  constexpr int smem_dkdv = hop::DkdvSmem<kD, kQ>::kBytes;
  cudaError_t e = cudaFuncSetAttribute(dq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dq);
  if (e != cudaSuccess) return (int)e;
  e = cudaFuncSetAttribute(dkdv_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dkdv);
  if (e != cudaSuccess) return (int)e;
  const int* mt = static_cast<const int*>(mask);
  const float* mf = static_cast<const float*>(m);
  const float* lf = static_cast<const float*>(l);
  float* df = static_cast<float*>(dbuf);
  const int units = (seq + hop::kRows - 1) / hop::kRows * heads * batch;
  const int blocks = sm90::persistent_blocks(units);
  dq_kernel<<<blocks, hop::kThreads, smem_dq, stream>>>(rows[0], tiles[1], tiles[2], rows[3], mt, mf, lf,
                                                        static_cast<mma::bf16*>(dq), df, seq, hidden, heads,
                                                        scale, dr, units);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dkdv_kernel<<<blocks, hop::kThreads, smem_dkdv, stream>>>(tiles[0], rows[1], rows[2], tiles[3], mt, mf, lf, df,
                                                            static_cast<mma::bf16*>(dk),
                                                            static_cast<mma::bf16*>(dv), seq, hidden, heads,
                                                            scale, dr, units);
  return (int)cudaGetLastError();
}

// ------------------------------------- FMA units: f32, or bf16 with d > 256

template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const int* __restrict__ mask, const float* __restrict__ m_in,
                        const float* __restrict__ l_in, T* __restrict__ dq,
                        float* __restrict__ d_out, int seq, int hidden, int heads, int dim,
                        float scale, Dropout dr) {
  extern __shared__ float smem[];
  float* as_ = smem;                   // a 64 x 64 piece of Q or dO
  float* bs_ = as_ + kTile * kStride;  // a piece of K or V
  float* ps = bs_ + kTile * kStride;   // ds of a 64-key tile, [query][key]

  const int q0 = blockIdx.x * kTile;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const size_t base = (size_t)b * seq * hidden + (size_t)head * dim;
  const size_t stat = ((size_t)b * heads + head) * seq;
  const int* mrow = mask ? mask + (size_t)b * seq : nullptr;
  const unsigned salt = dropout_salt(dr.seed, b, head);

  const int row = threadIdx.x >> 1;
  const int half = threadIdx.x & 1;
  const int qrow = q0 + row;
  const float mx = qrow < seq ? m_in[stat + qrow] : 0.f;
  const float il = qrow < seq ? 1.f / l_in[stat + qrow] : 0.f;

  // probs (in place of the scores) and dp = (dO V^T) * keep of the key
  // tile at k0, for the thread's row and columns
  auto recompute = [&](float (&s)[kCols], float (&dp)[kCols], int k0) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) s[c] = dp[c] = 0.f;
    fma_nt(s, as_, bs_, q + base, q0, k + base, k0, seq, hidden, dim);
    fma_nt(dp, as_, bs_, dout + base, q0, v + base, k0, seq, hidden, dim);
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = k0 + 2 * c + half;
      if (col < seq) {
        s[c] = expf(masked_score(s[c], scale, mrow, col) - mx) * il;
        if (dr.on) dp[c] *= keep_scale(dr, salt, qrow, col);
      } else {
        s[c] = dp[c] = 0.f;
      }
    }
  };

  // Pass 1: D = rowsum(dp * probs).
  float dsum = 0.f;
  for (int k0 = 0; k0 < seq; k0 += kTile) {
    float s[kCols], dp[kCols];
    recompute(s, dp, k0);
#pragma unroll
    for (int c = 0; c < kCols; ++c) dsum = fmaf(dp[c], s[c], dsum);
  }
  dsum += __shfl_xor_sync(0xffffffffu, dsum, 1);  // the row's two threads
  if (half == 0 && qrow < seq) d_out[stat + qrow] = dsum;

  // Pass 2, for each 64-wide piece of the head dims: ds = probs * (dp - D)
  // * scale, zero on masked key columns, rounded to q's dtype; dQ = ds K.
  for (int c0 = 0; c0 < dim; c0 += kTile) {
    float acc[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[c] = 0.f;
    for (int k0 = 0; k0 < seq; k0 += kTile) {
      float s[kCols], dp[kCols];
      recompute(s, dp, k0);
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int col = k0 + 2 * c + half;
        float ds = s[c] * (dp[c] - dsum);
        if (col >= seq || (mrow != nullptr && mrow[col] <= 0)) ds = 0.f;
        ps[row * kStride + 2 * c + half] = round_as(ds * scale, T());
      }
      fma_nn(acc, ps, bs_, k + base, k0, c0, seq, hidden, dim);
    }
    if (qrow < seq) store_piece(dq + base + (size_t)qrow * hidden, acc, c0, dim, 1.f);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const T* __restrict__ dout,
                          const int* __restrict__ mask, const float* __restrict__ m_in,
                          const float* __restrict__ l_in, const float* __restrict__ d_in,
                          T* __restrict__ dk, T* __restrict__ dv, int seq, int hidden,
                          int heads, int dim, float scale, Dropout dr) {
  extern __shared__ float smem[];
  float* as_ = smem;                    // a 64 x 64 piece of K or V (the block's keys)
  float* bs_ = as_ + kTile * kStride;   // a piece of Q or dO
  float* pt = bs_ + kTile * kStride;    // pd, [key][query]
  float* dst = pt + kTile * kStride;    // ds, [key][query]
  float* ms = dst + kTile * kStride;    // kTile: m of each query
  float* ils = ms + kTile;              // kTile: 1 / l of each query
  float* ds_row = ils + kTile;          // kTile: D of each query

  const int k0 = blockIdx.x * kTile;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const size_t base = (size_t)b * seq * hidden + (size_t)head * dim;
  const size_t stat = ((size_t)b * heads + head) * seq;
  const unsigned salt = dropout_salt(dr.seed, b, head);

  const int tid = threadIdx.x;
  const int row = tid >> 1;  // key row of the block this thread owns
  const int half = tid & 1;  // query columns / head dims 2c + half
  const int key = k0 + row;
  const bool key_in = key < seq;
  const bool key_masked = key_in && mask != nullptr && mask[(size_t)b * seq + key] <= 0;

  for (int c0 = 0; c0 < dim; c0 += kTile) {
    float dk_acc[kCols], dv_acc[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) dk_acc[c] = dv_acc[c] = 0.f;

    for (int q0 = 0; q0 < seq; q0 += kTile) {
      __syncthreads();  // the statistics of the last query tile are read no more
      for (int r = tid; r < kTile; r += kThreads) {
        const bool in = q0 + r < seq;
        ms[r] = in ? m_in[stat + q0 + r] : 0.f;
        ils[r] = in ? 1.f / l_in[stat + q0 + r] : 0.f;
        ds_row[r] = in ? d_in[stat + q0 + r] : 0.f;
      }
      float s[kCols], dp[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) s[c] = dp[c] = 0.f;
      fma_nt(s, as_, bs_, k + base, k0, q + base, q0, seq, hidden, dim);       // S^T
      fma_nt(dp, as_, bs_, v + base, k0, dout + base, q0, seq, hidden, dim);   // dP^T
      // probs, pd and ds for (key row, query 2c + half)
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int i = 2 * c + half;
        const int qi = q0 + i;
        float pd = 0.f, ds = 0.f;
        if (key_in && qi < seq) {
          const float sc = key_masked ? kBigNeg : s[c] * scale;
          const float probs = expf(sc - ms[i]) * ils[i];
          float dpk = dp[c];
          pd = probs;
          if (dr.on) {
            const float kscale = keep_scale(dr, salt, qi, key);
            pd = probs * kscale;
            dpk *= kscale;
          }
          ds = key_masked ? 0.f : probs * (dpk - ds_row[i]);
        }
        pt[row * kStride + i] = round_as(pd, T());
        dst[row * kStride + i] = round_as(ds * scale, T());
      }
      // dV += pd^T dO and dK += ds^T Q over the query tile's 64-wide piece
      // c0 of the head dims
      fma_nn(dv_acc, pt, bs_, dout + base, q0, c0, seq, hidden, dim);
      fma_nn(dk_acc, dst, bs_, q + base, q0, c0, seq, hidden, dim);
    }
    if (key_in) {
      store_piece(dk + base + (size_t)key * hidden, dk_acc, c0, dim, 1.f);
      store_piece(dv + base + (size_t)key * hidden, dv_acc, c0, dim, 1.f);
    }
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* dout, const void* mask,
           const void* m, const void* l, void* dq, void* dk, void* dv, void* dbuf, int batch,
           int seq, int hidden, int heads, int dim, float scale, Dropout dr,
           cudaStream_t stream) {
  const size_t smem_dq = sizeof(float) * 3 * kTile * kStride;
  const size_t smem_dkdv = sizeof(float) * (4 * kTile * kStride + 3 * kTile);
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
      qt, kt, vt, dot, mt, mf, lf, static_cast<T*>(dq), df, seq, hidden, heads, dim, scale, dr);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  attention_bwd_dkdv_kernel<T><<<grid, kThreads, smem_dkdv, stream>>>(
      qt, kt, vt, dot, mt, mf, lf, df, static_cast<T*>(dk), static_cast<T*>(dv), seq, hidden,
      heads, dim, scale, dr);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point. dtype: 0 = float32, 1 = bfloat16 (q, k, v, dout and the
// three gradients), head dim d = hidden / heads. route: 0 = FMA units
// (either dtype, any d % 8 == 0, any T), 1 = tensor cores by mma.sync
// (bfloat16, d <= 256, tensors 16-byte aligned): the whole-head kernel for
// d = 64 and T <= 128, else the tiled pair; 2 = tensor cores by wgmma on
// TMA-fed tiles (bfloat16, d = 32, 64 or 128, any T, tensors 16-byte
// aligned), a pair. dbuf is (B, heads, T) f32 scratch for the
// row term D, written by the first launch of a pair and read by the second
// (the whole-head kernel does not read it). mask is (B, T) int32 with 1 =
// keep, or null; m and l are the forward's (B, heads, T) f32 statistics;
// scale is 1 / sqrt(d). The dropout arguments are the forward's. Shapes
// are checked by the Python wrapper. Returns the CUDA error code of the
// launches (0 on success).
extern "C" int attention_bwd(const void* q, const void* k, const void* v, const void* dout,
                             const void* mask, const void* m, const void* l, void* dq,
                             void* dk, void* dv, void* dbuf, int batch, int seq, int hidden,
                             int heads, int dtype, int route, float scale, int dropout,
                             int seed, unsigned thresh, float inv_keep, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dropout dr{dropout, seed, thresh, inv_keep};
  if (heads <= 0 || hidden % heads || (hidden / heads) % 8 || seq <= 0) return (int)cudaErrorInvalidValue;
  const int dim = hidden / heads;
  if (route == 2) {
    if (dtype != 1 || dbuf == nullptr) return (int)cudaErrorInvalidValue;
    if (dim == 32)
      return launch_wgmma<32>(q, k, v, dout, mask, m, l, dq, dk, dv, dbuf, batch, seq, hidden, heads, scale,
                              dr, st);
    if (dim == 64)
      return launch_wgmma<64>(q, k, v, dout, mask, m, l, dq, dk, dv, dbuf, batch, seq, hidden, heads, scale,
                              dr, st);
    if (dim == 128)
      return launch_wgmma<128>(q, k, v, dout, mask, m, l, dq, dk, dv, dbuf, batch, seq, hidden, heads, scale,
                               dr, st);
    return (int)cudaErrorInvalidValue;
  }
  if (route == 1) {
    if (dtype != 1 || dim > 256) return (int)cudaErrorInvalidValue;
    if (dim == mma::kHeadDim && seq <= mma::kMaxSeq)
      return launch_mma(q, k, v, dout, mask, m, l, dq, dk, dv, batch, seq, hidden, heads, scale,
                        dr, st);
    if (dbuf == nullptr) return (int)cudaErrorInvalidValue;
    if (dim <= 32)
      return launch_tiled<32>(q, k, v, dout, mask, m, l, dq, dk, dv, dbuf, batch, seq, hidden,
                              heads, dim, scale, dr, st);
    if (dim <= 64)
      return launch_tiled<64>(q, k, v, dout, mask, m, l, dq, dk, dv, dbuf, batch, seq, hidden,
                              heads, dim, scale, dr, st);
    if (dim <= 128)
      return launch_tiled<128>(q, k, v, dout, mask, m, l, dq, dk, dv, dbuf, batch, seq, hidden,
                               heads, dim, scale, dr, st);
    return launch_tiled<256>(q, k, v, dout, mask, m, l, dq, dk, dv, dbuf, batch, seq, hidden,
                             heads, dim, scale, dr, st);
  }
  if (dbuf == nullptr) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch<float>(q, k, v, dout, mask, m, l, dq, dk, dv, dbuf, batch, seq, hidden,
                         heads, dim, scale, dr, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, dout, mask, m, l, dq, dk, dv, dbuf, batch, seq,
                                 hidden, heads, dim, scale, dr, st);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of one block of the whole-head tensor-core kernel,
// bytes.
extern "C" int attention_bwd_mma_smem(void) { return (int)kMmaSmem; }
