// Fused multi-head self-attention forward for Hopper (sm_90a).
//
// Replaces imagegenerator_tpu/ops/pallas/attention.py::_pallas_fwd
// (kernel body _fwd_kernel): per (batch row, head) it computes
//   S = scale * Q K^T, key-padding mask filled with -3e7 (not -inf),
//   m = rowmax(S), p = exp(S - m), l = rowsum(p),
//   p *= keep / (1 - rate)          (attention-prob dropout, rate > 0),
//   O = (p V) / l,
// with scale = 1 / sqrt(d) of the actual head dim d (passed by the
// wrapper), and writes O in the input dtype plus m and l in f32, kept
// apart (not as a log-sum-exp) so the backward recomputes p with no
// reductions. l sums p before dropout, as on the TPU. A fully masked row
// comes out uniform. The keep-mask is the counter hash of
// attention_common.cuh, addressed by (seed, batch row, head, query, key),
// so the backward replays it.
//
// Operands stay in the packed-head layout of the BERT Dense outputs:
// q, k, v are (B, T, H) with H = heads * d, head h in columns
// [d h, d h + d), d any multiple of 8. No transpose is made before or
// after the kernel.
//
// What bounds it: bytes up to T of a few hundred, operations beyond. At
// (256, 128, 768) q, k, v, o cross device memory once (201 MB, 0.06 ms at
// 3.35 TB/s) against 13 GFLOP of products; the work per head grows as T^2
// and passes the bytes near T = 512. The (T, T) scores never leave the SM.
//
// Four kernels, chosen from (dtype, d, T); the wrapper's rule names the
// route (kernel_route: "wgmma", "mma" or "fma") and the C entry point
// takes it as its route argument:
//
// 1. Tensor cores, whole head: bf16, d = 64, T <= 128
//    (attention_fwd_mma_kernel). One block of 4 warps per (batch row,
//    head, 64-query tile). The Q tile and the whole head's K and V stay
//    bf16 in shared memory (45 KB), copied 16 bytes a thread with cp.async
//    into rows padded to 144 bytes, which ldmatrix reads without bank
//    conflicts; there is no key-tile loop. Each warp owns 16 queries. Its
//    scores are the 16 x 128 f32 accumulators of mma.sync m16n8k16 (64
//    registers a thread); the row max and sum are two shuffles over the
//    four lanes of a row; the mask fill, expf, the dropout hash (addressed
//    by the accumulator's own (query, key)) and the rounding to bf16
//    happen in registers, and the rounded p is repacked as the A fragments
//    of P V. V is read through ldmatrix.trans. A padded key column (past
//    T) scores -inf and adds exactly 0 to l; a masked one scores -3e7. The
//    result leaves through the warp's own rows of the Q tile as 16-byte
//    stores.
//
// 2. Tensor cores, Hopper: bf16, d = 32, 64 or 128 at every T outside
//    kernel 1's domain (attention_fwd_wgmma_kernel<d, slabs>, the "wgmma"
//    route; machinery in attention_sm90.cuh). Persistent: one block a SM
//    walks units of 128 queries (256 where d <= 64 and T > 128: two slabs
//    of 64 rows for each consumer warpgroup), a producer warp keeping K
//    and V tiles in flight by TMA through a ring of mbarriers and two
//    consumer warpgroups running wgmma: S = Q K^T with both operands in
//    shared memory (the tensor map's 64- or 128-byte swizzle), P V with P
//    from registers and V read MN-major. The same two passes as kernel 3,
//    the same p (tile_exp), the same keep bits (each accumulator's own
//    (query, key): warp w of a warpgroup holds rows 16 w .. 16 w + 15 of
//    an m64 product, laid out as mma.sync's C tiles). What bounds it: its
//    load pipeline (at (256, 512, 768) the TMA loads and barriers alone,
//    every product and exp taken out, take 0.63 of its 0.91 ms with an
//    all-kept mask on an NVIDIA H100 80GB HBM3 at 700 W:
//    tools/probe_torch_attention.py --ablate; fewer bytes a query, two
//    slabs, helped a little, K kept in the ring between the passes not at
//    all, so that floor is not L2's bandwidth alone), then the exp on the
//    special-function unit, which the two warpgroups take in turns with
//    their score products, and with a ragged mask the per-key selects of
//    the masked path. At seq_len 512 it is slower than
//    F.scaled_dot_product_attention (PERF.md): a one-pass online softmax
//    would read K once, but would round p against a running max, which
//    the JAX kernel does not. Issuing the next tile's scores before this
//    tile's exp (FA3's intra-warpgroup overlap) needs a second set of
//    score registers; tried, it spilled and ptxas serialized the
//    products, and was slower.
//
// 3. Tensor cores, tiled: bf16, 8 <= d <= 256 off kernel 2's head dims
//    (attention_fwd_tiled_kernel<kDim, kKeys, kWarps>, kDim the head dim
//    rounded up to 32, 64, 128 or 256). One block of kWarps warps (8 up to
//    kDim 64, else 4), 16 queries each, per (batch row, head, query tile),
//    walking the keys in tiles of kKeys (64; 32 at kDim 256, to keep the
//    16 x 256 output accumulators and the scores in registers) through a
//    two-stage cp.async ring. Past one tile of keys no warp can hold a
//    row's scores, and the JAX rounding needs p formed against the final
//    row max, so it makes two passes over the key tiles (design (b)): the
//    first finds m (exactly: the max of the scaled, masked scores), the
//    second recomputes S (the same mma.sync sequence, so the same bits),
//    forms p against that m, sums l from it, drops, rounds p to bf16 and
//    accumulates P V. One departure from expf: p is 2^(s scale log2 e -
//    m log2 e), one FMA and one ex2.approx (tile_exp), within about 1e-6
//    relative of exp(scale s - m) for scaled scores in the tens (the
//    rounding of scale log2 e grows with the score); the backward forms p
//    the same way. The contraction over d is zero-padded to a multiple of 16 in
//    shared memory, which is exact. The mask comes into shared memory
//    beside each key tile as a kind per key; a thread whose columns of a
//    tile hold no masked or padded key skips the fill. O leaves from the
//    accumulators, two values a lane. What bounds it: three products a
//    head in place of the function's two (Q K^T twice, P V), and with 16
//    rows a warp each product waits on ldmatrix and on the one before it;
//    at (256, 512, 768) it runs at about 14% of the bf16 peak (PERF.md).
//
// 4. FMA units: f32 inputs (tensor cores would mean TF32), or bf16 with
//    d > 256 (attention_fwd_kernel). 128 threads per (batch row, head,
//    64-query tile); Q, K, V and p are 64 x 64 f32 pieces in shared memory
//    with an odd row stride (65), one shared-memory load per FMA, any T
//    and any d in 50 KB. The same two passes: the first finds m, the
//    second recomputes the scores for each 64-wide piece of the output's
//    head dims, forms p, l and the dropout, and accumulates p V.
//
// Rounding follows the TPU kernel on every route: products accumulate in
// f32, l sums the unrounded p, and p (after dropout) is rounded to the
// dtype of v before p V; O is (p V) / l. All use expf, as the backward
// does.

#include "attention_common.cuh"
#include "attention_mma.cuh"
#include "attention_sm90.cuh"

namespace {

using namespace attn;

// ------------------------------- tensor cores, whole head: d = 64, T <= 128

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
  fill_tile_kinds<kMaxSeq>(kind, mask ? mask + (size_t)b * seq : nullptr, 0, seq);
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
  tile_nt<kHeadDim, kMaxSeq>(s, qs, r0, ks, kHeadDim / 16, seq, lane);

  // scale, mask fill, row max
  const Columns cols = read_tile_kinds<kMaxSeq>(kind, lane);
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
  tile_nn<kHeadDim, kMaxSeq, kHeadDim>(acc, p, vs, 0, kHeadDim / 16, seq, lane);
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

// ---------------------------------------- tensor cores, tiled: d <= 256

// Key tile and warps a block, picked by timing on an H100 at (256, 512,
// 768): up to head dim 64, 8 warps (128 queries) halve the K and V traffic
// into shared memory; past it the accumulators' registers leave room for
// fewer blocks of 8, and 4 warps are faster. 32 or 128 keys a tile were
// slower than 64.
template <int kDim>
constexpr int fwd_keys() { return kDim >= 256 ? 32 : 64; }
template <int kDim>
constexpr int fwd_warps() { return kDim <= 64 ? 8 : 4; }

template <int kDim, int kKeys, int kWarps>
constexpr size_t fwd_tiled_smem() {
  return sizeof(mma::bf16) * (16 * kWarps + 4 * kKeys) * mma::Tiled<kDim>::kRowT +
         sizeof(int) * 2 * kKeys;
}

template <int kDim, int kKeys, int kWarps>
__global__ void __launch_bounds__(32 * kWarps)
attention_fwd_tiled_kernel(const mma::bf16* __restrict__ q, const mma::bf16* __restrict__ k,
                           const mma::bf16* __restrict__ v, const int* __restrict__ mask,
                           mma::bf16* __restrict__ o, float* __restrict__ m_out,
                           float* __restrict__ l_out, int seq, int hidden, int heads, int dim,
                           float scale, Dropout dr) {
  using namespace mma;
  constexpr int kRowT = Tiled<kDim>::kRowT;
  constexpr int kTileElems = kKeys * kRowT;
  constexpr int kTiledQueries = 16 * kWarps;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);        // kTiledQueries x kRowT
  bf16* ks = qs + kTiledQueries * kRowT;                // 2 stages of kKeys x kRowT
  bf16* vs = ks + 2 * kTileElems;                       // 2 stages of kKeys x kRowT
  int* kind = reinterpret_cast<int*>(vs + 2 * kTileElems);  // 2 stages of kKeys

  const int q0 = blockIdx.x * kTiledQueries;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const size_t base = (size_t)b * seq * hidden + (size_t)head * dim;
  const int* mask_row = mask ? mask + (size_t)b * seq : nullptr;
  const int nk = (dim + 15) >> 4;
  const int tiles = (seq + kKeys - 1) / kKeys;

  const int lane = threadIdx.x & 31;
  const int r0 = (threadIdx.x >> 5) * 16;  // the warp's rows of the Q tile
  const bool active = q0 + r0 < seq;       // the same for the whole warp
  const int t = lane & 3;
  const int row0 = q0 + r0 + (lane >> 2);  // the thread's two queries
  const int row1 = row0 + 8;

  // key tile i (and with with_v its V tile) into stage i % 2, one group
  auto stage = [&](int i, bool with_v) {
    const int k0 = i * kKeys;
    load_rows_async<kDim, kKeys>(ks + (i & 1) * kTileElems, k + base, k0, seq, hidden, dim);
    if (with_v) load_rows_async<kDim, kKeys>(vs + (i & 1) * kTileElems, v + base, k0, seq, hidden, dim);
    fill_tile_kinds<kKeys>(kind + (i & 1) * kKeys, mask_row, k0, seq);
    cp_async_commit();
  };
  // wait for tile i, after starting tile i + 1 where there is one
  auto next = [&](int i, bool with_v) {
    if (i + 1 < tiles) {
      stage(i + 1, with_v);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
  };
  // the raw scores q . k of key tile i, and its column kinds
  auto scores = [&](float (&s)[kKeys / 8][4], int i) {
#pragma unroll
    for (int j = 0; j < kKeys / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
    tile_nt<kDim, kKeys>(s, qs, r0, ks + (i & 1) * kTileElems, nk, seq - i * kKeys, lane);
    return read_tile_kinds<kKeys>(kind + (i & 1) * kKeys, lane);
  };

  load_rows_async<kDim, kTiledQueries>(qs, q + base, q0, seq, hidden, dim);
  stage(0, false);  // one group with the Q tile

  // Pass 1: m = rowmax(S).
  float m0 = -INFINITY, m1 = -INFINITY;
  for (int i = 0; i < tiles; ++i) {
    next(i, false);
    if (active) {
      float s[kKeys / 8][4];
      const Columns cols = scores(s, i);
      tile_row_max<kKeys>(s, cols, scale, m0, m1);
    }
    __syncthreads();  // the stage is free for the next tile but one
  }
  m0 = quad_max(m0);
  m1 = quad_max(m1);

  // Pass 2: p = exp(S - m) against the final m, l = rowsum(p) before
  // dropout and rounding, then the keep-mask, p rounded to bf16 as the A
  // fragments of P V.
  const unsigned salt = dropout_salt(dr.seed, b, head);
  const unsigned hrow0 = row_term((unsigned)row0, salt);
  const unsigned hrow1 = row_term((unsigned)row1, salt);
  const float sl2e = scale * kLog2e;
  const float ml0 = m0 * kLog2e, ml1 = m1 * kLog2e;
  const float mb0 = (kBigNeg - m0) * kLog2e, mb1 = (kBigNeg - m1) * kLog2e;
  float l0 = 0.f, l1 = 0.f;
  float acc[kDim / 8][4];
#pragma unroll
  for (int n = 0; n < kDim / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
  stage(0, true);
  for (int i = 0; i < tiles; ++i) {
    next(i, true);
    if (active) {
      float s[kKeys / 8][4];
      tile_exp<kKeys>(s, scores(s, i), sl2e, ml0, ml1, mb0, mb1);
      uint32_t p[kKeys / 16][4];
#pragma unroll
      for (int j = 0; j < kKeys / 8; ++j) {
        float pr[4];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = i * kKeys + 8 * j + 2 * t + e;
          float p0 = s[j][e];
          float p1 = s[j][2 + e];
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
      tile_nn<kDim, kKeys, kDim>(acc, p, vs + (i & 1) * kTileElems, 0, nk, seq - i * kKeys, lane);
    }
    __syncthreads();
  }
  l0 = quad_sum(l0);
  l1 = quad_sum(l1);
  if (!active) return;

  // O = (P V) / l
#pragma unroll
  for (int n = 0; n < kDim / 8; ++n) {
    acc[n][0] /= l0;
    acc[n][1] /= l0;
    acc[n][2] /= l1;
    acc[n][3] /= l1;
  }
  store_frags<kDim>(o + base, acc, row0, 0, seq, hidden, dim, lane);
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

template <int kDim>
int launch_tiled(const void* q, const void* k, const void* v, const void* mask, void* o, void* m,
                 void* l, int batch, int seq, int hidden, int heads, int dim, float scale,
                 Dropout dr, cudaStream_t stream) {
  constexpr int kKeys = fwd_keys<kDim>();
  constexpr int kWarps = fwd_warps<kDim>();
  constexpr size_t smem = fwd_tiled_smem<kDim, kKeys, kWarps>();
  auto* kernel = attention_fwd_tiled_kernel<kDim, kKeys, kWarps>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((seq + 16 * kWarps - 1) / (16 * kWarps), heads, batch);
  kernel<<<grid, 32 * kWarps, smem, stream>>>(
      static_cast<const mma::bf16*>(q), static_cast<const mma::bf16*>(k),
      static_cast<const mma::bf16*>(v), static_cast<const int*>(mask),
      static_cast<mma::bf16*>(o), static_cast<float*>(m), static_cast<float*>(l), seq, hidden,
      heads, dim, scale, dr);
  return (int)cudaGetLastError();
}

// -------------------------------- tensor cores, Hopper: d = 32, 64, 128

namespace hop {

constexpr int kConsumers = 2;                      // consumer warpgroups
constexpr int kThreads = 128 * (kConsumers + 1);  // and a producer warpgroup

// A unit is kSlabs x 64 queries for each consumer warpgroup: 2 slabs (256
// queries a unit) where the head dim leaves the registers for them and T
// is past one unit of 128, else 1, so that every K and V tile loaded
// serves twice the queries (a few percent faster at seq_len 512). Key
// tiles: 128 keys with one slab, 64 with two (the registers of the slabs'
// scores), in a ring of as many stages as shared memory holds beside two
// Q tiles, up to 6. (Keeping a head's K and V in the ring from pass 1 to
// pass 2 where they fit, so that K is loaded once, measured no faster.)
template <int kD>
constexpr int slabs(int seq) { return kD <= 64 && seq > 64 * kConsumers ? 2 : 1; }
template <int kSlabs>
constexpr int kKeysOf = kSlabs == 2 ? 64 : 128;
template <int kD, int kSlabs>
constexpr int kStagesOf = kD >= 128 ? 2 : 6;

// Shared memory, byte offsets from a 1024-byte boundary: two Q tiles
// (this unit's and the next one's), the K and V tiles of each stage, each
// stage's column bits, the barriers (Q full and empty, two each; the
// stages' full and empty).
template <int kD, int kSlabs, int kN = kKeysOf<kSlabs>, int kStages = kStagesOf<kD, kSlabs>>
struct Smem {
  static constexpr int kRows = 64 * kConsumers * kSlabs;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + 2 * kRows * kD * 2;
  static constexpr int kV = kK + kStages * kN * kD * 2;
  static constexpr int kBits = kV + kStages * kN * kD * 2;
  static constexpr int kBar = kBits + kStages * 4 * 8;
  static constexpr int kBytes = kBar + 8 * (4 + 2 * kStages) + 1024;  // and the alignment's slack
};

template <int kStages>
__device__ __forceinline__ void advance(int& stage, unsigned& phase) {
  if (++stage == kStages) {
    stage = 0;
    phase ^= 1;
  }
}

}  // namespace hop

// Persistent: one block a SM walks the units (batch row, head, tile of
// kRows queries) u = blockIdx.x, + gridDim.x, ... Warpgroups 0 and 1
// consume, kSlabs x 64 queries each; one warp of warpgroup 2 produces,
// with its registers handed to the consumers (setmaxnreg). The producer
// loads each unit's Q tile by TMA into one of two slots (the next unit's
// loads while this one runs), then walks the unit's key tiles twice
// through a ring of full / empty mbarriers: K alone in pass 1, K and V in
// pass 2, each tile with its keys' column bits (masked, past T) built
// from the mask read one tile ahead. Each consumer warpgroup runs S = Q
// K^T for each slab as d / 16 wgmma m64nNk16 from shared memory; the two
// warpgroups take turns (named barriers): in pass 1 a turn is the score
// products, in pass 2 the products and the exp, so that one warpgroup's
// exp (the special-function unit) runs under the other's P V. Pass 1
// folds the row max; pass 2 forms p against the final m (tile_exp), sums
// l, applies the keep-mask hash of each accumulator's own (query, key),
// rounds p to bf16 as register A fragments and adds P V by wgmma with V
// read MN-major. O = (P V) / l leaves from the accumulators, m and l
// beside it.
template <int kD, int kSlabs>
__global__ void __launch_bounds__(hop::kThreads, 1)
attention_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv, const int* __restrict__ mask,
                           mma::bf16* __restrict__ o, float* __restrict__ m_out,
                           float* __restrict__ l_out, int seq, int hidden, int heads, float scale,
                           Dropout dr, int units) {
  using namespace mma;
  using L = sm90::Layout<kD>;
  using S = hop::Smem<kD, kSlabs>;
  constexpr int kN = hop::kKeysOf<kSlabs>;
  constexpr int kStages = hop::kStagesOf<kD, kSlabs>;
  constexpr int kRows = S::kRows;
  constexpr int kTile = kN * kD * 2;      // bytes of a K or V tile
  constexpr int kQTile = kRows * kD * 2;  // bytes of a Q tile
  extern __shared__ unsigned char smem_raw[];
  unsigned char* sm = sm90::align1024(smem_raw);
  Columns* bits = reinterpret_cast<Columns*>(sm + S::kBits);
  uint64_t* qfull = reinterpret_cast<uint64_t*>(sm + S::kBar);
  uint64_t* qempty = qfull + 2;
  uint64_t* full = qempty + 2;
  uint64_t* empty = full + kStages;

  const int qtiles = (seq + kRows - 1) / kRows;
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
        sm90::bar_wait(qempty + (n & 1), ((n >> 1) & 1) ^ 1);
        sm90::bar_arrive_tx(qfull + (n & 1), kQTile);
        L::template load<kRows>(sm + S::kQ + (n & 1) * kQTile, &tq, qfull + (n & 1), w.head, w.tile * kRows,
                                w.b);
      }
      // the kinds of key tile i's keys 32 c + lane: 1 kept, 0 masked, -1
      // past T
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
        const bool with_v = j >= tiles;
        int mk[kN / 32];
#pragma unroll
        for (int c = 0; c < kN / 32; ++c) mk[c] = next[c];
        if (j + 1 < 2 * tiles) read_mask(next, (j + 1) % tiles);
        sm90::bar_wait(empty + stage, phase ^ 1);
        if (lane == 0) {  // the copies first; the bits' ballots overlap them
          sm90::bar_expect_tx(full + stage, (with_v ? 2 : 1) * kTile);
          L::template load<kN>(sm + S::kK + stage * kTile, &tk, full + stage, w.head, i * kN, w.b);
          if (with_v) L::template load<kN>(sm + S::kV + stage * kTile, &tv, full + stage, w.head, i * kN, w.b);
        }
        sm90::write_tile_bits<kN>(bits + 4 * stage, mk, lane);
        sm90::bar_arrive_warp(full + stage);  // the lanes' bits released with it
        hop::advance<kStages>(stage, phase);
      }
    }
    return;
  }

  sm90::reg_alloc<sm90::kConsumerRegs>();
  // a consumer warpgroup: queries 64 (kSlabs wg + sl) + [0, 64) of the
  // unit's tile for its slabs sl, warp w of each 16
  const int wg = threadIdx.x >> 7;
  const int t = lane & 3;
  const int r0 = 64 * kSlabs * wg + 16 * (warp & 3) + (lane >> 2);  // the thread's first query, slab 0
  const uint32_t k_tiles = smem_addr(sm + S::kK);
  const uint32_t v_tiles = smem_addr(sm + S::kV);
  const float sl2e = scale * kLog2e;
  int stage = 0;
  unsigned phase = 0;
  if (wg == 1) sm90::turn_pass(wg);  // warpgroup 0 goes first
  int n = 0;
  for (int u = blockIdx.x; u < units; u += gridDim.x, ++n) {
    const sm90::Unit w(u, qtiles, heads);
    const int row0 = w.tile * kRows + r0;  // the thread's queries: row0 + 64 sl and + 8
    const uint32_t q_rows = smem_addr(sm + S::kQ + (n & 1) * kQTile) + 64 * kSlabs * wg * L::kRowBytes;

    // the raw scores q . k of the key tile in `stage` for each slab, in
    // the warpgroup's turn (which the caller passes on)
    auto scores = [&](float (&s)[kSlabs][kN / 8][4]) {
      sm90::turn_wait(wg);
      sm90::wg_fence();
#pragma unroll
      for (int sl = 0; sl < kSlabs; ++sl)
#pragma unroll
        for (int k = 0; k < kD / 16; ++k)
          sm90::Wgmma<kN>::ss(s[sl], L::template kmajor<kRows>(q_rows + 64 * sl * L::kRowBytes, k),
                              L::template kmajor<kN>(k_tiles + stage * kTile, k), k > 0);
      sm90::wg_commit();
      sm90::wg_wait<0>();
#pragma unroll
      for (int sl = 0; sl < kSlabs; ++sl) sm90::fence_regs(s[sl]);
    };

    sm90::bar_wait(qfull + (n & 1), (n >> 1) & 1);

    // Pass 1: m = rowmax(S).
    float m0[kSlabs], m1[kSlabs];
#pragma unroll
    for (int sl = 0; sl < kSlabs; ++sl) m0[sl] = m1[sl] = -INFINITY;
    for (int i = 0; i < tiles; ++i) {
      sm90::bar_wait(full + stage, phase);
      float s[kSlabs][kN / 8][4];
      scores(s);
      sm90::turn_pass(wg);
      const Columns cols = sm90::read_tile_bits(bits + 4 * stage, lane);
      sm90::bar_arrive_warp(empty + stage);
#pragma unroll
      for (int sl = 0; sl < kSlabs; ++sl) sm90::tile_row_max<kN>(s[sl], cols, scale, m0[sl], m1[sl]);
      hop::advance<kStages>(stage, phase);
    }

    // Pass 2: p = exp(S - m) against the final m, l = rowsum(p) before
    // dropout and rounding, the keep-mask, p rounded to bf16 as the A
    // fragments of O += P V.
    const unsigned salt = dropout_salt(dr.seed, w.b, w.head);
    unsigned hrow0[kSlabs], hrow1[kSlabs];
    float ml0[kSlabs], ml1[kSlabs], mb0[kSlabs], mb1[kSlabs], l0[kSlabs], l1[kSlabs];
    float acc[kSlabs][kD / 8][4];
#pragma unroll
    for (int sl = 0; sl < kSlabs; ++sl) {
      m0[sl] = quad_max(m0[sl]);
      m1[sl] = quad_max(m1[sl]);
      hrow0[sl] = row_term((unsigned)(row0 + 64 * sl), salt);
      hrow1[sl] = row_term((unsigned)(row0 + 64 * sl + 8), salt);
      ml0[sl] = m0[sl] * kLog2e;
      ml1[sl] = m1[sl] * kLog2e;
      mb0[sl] = (kBigNeg - m0[sl]) * kLog2e;
      mb1[sl] = (kBigNeg - m1[sl]) * kLog2e;
      l0[sl] = l1[sl] = 0.f;
      sm90::zero(acc[sl]);
    }
    for (int i = 0; i < tiles; ++i) {
      sm90::bar_wait(full + stage, phase);
      float s[kSlabs][kN / 8][4];
      scores(s);
      if (i + 1 == tiles) sm90::bar_arrive_warp(qempty + (n & 1));  // the Q tile is read no more
      const Columns cols = sm90::read_tile_bits(bits + 4 * stage, lane);
#pragma unroll
      for (int sl = 0; sl < kSlabs; ++sl) sm90::tile_exp<kN>(s[sl], cols, sl2e, ml0[sl], ml1[sl], mb0[sl], mb1[sl]);
      sm90::turn_pass(wg);
      uint32_t p[kSlabs][kN / 16][4];
#pragma unroll
      for (int sl = 0; sl < kSlabs; ++sl) {
#pragma unroll
        for (int j = 0; j < kN / 8; ++j) {
          float pr[4];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = i * kN + 8 * j + 2 * t + e;
            float p0 = s[sl][j][e];
            float p1 = s[sl][j][2 + e];
            l0[sl] += p0;
            l1[sl] += p1;
            if (dr.on) {
              p0 *= keep_scale_row(dr, hrow0[sl], col);
              p1 *= keep_scale_row(dr, hrow1[sl], col);
            }
            pr[e] = p0;
            pr[2 + e] = p1;
          }
          p[sl][j >> 1][(j & 1) * 2] = pack_bf16(pr[0], pr[1]);      // row g
          p[sl][j >> 1][(j & 1) * 2 + 1] = pack_bf16(pr[2], pr[3]);  // row g + 8
        }
        sm90::fence_regs(p[sl]);
        sm90::fence_regs(acc[sl]);
      }
      sm90::wg_fence();
#pragma unroll
      for (int sl = 0; sl < kSlabs; ++sl)
#pragma unroll
        for (int k = 0; k < kN / 16; ++k)
          sm90::Wgmma<kD>::rs(acc[sl], p[sl][k], L::template mnmajor<kN>(v_tiles + stage * kTile, k), 1);
      sm90::wg_commit();
      sm90::wg_wait<0>();
#pragma unroll
      for (int sl = 0; sl < kSlabs; ++sl) sm90::fence_regs(acc[sl]);
      sm90::bar_arrive_warp(empty + stage);
      hop::advance<kStages>(stage, phase);
    }

    // O = (P V) / l, each quotient as the division rounds it; m and l
    const size_t base = (size_t)w.b * seq * hidden + (size_t)w.head * kD;
    const size_t stat = ((size_t)w.b * heads + w.head) * seq;
#pragma unroll
    for (int sl = 0; sl < kSlabs; ++sl) {
      const int ra = row0 + 64 * sl, rb = ra + 8;
      l0[sl] = quad_sum(l0[sl]);
      l1[sl] = quad_sum(l1[sl]);
      sm90::divide_rows(acc[sl], l0[sl], l1[sl]);
      store_frags<kD>(o + base, acc[sl], ra, 0, seq, hidden, kD, lane);
      if (t == 0) {
        if (ra < seq) {
          m_out[stat + ra] = m0[sl];
          l_out[stat + ra] = l0[sl];
        }
        if (rb < seq) {
          m_out[stat + rb] = m1[sl];
          l_out[stat + rb] = l1[sl];
        }
      }
    }
  }
  if (wg == 0) sm90::turn_wait(wg);  // warpgroup 1's last turn_pass
}

template <int kD, int kSlabs>
int launch_wgmma(const void* q, const void* k, const void* v, const void* mask, void* o, void* m, void* l,
                 int batch, int seq, int hidden, int heads, float scale, Dropout dr, cudaStream_t stream) {
  using S = hop::Smem<kD, kSlabs>;
  constexpr int kCB = sm90::Layout<kD>::kCB;
  CUtensorMap tq, tk, tv;
  int err = sm90::encode_map(&tq, q, batch, seq, hidden, kCB, S::kRows);
  if (!err) err = sm90::encode_map(&tk, k, batch, seq, hidden, kCB, hop::kKeysOf<kSlabs>);
  if (!err) err = sm90::encode_map(&tv, v, batch, seq, hidden, kCB, hop::kKeysOf<kSlabs>);
  if (err) return err;
  auto* kernel = attention_fwd_wgmma_kernel<kD, kSlabs>;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::kBytes);
  if (e != cudaSuccess) return (int)e;
  const int units = (seq + S::kRows - 1) / S::kRows * heads * batch;
  kernel<<<sm90::persistent_blocks(units), hop::kThreads, S::kBytes, stream>>>(
      tq, tk, tv, static_cast<const int*>(mask), static_cast<mma::bf16*>(o), static_cast<float*>(m),
      static_cast<float*>(l), seq, hidden, heads, scale, dr, units);
  return (int)cudaGetLastError();
}

template <int kD>
int launch_wgmma(const void* q, const void* k, const void* v, const void* mask, void* o, void* m, void* l,
                 int batch, int seq, int hidden, int heads, float scale, Dropout dr, cudaStream_t stream) {
  if constexpr (kD <= 64) {
    if (hop::slabs<kD>(seq) == 2)
      return launch_wgmma<kD, 2>(q, k, v, mask, o, m, l, batch, seq, hidden, heads, scale, dr, stream);
  }
  return launch_wgmma<kD, 1>(q, k, v, mask, o, m, l, batch, seq, hidden, heads, scale, dr, stream);
}

// ------------------------------------- FMA units: f32, or bf16 with d > 256

template <typename T>
__global__ void __launch_bounds__(kThreads)
attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, const int* __restrict__ mask,
                     T* __restrict__ o, float* __restrict__ m_out,
                     float* __restrict__ l_out, int seq, int hidden, int heads, int dim,
                     float scale, Dropout dr) {
  extern __shared__ float smem[];
  float* as_ = smem;                  // a 64 x 64 piece of Q
  float* bs_ = as_ + kTile * kStride;  // a piece of K, then of V
  float* ps = bs_ + kTile * kStride;   // p of a 64-key tile, [query][key]

  const int q0 = blockIdx.x * kTile;
  const int head = blockIdx.y;
  const int b = blockIdx.z;
  const size_t base = (size_t)b * seq * hidden + (size_t)head * dim;
  const int* mrow = mask ? mask + (size_t)b * seq : nullptr;
  const unsigned salt = dropout_salt(dr.seed, b, head);

  const int row = threadIdx.x >> 1;   // query row of the tile this thread owns
  const int half = threadIdx.x & 1;   // it owns columns 2c + half, c < kCols
  const int qrow = q0 + row;

  // Pass 1: m = rowmax(S) over the key tiles.
  float mx = -INFINITY;
  for (int k0 = 0; k0 < seq; k0 += kTile) {
    float acc[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[c] = 0.f;
    fma_nt(acc, as_, bs_, q + base, q0, k + base, k0, seq, hidden, dim);
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int col = k0 + 2 * c + half;
      if (col < seq) mx = fmaxf(mx, masked_score(acc[c], scale, mrow, col));
    }
  }
  mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));  // the row's two threads

  // Pass 2, for each 64-wide piece of the head dims: p = exp(S - m) against
  // the final m, l = rowsum(p) before dropout, the keep-mask, p rounded to
  // v's dtype, then O = (p V) / l.
  float l = 0.f;
  for (int c0 = 0; c0 < dim; c0 += kTile) {
    float acc_o[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc_o[c] = 0.f;
    float sum = 0.f;
    for (int k0 = 0; k0 < seq; k0 += kTile) {
      float acc[kCols];
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[c] = 0.f;
      fma_nt(acc, as_, bs_, q + base, q0, k + base, k0, seq, hidden, dim);
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int col = k0 + 2 * c + half;
        float p = 0.f;
        if (col < seq) {
          p = expf(masked_score(acc[c], scale, mrow, col) - mx);
          sum += p;
          if (dr.on) p *= keep_scale(dr, salt, qrow, col);
        }
        ps[row * kStride + 2 * c + half] = round_as(p, T());
      }
      fma_nn(acc_o, ps, bs_, v + base, k0, c0, seq, hidden, dim);
    }
    l = sum + __shfl_xor_sync(0xffffffffu, sum, 1);
    if (qrow < seq) store_piece(o + base + (size_t)qrow * hidden, acc_o, c0, dim, l);
  }
  if (half == 0 && qrow < seq) {
    const size_t idx = ((size_t)b * heads + head) * seq + qrow;
    m_out[idx] = mx;
    l_out[idx] = l;
  }
}

template <typename T>
int launch(const void* q, const void* k, const void* v, const void* mask, void* o,
           void* m, void* l, int batch, int seq, int hidden, int heads, int dim, float scale,
           Dropout dr, cudaStream_t stream) {
  const size_t smem = sizeof(float) * 3 * kTile * kStride;
  cudaError_t err = cudaFuncSetAttribute(attention_fwd_kernel<T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((seq + kTile - 1) / kTile, heads, batch);
  attention_fwd_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const int*>(mask), static_cast<T*>(o), static_cast<float*>(m),
      static_cast<float*>(l), seq, hidden, heads, dim, scale, dr);
  return (int)cudaGetLastError();
}

}  // namespace

// C entry point. dtype: 0 = float32, 1 = bfloat16 (q, k, v and o), head dim
// d = hidden / heads. route: 0 = FMA units (either dtype, any d % 8 == 0,
// any T), 1 = tensor cores by mma.sync (bfloat16, d <= 256; tensors
// 16-byte aligned): the whole-head kernel for d = 64 and T <= 128, else
// the tiled one; 2 = tensor cores by wgmma on TMA-fed tiles (bfloat16,
// d = 32, 64 or 128, any T; tensors 16-byte aligned). mask
// is (B, T) int32 with 1 = keep, or null. scale is 1 / sqrt(d). dropout =
// 0 turns the keep-mask off; otherwise keep iff hash >= thresh, kept p
// scaled by inv_keep. Shapes are checked by the Python wrapper. Returns
// the CUDA error code of the launch (0 on success).
extern "C" int attention_fwd(const void* q, const void* k, const void* v,
                             const void* mask, void* o, void* m, void* l,
                             int batch, int seq, int hidden, int heads,
                             int dtype, int route, float scale, int dropout, int seed,
                             unsigned thresh, float inv_keep, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Dropout dr{dropout, seed, thresh, inv_keep};
  if (heads <= 0 || hidden % heads || (hidden / heads) % 8 || seq <= 0) return (int)cudaErrorInvalidValue;
  const int dim = hidden / heads;
  if (route == 2) {
    if (dtype != 1) return (int)cudaErrorInvalidValue;
    if (dim == 32) return launch_wgmma<32>(q, k, v, mask, o, m, l, batch, seq, hidden, heads, scale, dr, st);
    if (dim == 64) return launch_wgmma<64>(q, k, v, mask, o, m, l, batch, seq, hidden, heads, scale, dr, st);
    if (dim == 128) return launch_wgmma<128>(q, k, v, mask, o, m, l, batch, seq, hidden, heads, scale, dr, st);
    return (int)cudaErrorInvalidValue;
  }
  if (route == 1) {
    if (dtype != 1 || dim > 256) return (int)cudaErrorInvalidValue;
    if (dim == mma::kHeadDim && seq <= mma::kMaxSeq)
      return launch_mma(q, k, v, mask, o, m, l, batch, seq, hidden, heads, scale, dr, st);
    if (dim <= 32) return launch_tiled<32>(q, k, v, mask, o, m, l, batch, seq, hidden, heads, dim, scale, dr, st);
    if (dim <= 64) return launch_tiled<64>(q, k, v, mask, o, m, l, batch, seq, hidden, heads, dim, scale, dr, st);
    if (dim <= 128) return launch_tiled<128>(q, k, v, mask, o, m, l, batch, seq, hidden, heads, dim, scale, dr, st);
    return launch_tiled<256>(q, k, v, mask, o, m, l, batch, seq, hidden, heads, dim, scale, dr, st);
  }
  if (dtype == 0)
    return launch<float>(q, k, v, mask, o, m, l, batch, seq, hidden, heads, dim, scale, dr, st);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, mask, o, m, l, batch, seq, hidden, heads, dim, scale,
                                 dr, st);
  return (int)cudaErrorInvalidValue;
}

// Dynamic shared memory of one block of the whole-head tensor-core kernel,
// bytes.
extern "C" int attention_fwd_mma_smem(void) { return (int)kMmaSmem; }
