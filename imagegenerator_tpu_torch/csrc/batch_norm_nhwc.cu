// BatchNorm over channels-last rows for Hopper (sm_90a): the forward in
// training mode (batch moments, the running statistics' update) and in
// eval mode, the backward, and the backward's own backward, which the
// WGAN-GP penalty's second-order term takes.
//
// It replaces no TPU kernel: the JAX package leaves BatchNorm to XLA,
// which fuses flax's nn.BatchNorm into the ops around it. In the port
// PyTorch ran it as a chain of eager ops on f32 copies, differentiated op
// by op, twice for the penalty; these kernels take its place in
// ops/kernels/batchnorm.py, whose plain versions are the same arithmetic
// in PyTorch ops.
//
// The rows (n, c) are the (N*H*W, C) view of a channels-last NCHW map: a
// channel is the flat index mod c. Each pass is a per-channel reduction
// and then one elementwise pass, with x^ = (x - mean) * rstd:
//   forward    sums (S x, S x^2)            y = (x - mean) * (rstd * w) + b
//   backward   sums (S g, S g x^)           dx
//   double     sums (S gg, S gg x^, S gg g)  d/dg and d/dx of <gg, dx>
// Between the two the caller may add the sums over a process group
// (BatchNorm.sync): the elementwise pass computes its per-channel
// constants from the sums it is given, in its prologue.
//
// What bounds it: bytes. There is no product for the tensor cores. In
// bf16 the forward reads x twice and writes y, about 6 bytes an element;
// the backward reads g and x twice and writes dx, about 10; the double
// backward reads gg, x and g twice and writes two, about 16. The design
// spends nothing else: 16-byte loads along the contiguous rows, and a
// block is a tile of whole rows (blockDim.x pieces across a row, blockDim.y
// rows), so a thread keeps the same channels for the whole pass and holds
// their constants and sums in registers. Blocks stride over the rows; each
// writes its partial sums to a (blocks, K, c) f32 buffer and a second small
// kernel adds them in a fixed order. No float atomics: a call repeats bit
// for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int kFinalRows = 8;  // threadIdx.y of the finalize kernel
enum Mode { kFwd = 0, kBwd = 1, kDbl = 2 };

// VEC values of a row at p, as floats. p is aligned to VEC elements (the
// wrapper's rule), so VEC 4 or 8 is one 8- or 16-byte access per type.
template <typename T, int VEC>
struct Vec;

template <int VEC>
struct Vec<float, VEC> {
  static __device__ __forceinline__ void load(const float* p, float* v) {
    if constexpr (VEC % 4 == 0) {
#pragma unroll
      for (int i = 0; i < VEC; i += 4) {
        const float4 q = *reinterpret_cast<const float4*>(p + i);
        v[i] = q.x, v[i + 1] = q.y, v[i + 2] = q.z, v[i + 3] = q.w;
      }
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) v[i] = p[i];
    }
  }
  static __device__ __forceinline__ void store(float* p, const float* v) {
    if constexpr (VEC % 4 == 0) {
#pragma unroll
      for (int i = 0; i < VEC; i += 4) {
        *reinterpret_cast<float4*>(p + i) = make_float4(v[i], v[i + 1], v[i + 2], v[i + 3]);
      }
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) p[i] = v[i];
    }
  }
};

template <int VEC>
struct Vec<__nv_bfloat16, VEC> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* v) {
    if constexpr (VEC == 8) {
      const uint4 q = *reinterpret_cast<const uint4*>(p);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = __bfloat1622float2(h[i]);
        v[2 * i] = f.x, v[2 * i + 1] = f.y;
      }
    } else if constexpr (VEC == 4) {
      const uint2 q = *reinterpret_cast<const uint2*>(p);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const float2 f = __bfloat1622float2(h[i]);
        v[2 * i] = f.x, v[2 * i + 1] = f.y;
      }
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) v[i] = __bfloat162float(p[i]);
    }
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, const float* v) {
    if constexpr (VEC == 8 || VEC == 4) {
      __nv_bfloat162 h[VEC / 2];
#pragma unroll
      for (int i = 0; i < VEC / 2; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
      if constexpr (VEC == 8) {
        *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(h);
      } else {
        *reinterpret_cast<uint2*>(p) = *reinterpret_cast<const uint2*>(h);
      }
    } else {
#pragma unroll
      for (int i = 0; i < VEC; ++i) p[i] = __float2bfloat16_rn(v[i]);
    }
  }
};

// The per-channel reduction over the rows: K sums of each of this
// thread's VEC channels, over the rows blockIdx.x * by + ty + k * (gridDim.x
// * by), then over the block's rows by a fixed tree, to
// partial[blockIdx.x][K][c]. a is x (forward), g (backward) or gg (double).
template <int MODE, typename TX, typename TY, int VEC>
__global__ void __launch_bounds__(kThreads)
batch_norm_reduce_kernel(const void* __restrict__ a_, const TX* __restrict__ x,
                         const TY* __restrict__ g, const float* __restrict__ stats,
                         float* __restrict__ partial, int n, int c) {
  using TA = typename std::conditional<MODE == kBwd, TY, TX>::type;
  constexpr int K = MODE == kDbl ? 3 : 2;
  constexpr int KV = K * VEC;
  __shared__ float red[kThreads * KV];
  const TA* a = static_cast<const TA*>(a_);
  const int tx = threadIdx.x, ty = threadIdx.y, bx = blockDim.x, by = blockDim.y;
  const int col = (blockIdx.y * bx + tx) * VEC;
  const bool live = col < c;

  float acc[KV];
#pragma unroll
  for (int j = 0; j < KV; ++j) acc[j] = 0.0f;
  float mu[VEC], rs[VEC];
  if (MODE != kFwd && live) {
#pragma unroll
    for (int v = 0; v < VEC; ++v) mu[v] = stats[col + v], rs[v] = stats[c + col + v];
  }
  auto add = [&](size_t off) {
    float av[VEC];
    Vec<TA, VEC>::load(a + off, av);
    if constexpr (MODE == kFwd) {
#pragma unroll
      for (int v = 0; v < VEC; ++v) acc[v] += av[v], acc[VEC + v] += av[v] * av[v];
    } else {
      float xv[VEC];
      Vec<TX, VEC>::load(x + off, xv);
      float gv[VEC];
      if constexpr (MODE == kDbl) Vec<TY, VEC>::load(g + off, gv);
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        const float xh = (xv[v] - mu[v]) * rs[v];
        acc[v] += av[v];
        acc[VEC + v] += av[v] * xh;
        if constexpr (MODE == kDbl) acc[2 * VEC + v] += av[v] * gv[v];
      }
    }
  };
  if (live) {
    const long long step = static_cast<long long>(gridDim.x) * by;
    long long row = static_cast<long long>(blockIdx.x) * by + ty;
    for (; row + step < n; row += 2 * step) {  // two rows in flight
      add(static_cast<size_t>(row) * c + col);
      add(static_cast<size_t>(row + step) * c + col);
    }
    if (row < n) add(static_cast<size_t>(row) * c + col);
  }

#pragma unroll
  for (int j = 0; j < KV; ++j) red[(ty * KV + j) * bx + tx] = acc[j];
  __syncthreads();
  int half = 1;
  while (half < by) half <<= 1;
  for (half >>= 1; half > 0; half >>= 1) {
    if (ty < half && ty + half < by) {
#pragma unroll
      for (int j = 0; j < KV; ++j) red[(ty * KV + j) * bx + tx] += red[((ty + half) * KV + j) * bx + tx];
    }
    __syncthreads();
  }
  if (ty == 0 && live) {
    float* out = partial + static_cast<size_t>(blockIdx.x) * K * c;
#pragma unroll
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int v = 0; v < VEC; ++v) out[k * c + col + v] = red[(k * VEC + v) * bx + tx];
    }
  }
}

// sums[j] = sum over b of partial[b][j], j < kc, in a fixed order.
__global__ void __launch_bounds__(32 * kFinalRows)
batch_norm_finalize_kernel(const float* __restrict__ partial, float* __restrict__ sums, int blocks,
                           int kc) {
  __shared__ float red[kFinalRows][33];
  const int j = blockIdx.x * 32 + threadIdx.x;
  float s = 0.0f;
  if (j < kc) {
    for (int b = threadIdx.y; b < blocks; b += kFinalRows) s += partial[static_cast<size_t>(b) * kc + j];
  }
  red[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && j < kc) {
    float t = 0.0f;
#pragma unroll
    for (int i = 0; i < kFinalRows; ++i) t += red[i][threadIdx.x];
    sums[j] = t;
  }
}

// Everything an elementwise pass reads or writes besides its rows; the
// pointers a mode does not use are null.
struct ApplyArgs {
  const void* a;           // x (forward), g (backward), gg (double)
  const void* x;           // x (backward, double)
  const void* g;           // g (double)
  void* out0;              // y, dx, or d/dg (double)
  void* out1;              // d/dx (double)
  const float* w;          // weight
  const float* b;          // bias (forward)
  const float* sums;       // the pass's sums over the group: (2, c), or (3 or 5, c) for the double
  const float* local;      // double: this rank's own (3, c) sums
  const float* bsums;      // double: the backward's (2, c) sums over the group
  const float* blocal;     // double: the backward's own (2, c) sums, (db, dw)
  float* stats;            // (3, c): mean, rstd, mask; written by the forward
  float* running_mean;     // forward
  float* running_var;      // forward
  const float* ggw;        // double: the upstream gradient of dw, or null
  const float* ggb;        // double: of db, or null
  float* gw;               // double: d/dw (c)
  int n, c;
  float count;             // forward: rows over the group
  float inv;               // backward, double: 1 / count in training, 0 in eval
  float eps, keep, momentum;
  int training, update;    // forward
};

template <int MODE, typename TX, typename TY, int VEC>
__global__ void __launch_bounds__(kThreads)
batch_norm_apply_kernel(const ApplyArgs p) {
  using TA = typename std::conditional<MODE == kBwd, TY, TX>::type;
  using TO = typename std::conditional<MODE == kFwd, TY, TX>::type;  // out0 of fwd/bwd
  constexpr int NCOEF = MODE == kFwd ? 3 : (MODE == kBwd ? 5 : 9);
  const int c = p.c;
  const int col = (blockIdx.y * blockDim.x + threadIdx.x) * VEC;
  if (col >= c) return;  // no barrier below
  const bool first = blockIdx.x == 0 && threadIdx.y == 0;

  // per-channel constants: forward (mean, rstd * w, b); backward (mean,
  // rstd, rstd * w, S g / M, mask * S g x^ / M); double (mean, rstd, then
  // the seven of the two outputs' affine forms, below)
  float k[NCOEF][VEC];
#pragma unroll
  for (int v = 0; v < VEC; ++v) {
    const int ch = col + v;
    const float w = p.w[ch];
    if constexpr (MODE == kFwd) {
      float mean, var, mask;
      if (p.training) {
        mean = p.sums[ch] / p.count;
        const float d = p.sums[c + ch] / p.count - mean * mean;
        var = d < 0.0f ? 0.0f : d;  // a NaN stays NaN, as clamp_min keeps it
        mask = d >= 0.0f ? 1.0f : 0.0f;
      } else {
        mean = p.running_mean[ch], var = p.running_var[ch], mask = 0.0f;
      }
      const float rstd = 1.0f / sqrtf(var + p.eps);
      k[0][v] = mean, k[1][v] = rstd * w, k[2][v] = p.b[ch];
      if (first) {
        p.stats[ch] = mean, p.stats[c + ch] = rstd, p.stats[2 * c + ch] = mask;
        if (p.update) {
          p.running_mean[ch] = p.keep * p.running_mean[ch] + p.momentum * mean;
          p.running_var[ch] = p.keep * p.running_var[ch] + p.momentum * var;
        }
      }
    } else {
      const float mean = p.stats[ch], r = p.stats[c + ch], m = p.stats[2 * c + ch];
      const float u = r * w, iM = p.inv;
      k[0][v] = mean, k[1][v] = r, k[2][v] = u;
      if constexpr (MODE == kBwd) {
        k[3][v] = p.sums[ch] * iM;
        k[4][v] = m * p.sums[c + ch] * iM;
      } else {
        const float G = p.sums[ch], Gx = p.sums[c + ch], Ggg = p.sums[2 * c + ch];
        const float Sg = p.bsums[ch], Sgx = p.bsums[c + ch];
        const float ggw = p.ggw ? p.ggw[ch] : 0.0f, ggb = p.ggb ? p.ggb[ch] : 0.0f;
        const float Wg = p.ggw ? p.sums[3 * c + ch] : 0.0f;
        const float Wgx = p.ggw ? p.sums[4 * c + ch] : 0.0f;
        // d/dg = u * gg + x^ * c1 + c0
        k[3][v] = ggw - u * (m * Gx * iM);
        k[4][v] = ggb - u * (G * iM);
        // d/dx = alpha * g + beta * gg + gamma * x^ + delta
        const float kk = m * w * r * r * iM;
        const float p3 = G * Sg * iM - Ggg + 3.0f * Sgx * Gx * iM;
        k[5][v] = -kk * Gx + r * ggw;
        k[6][v] = -kk * Sgx;
        k[7][v] = kk * p3 - r * m * Wgx * iM;
        k[8][v] = kk * (Gx * Sg * iM + Sgx * G * iM) - r * Wg * iM;
        if (first) {
          const float db = p.blocal[ch], dw = p.blocal[c + ch], Gl = p.local[2 * c + ch];
          p.gw[ch] = r * (Gl - db * G * iM - m * dw * Gx * iM);
        }
      }
    }
  }

  const TA* a = static_cast<const TA*>(p.a);
  const TX* x = static_cast<const TX*>(p.x);
  const TY* g = static_cast<const TY*>(p.g);
  auto one = [&](size_t off) {
    float av[VEC], o0[VEC];
    Vec<TA, VEC>::load(a + off, av);
    if constexpr (MODE == kFwd) {
#pragma unroll
      for (int v = 0; v < VEC; ++v) o0[v] = (av[v] - k[0][v]) * k[1][v] + k[2][v];
      Vec<TO, VEC>::store(static_cast<TO*>(p.out0) + off, o0);
    } else if constexpr (MODE == kBwd) {
      float xv[VEC];
      Vec<TX, VEC>::load(x + off, xv);
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        const float xh = (xv[v] - k[0][v]) * k[1][v];
        o0[v] = k[2][v] * (av[v] - k[3][v] - xh * k[4][v]);
      }
      Vec<TO, VEC>::store(static_cast<TO*>(p.out0) + off, o0);
    } else {
      float xv[VEC], gv[VEC], o1[VEC];
      Vec<TX, VEC>::load(x + off, xv);
      Vec<TY, VEC>::load(g + off, gv);
#pragma unroll
      for (int v = 0; v < VEC; ++v) {
        const float xh = (xv[v] - k[0][v]) * k[1][v];
        o0[v] = k[2][v] * av[v] + xh * k[3][v] + k[4][v];
        o1[v] = k[5][v] * gv[v] + k[6][v] * av[v] + k[7][v] * xh + k[8][v];
      }
      Vec<TY, VEC>::store(static_cast<TY*>(p.out0) + off, o0);
      Vec<TX, VEC>::store(static_cast<TX*>(p.out1) + off, o1);
    }
  };
  const long long step = static_cast<long long>(gridDim.x) * blockDim.y;
  long long row = static_cast<long long>(blockIdx.x) * blockDim.y + threadIdx.y;
  for (; row + step < p.n; row += 2 * step) {
    one(static_cast<size_t>(row) * c + col);
    one(static_cast<size_t>(row + step) * c + col);
  }
  if (row < p.n) one(static_cast<size_t>(row) * c + col);
}

// The block of a pass: blockDim.x pieces of VEC channels across a row (the
// whole row when it has at most kThreads pieces), blockDim.y rows, and
// gridDim.y tiles across the row. The wrapper sizes its buffers by the
// same rule (ops/kernels/batchnorm.py::_geometry).
struct Geometry {
  dim3 block;
  int tiles;
};

Geometry geometry(int c, int vec) {
  const int pieces = c / vec;
  const int bx = pieces < kThreads ? pieces : kThreads;
  return {dim3(bx, kThreads / bx), (pieces + bx - 1) / bx};
}

// codes: bit 0 the dtype of x (0 f32, 1 bf16), bit 1 that of y (and so of
// g); bits 2-3 the vector width: 0 for 1, 1 for 4, 2 for 8 (both bf16).
// F::run<MODE, TX, TY, VEC>() launches one instance.
template <int MODE, typename TX, typename TY, typename F>
int by_vec(int vcode, const F& f) {
  if (vcode == 0) return f.template run<MODE, TX, TY, 1>();
  if (vcode == 1) return f.template run<MODE, TX, TY, 4>();
  if constexpr (std::is_same<TX, __nv_bfloat16>::value && std::is_same<TY, __nv_bfloat16>::value) {
    if (vcode == 2) return f.template run<MODE, TX, TY, 8>();
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

template <int MODE, typename F>
int by_codes(int codes, const F& f) {
  const int vcode = (codes >> 2) & 3;
  switch (codes & 3) {
    case 0: return by_vec<MODE, float, float>(vcode, f);
    case 1: return by_vec<MODE, __nv_bfloat16, float>(vcode, f);
    case 2: return by_vec<MODE, float, __nv_bfloat16>(vcode, f);
    default: return by_vec<MODE, __nv_bfloat16, __nv_bfloat16>(vcode, f);
  }
}

struct ReduceLaunch {
  const void *a, *x, *g;
  const float* stats;
  float* partial;
  int n, c, blocks;
  cudaStream_t stream;
  template <int MODE, typename TX, typename TY, int VEC>
  int run() const {
    const Geometry geo = geometry(c, VEC);
    batch_norm_reduce_kernel<MODE, TX, TY, VEC><<<dim3(blocks, geo.tiles), geo.block, 0, stream>>>(
        a, static_cast<const TX*>(x), static_cast<const TY*>(g), stats, partial, n, c);
    return 0;
  }
};

struct ApplyLaunch {
  const ApplyArgs& p;
  int blocks;
  cudaStream_t stream;
  template <int MODE, typename TX, typename TY, int VEC>
  int run() const {
    const Geometry geo = geometry(p.c, VEC);
    batch_norm_apply_kernel<MODE, TX, TY, VEC><<<dim3(blocks, geo.tiles), geo.block, 0, stream>>>(p);
    return 0;
  }
};

template <int MODE>
int launch_reduce(const ReduceLaunch& r, float* sums, int codes) {
  constexpr int K = MODE == kDbl ? 3 : 2;
  const int rc = by_codes<MODE>(codes, r);
  if (rc) return rc;
  batch_norm_finalize_kernel<<<(K * r.c + 31) / 32, dim3(32, kFinalRows), 0, r.stream>>>(
      r.partial, sums, r.blocks, K * r.c);
  return static_cast<int>(cudaGetLastError());
}

template <int MODE>
int launch_apply(const ApplyArgs& p, int codes, int blocks, cudaStream_t stream) {
  const int rc = by_codes<MODE>(codes, ApplyLaunch{p, blocks, stream});
  return rc ? rc : static_cast<int>(cudaGetLastError());
}

}  // namespace

// The per-channel sums of a pass over rows (n, c), into sums (K, c): mode
// 0 (S x, S x^2) of a = x; 1 (S g, S g x^) of a = g with x; 2 (S gg,
// S gg x^, S gg g) of a = gg with x and g. stats (3, c) is the forward's
// (mean, rstd, mask), read by modes 1 and 2. partial holds blocks * K * c
// floats. Two launches: the blocks' partial sums, then their sum.
// Returns cudaGetLastError().
extern "C" int batch_norm_sums(int mode, const void* a, const void* x, const void* g,
                               const float* stats, float* partial, float* sums, int n, int c,
                               int codes, int blocks, void* stream_ptr) {
  const ReduceLaunch r{a, x, g, stats, partial, n, c, blocks, static_cast<cudaStream_t>(stream_ptr)};
  if (mode == kFwd) return launch_reduce<kFwd>(r, sums, codes);
  if (mode == kBwd) return launch_reduce<kBwd>(r, sums, codes);
  if (mode == kDbl) return launch_reduce<kDbl>(r, sums, codes);
  return static_cast<int>(cudaErrorInvalidValue);
}

// The forward's elementwise pass: y (n, c) from x, in training mode from
// the sums (S x, S x^2) over count rows, else from the running statistics;
// writes stats (mean, rstd, mask) and, with update, the running statistics
// (keep * old + momentum * batch, the biased batch variance).
extern "C" int batch_norm_fwd(const void* x, void* y, const float* w, const float* b,
                              const float* sums, float* stats, float* running_mean,
                              float* running_var, int n, int c, float count, float eps, float keep,
                              float momentum, int training, int update, int codes, int blocks,
                              void* stream_ptr) {
  ApplyArgs p{};
  p.a = x, p.out0 = y, p.w = w, p.b = b, p.sums = sums, p.stats = stats;
  p.running_mean = running_mean, p.running_var = running_var;
  p.n = n, p.c = c, p.count = count, p.eps = eps, p.keep = keep, p.momentum = momentum;
  p.training = training, p.update = update;
  return launch_apply<kFwd>(p, codes, blocks, static_cast<cudaStream_t>(stream_ptr));
}

// The backward's elementwise pass: dx = rstd * w * (g - S g / M - mask * x^
// * S g x^ / M) from the sums (S g, S g x^) over the group; inv is 1 / M
// in training, 0 in eval.
extern "C" int batch_norm_bwd(const void* g, const void* x, void* dx, const float* w,
                              const float* stats, const float* sums, int n, int c, float inv,
                              int codes, int blocks, void* stream_ptr) {
  ApplyArgs p{};
  p.a = g, p.x = x, p.out0 = dx, p.w = w, p.stats = const_cast<float*>(stats), p.sums = sums;
  p.n = n, p.c = c, p.inv = inv;
  return launch_apply<kBwd>(p, codes, blocks, static_cast<cudaStream_t>(stream_ptr));
}

// The double backward's elementwise pass: given the upstream gradients gg
// of dx, ggw of dw and ggb of db (either may be null), writes ggo = d/dg
// (n, c), gi = d/dx (n, c) and gw = d/dw (c). sums (3, c) over the group,
// or (5, c) with ggw (rows 3, 4: S ggw db and S ggw dw); local this rank's
// (3, c); bsums and blocal the backward's (S g, S g x^) over the group and
// this rank's own.
extern "C" int batch_norm_double_bwd(const void* gg, const void* x, const void* g, void* ggo,
                                     void* gi, float* gw, const float* w, const float* stats,
                                     const float* sums, const float* local, const float* bsums,
                                     const float* blocal, const float* ggw, const float* ggb, int n,
                                     int c, float inv, int codes, int blocks, void* stream_ptr) {
  ApplyArgs p{};
  p.a = gg, p.x = x, p.g = g, p.out0 = ggo, p.out1 = gi, p.gw = gw, p.w = w;
  p.stats = const_cast<float*>(stats);  // read only in this mode
  p.sums = sums, p.local = local, p.bsums = bsums, p.blocal = blocal, p.ggw = ggw, p.ggb = ggb;
  p.n = n, p.c = c, p.inv = inv;
  return launch_apply<kDbl>(p, codes, blocks, static_cast<cudaStream_t>(stream_ptr));
}
