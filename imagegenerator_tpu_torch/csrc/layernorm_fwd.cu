// Row LayerNorm forward for Hopper (sm_90a).
//
// Replaces imagegenerator_tpu/ops/pallas/layernorm.py::_call_fwd (kernel
// body _fwd_kernel): for each row of x (N, D)
//   mean = sum(x) / D,  var = sum((x - mean)^2) / D   (two passes, f32),
//   rstd = 1 / sqrt(var + eps),  y = (x - mean) * rstd * scale + bias,
// and it returns y, mean (N) and rstd (N), the statistics in f32 whatever
// the type of x.
//
// What bounds it: bytes. x is read once and y written once; there is no
// product for the tensor cores. At the shapes of BERT-base the kernel is
// a few microseconds long, so what a caller waits for is the launch: the
// entry point below is plain C, reached through ctypes, and the wrapper
// does as little as it can around it.
//
// Two routes, chosen by the wrapper (ops/kernels/layernorm.py::fwd_route):
//
// warp:  one warp per row, for D <= 1024 in whole 16-byte pieces with f32
//        scale and bias. A lane reads its pieces (4 f32 or 8 16-bit values
//        each, lanes on neighbouring pieces) into registers, where the row
//        stays: both reductions are warp shuffles, there is no shared
//        memory and no barrier. Four rows a block; scale and bias come
//        through the read-only path and stay in L1 for the block's rows.
// block: one block of 256 threads per row, for every other D and type.
//        The row is read three times (sum, squares, output); the second
//        and third pass find it in L1 or L2. Types are looked up at run
//        time, so one kernel takes x, scale, bias and y in any of f32,
//        bf16 and f16.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarpRows = 4;     // warps, and rows, per block on the warp route
constexpr int kWarpMaxD = 1024;  // 32 lanes x 32 values in registers
constexpr int kBlockThreads = 256;

enum Dtype { kF32 = 0, kBF16 = 1, kF16 = 2 };

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// One 16-byte piece of a row as f32 values.
template <typename T>
struct Piece;

template <>
struct Piece<float> {
  static constexpr int kWidth = 4;
  static __device__ __forceinline__ void load(const float* p, float* v) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x, v[1] = q.y, v[2] = q.z, v[3] = q.w;
  }
};

template <>
struct Piece<__nv_bfloat16> {
  static constexpr int kWidth = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p, float* v) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(h[i]);
      v[2 * i] = f.x, v[2 * i + 1] = f.y;
    }
  }
};

template <>
struct Piece<__half> {
  static constexpr int kWidth = 8;
  static __device__ __forceinline__ void load(const __half* p, float* v) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    const __half2* h = reinterpret_cast<const __half2*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __half22float2(h[i]);
      v[2 * i] = f.x, v[2 * i + 1] = f.y;
    }
  }
};

template <typename T>
__global__ void __launch_bounds__(kWarpRows * 32)
layernorm_fwd_warp_kernel(const T* __restrict__ x, const float* __restrict__ w,
                          const float* __restrict__ b, float* __restrict__ y,
                          float* __restrict__ mean, float* __restrict__ rstd, int n, int d,
                          float eps) {
  constexpr int kWidth = Piece<T>::kWidth;
  constexpr int kPieces = kWarpMaxD / (32 * kWidth);  // pieces a lane may hold
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * kWarpRows + (threadIdx.x >> 5);
  if (row >= n) return;  // the whole warp leaves; the kernel has no barrier
  const T* xr = x + static_cast<size_t>(row) * d;

  // every load of the row is asked for at once; scale and bias follow
  // before the reductions need their results, so their latency hides
  // behind the row's. Sums go pairwise: a chain of one add a piece.
  float v[kPieces * kWidth];
  float sum = 0.0f;
#pragma unroll
  for (int c = 0; c < kPieces; ++c) {
    if ((lane + 32 * c) * kWidth < d) Piece<T>::load(xr + (lane + 32 * c) * kWidth, v + c * kWidth);
  }
  float4 ww[kPieces * kWidth / 4], bb[kPieces * kWidth / 4];
#pragma unroll
  for (int c = 0; c < kPieces; ++c) {
    const int col = (lane + 32 * c) * kWidth;
    if (col < d) {
#pragma unroll
      for (int i = 0; i < kWidth; i += 4) {
        ww[(c * kWidth + i) / 4] = __ldg(reinterpret_cast<const float4*>(w + col + i));
        bb[(c * kWidth + i) / 4] = __ldg(reinterpret_cast<const float4*>(b + col + i));
      }
    }
  }
#pragma unroll
  for (int c = 0; c < kPieces; ++c) {
    if ((lane + 32 * c) * kWidth < d) {
#pragma unroll
      for (int i = 0; i < kWidth; i += 4) {
        const float* t = v + c * kWidth + i;
        sum += (t[0] + t[1]) + (t[2] + t[3]);
      }
    }
  }
  const float inv_d = 1.0f / static_cast<float>(d);
  const float mu = warp_sum(sum) * inv_d;

  float squares = 0.0f;
#pragma unroll
  for (int c = 0; c < kPieces; ++c) {
    if ((lane + 32 * c) * kWidth < d) {
#pragma unroll
      for (int i = 0; i < kWidth; i += 4) {
        float* t = v + c * kWidth + i;
        t[0] -= mu, t[1] -= mu, t[2] -= mu, t[3] -= mu;
        squares += (t[0] * t[0] + t[1] * t[1]) + (t[2] * t[2] + t[3] * t[3]);
      }
    }
  }
  const float rs = rsqrtf(warp_sum(squares) * inv_d + eps);

  float* yr = y + static_cast<size_t>(row) * d;
#pragma unroll
  for (int c = 0; c < kPieces; ++c) {
    const int col = (lane + 32 * c) * kWidth;
    if (col < d) {
#pragma unroll
      for (int i = 0; i < kWidth; i += 4) {
        const float4 s4 = ww[(c * kWidth + i) / 4], b4 = bb[(c * kWidth + i) / 4];
        const float* t = v + c * kWidth + i;
        float4 o;
        o.x = t[0] * rs * s4.x + b4.x;
        o.y = t[1] * rs * s4.y + b4.y;
        o.z = t[2] * rs * s4.z + b4.z;
        o.w = t[3] * rs * s4.w + b4.w;
        *reinterpret_cast<float4*>(yr + col + i) = o;
      }
    }
  }
  if (lane == 0) {
    mean[row] = mu;
    rstd[row] = rs;
  }
}

__device__ __forceinline__ float load_as_float(const void* p, int dtype, size_t i) {
  if (dtype == kF32) return static_cast<const float*>(p)[i];
  if (dtype == kBF16) return __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i]);
  return __half2float(static_cast<const __half*>(p)[i]);
}

__device__ __forceinline__ void store_from_float(void* p, int dtype, size_t i, float v) {
  if (dtype == kF32) {
    static_cast<float*>(p)[i] = v;
  } else if (dtype == kBF16) {
    static_cast<__nv_bfloat16*>(p)[i] = __float2bfloat16_rn(v);
  } else {
    static_cast<__half*>(p)[i] = __float2half_rn(v);
  }
}

// The sum of v over the block, the same in every thread.
__device__ __forceinline__ float block_sum(float v, float* partial) {
  v = warp_sum(v);
  __syncthreads();  // the sum before this one has been read
  if ((threadIdx.x & 31) == 0) partial[threadIdx.x >> 5] = v;
  __syncthreads();
  float total = 0.0f;
#pragma unroll
  for (int i = 0; i < kBlockThreads / 32; ++i) total += partial[i];
  return total;
}

__global__ void __launch_bounds__(kBlockThreads)
layernorm_fwd_block_kernel(const void* __restrict__ x, const void* __restrict__ w,
                           const void* __restrict__ b, void* __restrict__ y,
                           float* __restrict__ mean, float* __restrict__ rstd, int d, float eps,
                           int x_dtype, int w_dtype, int b_dtype, int y_dtype) {
  __shared__ float partial[kBlockThreads / 32];
  const size_t base = static_cast<size_t>(blockIdx.x) * d;

  float sum = 0.0f;
  for (int i = threadIdx.x; i < d; i += kBlockThreads) sum += load_as_float(x, x_dtype, base + i);
  const float mu = block_sum(sum, partial) / static_cast<float>(d);

  float squares = 0.0f;
  for (int i = threadIdx.x; i < d; i += kBlockThreads) {
    const float t = load_as_float(x, x_dtype, base + i) - mu;
    squares += t * t;
  }
  const float rs = 1.0f / sqrtf(block_sum(squares, partial) / static_cast<float>(d) + eps);

  for (int i = threadIdx.x; i < d; i += kBlockThreads) {
    const float t = (load_as_float(x, x_dtype, base + i) - mu) * rs;
    store_from_float(y, y_dtype, base + i,
                     t * load_as_float(w, w_dtype, i) + load_as_float(b, b_dtype, i));
  }
  if (threadIdx.x == 0) {
    mean[blockIdx.x] = mu;
    rstd[blockIdx.x] = rs;
  }
}

template <typename T>
void launch_warp(const void* x, const void* w, const void* b, void* y, float* mean, float* rstd,
                 int n, int d, float eps, cudaStream_t stream) {
  layernorm_fwd_warp_kernel<T><<<(n + kWarpRows - 1) / kWarpRows, kWarpRows * 32, 0, stream>>>(
      static_cast<const T*>(x), static_cast<const float*>(w), static_cast<const float*>(b),
      static_cast<float*>(y), mean, rstd, n, d, eps);
}

}  // namespace

// x (n, d), scale w and bias b (d), y (n, d); stats (2, n) f32 receives the
// means, then the rstds. codes packs five small numbers, two bits each
// from the lowest: the dtypes of x, w, b and y (0 f32, 1 bf16, 2 f16) and
// the route. Route 1 is the warp route, which takes d <= 1024 in whole
// 16-byte pieces of x, 16-byte aligned pointers, and w, b and y in f32
// (the wrapper's rule); anything else is the block route. Few arguments,
// because each costs the caller's ctypes a conversion. Returns
// cudaGetLastError() after the launch; n = 0 launches nothing.
extern "C" int layernorm_fwd(const void* x, const void* w, const void* b, void* y, void* stats,
                             int n, int d, float eps, int codes, void* stream_ptr) {
  if (n <= 0) return 0;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int x_dtype = codes & 3, w_dtype = (codes >> 2) & 3, b_dtype = (codes >> 4) & 3;
  const int y_dtype = (codes >> 6) & 3, route = (codes >> 8) & 3;
  float* mu = static_cast<float*>(stats);
  float* rs = mu + n;
  if (route == 1) {
    if (w_dtype != kF32 || b_dtype != kF32 || y_dtype != kF32 || d > kWarpMaxD) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    if (x_dtype == kF32) {
      launch_warp<float>(x, w, b, y, mu, rs, n, d, eps, stream);
    } else if (x_dtype == kBF16) {
      launch_warp<__nv_bfloat16>(x, w, b, y, mu, rs, n, d, eps, stream);
    } else {
      launch_warp<__half>(x, w, b, y, mu, rs, n, d, eps, stream);
    }
  } else {
    layernorm_fwd_block_kernel<<<n, kBlockThreads, 0, stream>>>(
        x, w, b, y, mu, rs, d, eps, x_dtype, w_dtype, b_dtype, y_dtype);
  }
  return static_cast<int>(cudaGetLastError());
}
