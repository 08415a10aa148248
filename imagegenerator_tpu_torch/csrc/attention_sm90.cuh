// Hopper (sm_90a) machinery of the wgmma attention kernels
// (attention_fwd.cu, attention_bwd.cu, bf16 with head dim 32, 64 or 128):
// mbarriers, TMA tile loads through tensor maps, wgmma descriptors and
// the wgmma products m64nNk16 for N = 32, 64, 128.
//
// A tile of R rows of one head's (T, d) slice lands in shared memory as
// TMA writes it: in column blocks of kCB = min(d, 64) bf16 (64 or 128
// bytes a row), each block R rows one after the other, with the hardware
// swizzle of that row width (the 16-byte piece c of row r at piece
// c ^ (r % 8) for 128-byte rows, c ^ ((r / 2) % 4) for 64-byte rows).
// Every tile starts on a 1024-byte boundary, so the swizzle's phase is
// that of the row. A wgmma descriptor names such a tile either
//   K-major (the contraction runs along d: Q, K, dO, V as the A or B of
//   Q K^T, dO V^T, K Q^T, V dO^T): 8-row groups 8 x row bytes apart (SBO),
//   the k-th step of 16 over d at byte 32 (k mod kCB / 16) of column
//   block 16 k / kCB; or
//   MN-major (the contraction runs along the rows: V in P V, K in ds K,
//   dO and Q in pd^T dO and ds^T Q), read through the transpose bit: the
//   k-th step of 16 rows at 16 k rows, 8-row groups SBO apart, column
//   blocks LBO = R x row bytes apart.
//
// The tensor maps are 3-D over the packed-head (B, T, H) tensor, (H, T, B)
// innermost first, so a box that runs past T is zero-filled and never
// reads the next batch row. The host encodes them per call from the
// pointers it is given (cuTensorMapEncodeTiled, reached through the
// runtime's driver entry point, so nothing links libcuda).
//
// wgmma fragments: the f32 accumulator of m64nNk16 gives warp w of the
// warpgroup rows 16 w .. 16 w + 15, each 8-column chunk j laid out as an
// mma.sync m16n8 C tile (d[j][0..1] row g, columns 8 j + 2 t, + 1;
// d[j][2..3] row g + 8), and the register A operand is mma.sync's
// m16n8k16 A fragment of the warp's 16 rows. So the score tiles, the
// softmax helpers and the repacking of attention_mma.cuh apply to the
// accumulators as they are.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include "attention_mma.cuh"

namespace attn {
namespace sm90 {

using mma::bf16;
using mma::smem_addr;

// ------------------------------------------------------------ mbarriers

__device__ __forceinline__ void bar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count) : "memory");
}

// Makes the initialised barriers visible to the async proxy (TMA).
__device__ __forceinline__ void bar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void bar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}

// Arrive, and expect `bytes` more from TMA before the phase completes.
__device__ __forceinline__ void bar_arrive_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes)
               : "memory");
}

// Expect `bytes` more from TMA before the phase completes (no arrival).
__device__ __forceinline__ void bar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// One arrival for the calling warp, once all its lanes are here: what
// each lane wrote or read before the call is ordered before it (the
// warp's barrier), and the arrival releases it to whoever waits on bar.
__device__ __forceinline__ void bar_arrive_warp(uint64_t* bar) {
  __syncwarp();
  if ((threadIdx.x & 31) == 0) bar_arrive(bar);
}

// Waits until the phase of parity `parity` has completed.
__device__ __forceinline__ void bar_wait(uint64_t* bar, unsigned parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  }
}

// Named barriers between the two consumer warpgroups (ids 1 and 2; 0 is
// __syncthreads'): a warpgroup waits at its own before it issues its
// score products and lets the other one go once they are done (and,
// where the kernel says so, its exp too), so the two take turns on the
// tensor cores and the special-function unit, and one's exp and hash run
// while the other's products do.
__device__ __forceinline__ void turn_wait(int wg) {
  asm volatile("bar.sync %0, 256;\n" ::"r"(1 + wg) : "memory");
}
__device__ __forceinline__ void turn_pass(int wg) {
  asm volatile("bar.arrive %0, 256;\n" ::"r"(2 - wg) : "memory");
}

// ------------------------------------------------------------------ TMA

// The box at (column c0, row c1, batch row c2) of `map` into dst; its
// bytes count towards bar's expected transaction.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1,
                                         int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// -------------------------------------------------------------- layouts

template <int kD>
struct Layout {
  static_assert(kD == 32 || kD == 64 || kD == 128, "the wgmma kernels take d = 32, 64, 128");
  static constexpr int kCB = kD < 64 ? kD : 64;  // bf16 a row of a column block
  static constexpr int kBlocks = kD / kCB;
  static constexpr int kRowBytes = 2 * kCB;     // 64 or 128
  // the descriptor's layout type: 1 = 128-byte swizzle, 2 = 64-byte
  static constexpr uint64_t kMode = kRowBytes == 128 ? 1 : 2;

  template <int kRows>
  static constexpr int tile_bytes() {
    return kRows * 2 * kD;
  }

  static __device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
    return (uint64_t)((addr & 0x3FFFF) >> 4) | (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
           (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | kMode << 62;
  }

  // K-major: step k (16 columns of d) of the rows starting at `rows`, a
  // tile whose column blocks are kRows rows long.
  template <int kRows>
  static __device__ __forceinline__ uint64_t kmajor(uint32_t rows, int k) {
    const int col = 16 * k;
    return desc(rows + (col / kCB) * kRows * kRowBytes + 2 * (col % kCB), 16, 8 * kRowBytes);
  }

  // MN-major: step k (16 rows) of a tile of kRows rows, all d columns.
  template <int kRows>
  static __device__ __forceinline__ uint64_t mnmajor(uint32_t tile, int k) {
    return desc(tile + 16 * k * kRowBytes, kRows * kRowBytes, 8 * kRowBytes);
  }

  // The kRows-row box at `row` of a (B, T, H) tensor's head into dst, all
  // its column blocks.
  template <int kRows>
  static __device__ __forceinline__ void load(unsigned char* dst, const CUtensorMap* map, uint64_t* bar,
                                              int head, int row, int b) {
#pragma unroll
    for (int cb = 0; cb < kBlocks; ++cb)
      tma_load(dst + cb * kRows * kRowBytes, map, bar, head * kD + cb * kCB, row, b);
  }
};

// Hands registers between the warpgroups of a block (setmaxnreg): the
// producer gives its back, the consumers take them, so that a block of
// three warpgroups, launched at 168 registers a thread, runs its
// consumers at 232. All four warps of a warpgroup execute it.
template <int kRegs>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}
template <int kRegs>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}
constexpr int kProducerRegs = 40;
constexpr int kConsumerRegs = 232;

// --------------------------------------------------------------- wgmma

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int kPending>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// Ties registers to the point of the call, so that the compiler moves no
// read of an accumulator above the wait that makes it valid, and no write
// of an operand below the product that reads it.
template <int kN>
__device__ __forceinline__ void fence_regs(float (&d)[kN][4]) {
#pragma unroll
  for (int j = 0; j < kN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[j][e])::"memory");
}

template <int kN>
__device__ __forceinline__ void fence_regs(uint32_t (&a)[kN][4]) {
#pragma unroll
  for (int j = 0; j < kN; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+r"(a[j][e])::"memory");
}

template <int kN>
__device__ __forceinline__ void zero(float (&d)[kN][4]) {
#pragma unroll
  for (int j = 0; j < kN; ++j) d[j][0] = d[j][1] = d[j][2] = d[j][3] = 0.f;
}

// wgmma.mma_async m64nNk16, f32 += bf16 x bf16. ss: A (64 x 16) and B
// (16 x N) K-major in shared memory, D = A B + (scale_d ? D : 0). rs: A
// from registers, B MN-major in shared memory (the transpose bit).
template <int kN>
struct Wgmma;

template <>
struct Wgmma<32> {
  static __device__ __forceinline__ void ss(float (&d)[4][4], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
        : "l"(da), "l"(db), "r"(scale_d));
  }
  static __device__ __forceinline__ void rs(float (&d)[4][4], const uint32_t (&a)[4], uint64_t db,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};

template <>
struct Wgmma<64> {
  static __device__ __forceinline__ void ss(float (&d)[8][4], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
        : "l"(da), "l"(db), "r"(scale_d));
  }
  static __device__ __forceinline__ void rs(float (&d)[8][4], const uint32_t (&a)[4], uint64_t db,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};

template <>
struct Wgmma<128> {
  static __device__ __forceinline__ void ss(float (&d)[16][4], uint64_t da, uint64_t db, int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1, 0, 0;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]), "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]), "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]), "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]), "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]), "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]), "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]), "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]), "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
        : "l"(da), "l"(db), "r"(scale_d));
  }
  static __device__ __forceinline__ void rs(float (&d)[16][4], const uint32_t (&a)[4], uint64_t db,
                                            int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
        : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]), "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]), "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]), "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]), "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]), "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]), "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]), "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]), "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]), "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]), "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]), "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]), "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]), "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]), "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]), "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  }
};

// ------------------------------------------------------------- the host

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err =
        cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                                                     : nullptr;
  }();
  return fn;
}

// The map of a bf16 (B, T, H) tensor read in boxes of box_rows rows of
// one column block (box_cols = 32 or 64 bf16) with the swizzle of that
// row width. Returns a CUDA error code (0 on success).
inline int encode_map(CUtensorMap* map, const void* ptr, int batch, int seq, int hidden, int box_cols,
                      int box_rows) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[3] = {(cuuint64_t)hidden, (cuuint64_t)seq, (cuuint64_t)batch};
  const cuuint64_t strides[2] = {(cuuint64_t)hidden * 2, (cuuint64_t)seq * hidden * 2};
  const cuuint32_t box[3] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows, 1};
  const cuuint32_t steps[3] = {1, 1, 1};
  const CUresult r =
      fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims, strides, box, steps,
         CU_TENSOR_MAP_INTERLEAVE_NONE, box_cols * 2 == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
         CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

// The column kinds of a key tile, as the consumers read them: for each
// t = 0..3 the Columns of the thread's keys 8 j + 2 t + e (bit 2 j + e),
// a masked bit and a padding bit. The producer warp builds them from its
// lanes' kinds of the kN keys (lane l holds key 32 c + l in kinds[c]: 1
// kept, 0 masked, -1 past T) by ballots, and lanes 0..3 write the four
// pairs; a consumer reads its pair with one load.
template <int kN>
__device__ __forceinline__ void write_tile_bits(mma::Columns* bits, const int (&kinds)[kN / 32], int lane) {
  unsigned masked = 0, pad = 0;
#pragma unroll
  for (int c = 0; c < kN / 32; ++c) {
    const unsigned mb = __ballot_sync(0xffffffffu, kinds[c] == 0);
    const unsigned pb = __ballot_sync(0xffffffffu, kinds[c] < 0);
    // the keys 32 c + 8 q + 2 t + e (q = 0..3) of lane t's columns: bits
    // 8 q + 2 t + e of the ballot, to bits 8 c + 2 q + e
    const int t = lane & 3;
    const unsigned vm = (mb >> (2 * t)) & 0x03030303u;
    const unsigned vp = (pb >> (2 * t)) & 0x03030303u;
    masked |= ((vm & 3u) | ((vm >> 6) & 0xCu) | ((vm >> 12) & 0x30u) | ((vm >> 18) & 0xC0u)) << (8 * c);
    pad |= ((vp & 3u) | ((vp >> 6) & 0xCu) | ((vp >> 12) & 0x30u) | ((vp >> 18) & 0xC0u)) << (8 * c);
  }
  if (lane < 4) bits[lane] = mma::Columns{masked, pad};
}

__device__ __forceinline__ mma::Columns read_tile_bits(const mma::Columns* bits, int lane) {
  return bits[lane & 3];
}

// The row max of tile_row_max (the same values). Where none of the
// thread's columns is masked or past T it scales the max of the raw
// scores (rounding is monotonic), folded as a tree so that its compares
// do not wait on each other; where all are masked it is -3e7.
template <int kN>
__device__ __forceinline__ void tile_row_max(const float (&s)[kN / 8][4], const mma::Columns& cols, float scale,
                                             float& m0, float& m1) {
  constexpr unsigned kAll = kN >= 128 ? 0xffffffffu : (1u << (kN / 4)) - 1u;
  if (cols.masked == kAll && !cols.pad) {  // every column -3e7
    m0 = fmaxf(m0, kBigNeg);
    m1 = fmaxf(m1, kBigNeg);
    return;
  }
  if (cols.masked | cols.pad) {
    mma::tile_row_max<kN>(s, cols, scale, m0, m1);
    return;
  }
  float a[kN / 8], b[kN / 8];
#pragma unroll
  for (int j = 0; j < kN / 8; ++j) {
    a[j] = fmaxf(s[j][0], s[j][1]);
    b[j] = fmaxf(s[j][2], s[j][3]);
  }
#pragma unroll
  for (int w = 1; w < kN / 8; w *= 2)
#pragma unroll
    for (int j = 0; j + w < kN / 8; j += 2 * w) {
      a[j] = fmaxf(a[j], a[j + w]);
      b[j] = fmaxf(b[j], b[j + w]);
    }
  m0 = fmaxf(m0, a[0] * scale);
  m1 = fmaxf(m1, b[0] * scale);
}

// tile_exp (the same values), with one more shortcut: a tile whose keys
// are all masked for the thread's columns (the tail of a short row) gives
// every column the masked value exp(-3e7 - m) of its row, computed once.
template <int kN>
__device__ __forceinline__ void tile_exp(float (&s)[kN / 8][4], const mma::Columns& cols, float sl2e, float ml0,
                                         float ml1, float mb0, float mb1) {
  constexpr unsigned kAll = kN >= 128 ? 0xffffffffu : (1u << (kN / 4)) - 1u;
  if (cols.masked == kAll && !cols.pad) {
    const float p0 = mma::ex2(mb0), p1 = mma::ex2(mb1);
#pragma unroll
    for (int j = 0; j < kN / 8; ++j) {
      s[j][0] = s[j][1] = p0;
      s[j][2] = s[j][3] = p1;
    }
    return;
  }
  mma::tile_exp<kN>(s, cols, sl2e, ml0, ml1, mb0, mb1);
}

// acc / l for the rows g (l0) and g + 8 (l1) of accumulator fragments:
// one division a row for r = 1 / l, then for each element q = acc r and
// the correction q + (acc - q l) r, the residual exact in a fused
// multiply-add (Markstein's step: from the rounded reciprocal it gives
// the rounded quotient, what acc / l gives, at three operations in place
// of a division's dozen).
template <int kN>
__device__ __forceinline__ void divide_rows(float (&acc)[kN][4], float l0, float l1) {
  const float r0 = 1.f / l0, r1 = 1.f / l1;
#pragma unroll
  for (int j = 0; j < kN; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const float l = e < 2 ? l0 : l1, r = e < 2 ? r0 : r1;
      const float q = acc[j][e] * r;
      acc[j][e] = fmaf(fmaf(-q, l, acc[j][e]), r, q);
    }
  }
}

// A unit of work of the persistent kernels: one (batch row, head, tile of
// 128 rows). Unit u has its row tile fastest, so the blocks that run at
// one time share their heads' K and V (or Q and dO) in L2.
struct Unit {
  int tile, head, b;
  __device__ __forceinline__ Unit(int u, int tiles, int heads)
      : tile(u % tiles), head(u / tiles % heads), b(u / tiles / heads) {}
};

// Blocks of a persistent kernel: one a SM, or one a unit where there are
// fewer units.
inline int persistent_blocks(int units) {
  int device = 0, sms = 0;
  if (cudaGetDevice(&device) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device) != cudaSuccess || sms <= 0)
    sms = 132;
  return units < sms ? units : sms;
}

// The first 1024-byte boundary at or after p (the swizzle's unit).
__device__ __forceinline__ unsigned char* align1024(unsigned char* p) {
  return reinterpret_cast<unsigned char*>((reinterpret_cast<uintptr_t>(p) + 1023) & ~uintptr_t(1023));
}

}  // namespace sm90
}  // namespace attn
