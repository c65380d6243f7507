// Shared pieces of the flash-attention kernels (forward, backward dK/dV,
// backward dQ). Four sets:
//
// 1. The CUDA-core set (float32 arithmetic): tile geometry, global<->shared
//    tile copies for float32 and bfloat16, and the three 64x64x64
//    register-blocked tile products. It serves the bfloat16 head widths the
//    tensor-core kernels do not take.
// 2. The tensor-core set (bfloat16): 128-byte swizzled bfloat16 tiles
//    filled by 16-byte `cp.async` copies, `wgmma` shared-memory descriptors,
//    the `wgmma` instructions themselves, and the accumulator -> A-fragment
//    packing with its rounding to bfloat16.
// 3. The float32 set: float32 tiles filled by 16-byte `cp.async` copies
//    and the two register-patch products of the float32 forward, dK/dV and
//    dQ, for any split of a block's threads.
// 4. The wide float32 backward set (at the end of the file): the score
//    product split over a warp's lanes and the fold of its partial sums, for
//    dK/dV and dQ in float32 above width 128.
//
// Geometry of the CUDA-core set, the same in all three kernels. A block has
// 256 threads seen as a 16x16 grid (ty = tid / 16, tx = tid % 16). Every tile
// in shared memory is
// 64 rows by 64 floats with a row pitch of 68 floats: 68 keeps each row
// 16-byte aligned for float4 reads and spreads 16 consecutive rows over all
// 32 banks (68 mod 32 = 4, a float4 covers 4 banks, so 8 rows fill the banks
// and a 16-row float4 read costs the 2 wavefronts its 256 bytes need anyway).
// A thread owns a 4x4 patch of each 64x64 product, so one float4 from each
// operand feeds 16 multiply-adds.
//
// Head widths above 64 are walked in chunks of 64 columns; a width that is
// not a multiple of 64 is zero-filled up to the next chunk in shared memory
// (zeros add nothing to a dot product) and the fill is never stored.
//
// Arithmetic of the CUDA-core set is float32 for both input types: bfloat16
// tensors are widened on the way into shared memory and rounded on the way
// out; in between only P and dS are rounded to bfloat16 (`rounded_to_input`),
// where every bfloat16 kernel and the plain version round.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace rgie {

constexpr int kTile = 64;      // rows and columns of every tile
constexpr int kPitch = 68;     // floats per tile row in shared memory
constexpr int kThreads = 256;  // 16 x 16
constexpr int kTileFloats = kTile * kPitch;

// Strides, in elements, of a (batch, head, row, width) tensor whose width
// axis is contiguous.
struct Strides {
  long long b, h, n;
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  __nv_bfloat162 lo, hi;
  *reinterpret_cast<uint32_t*>(&lo) = raw.x;
  *reinterpret_cast<uint32_t*>(&hi) = raw.y;
  const float2 a = __bfloat1622float2(lo);
  const float2 b = __bfloat1622float2(hi);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  const __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<const uint32_t*>(&lo);
  raw.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}

// A float32 value as the second product takes it: rounded to the inputs'
// type (P and dS, as the TPU kernel's `p.astype(v.dtype)` and
// `ds.astype(k.dtype)`), which for float32 inputs is the identity.
template <typename T>
__device__ __forceinline__ float rounded_to_input(float x);
template <>
__device__ __forceinline__ float rounded_to_input<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ float rounded_to_input<__nv_bfloat16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// Copy rows [row0, row0 + 64) and columns [col0, col0 + 64) of a
// (n_rows, width) matrix (row stride `stride` elements) into a tile, widened
// to float32. Rows past n_rows and columns past `width` become zeros.
// `width` is a multiple of 4, so a float4 is either all inside or all outside.
template <typename T>
__device__ __forceinline__ void load_tile(float* tile, const T* base, long long stride,
                                          int row0, int n_rows, int col0, int width) {
  for (int idx = threadIdx.x; idx < kTile * (kTile / 4); idx += kThreads) {
    const int r = idx >> 4;
    const int c = (idx & 15) << 2;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < n_rows && col0 + c < width) {
      v = load4(base + (long long)(row0 + r) * stride + col0 + c);
    }
    *reinterpret_cast<float4*>(tile + r * kPitch + c) = v;
  }
}

// Write a thread's 4x4 patch (rows row0 + ty*4 + a, columns col0 + tx*4 ..
// +3) of a (n_rows, width) matrix, skipping what lies outside it.
template <typename T>
__device__ __forceinline__ void store_patch(T* base, long long stride, int row0, int n_rows,
                                            int col0, int width, const float (&acc)[4][4]) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int c = col0 + tx * 4;
  if (c >= width) return;
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = row0 + ty * 4 + a;
    if (r < n_rows) {
      store4(base + (long long)r * stride + c,
             make_float4(acc[a][0], acc[a][1], acc[a][2], acc[a][3]));
    }
  }
}

// acc[a][b] += sum_k A[ty*4 + a][k] * B[tx + 16*b][k]      (A . B^T)
__device__ __forceinline__ void mma_nt(float (&acc)[4][4], const float* A, const float* B) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const float* a_row = A + (ty * 4) * kPitch;
  const float* b_row = B + tx * kPitch;
#pragma unroll 4
  for (int k = 0; k < kTile; k += 4) {
    float4 a[4], b[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = *reinterpret_cast<const float4*>(a_row + i * kPitch + k);
      b[i] = *reinterpret_cast<const float4*>(b_row + i * 16 * kPitch + k);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][j] += a[i].x * b[j].x;
        acc[i][j] += a[i].y * b[j].y;
        acc[i][j] += a[i].z * b[j].z;
        acc[i][j] += a[i].w * b[j].w;
      }
    }
  }
}

// acc[a][c] += sum_j P[ty*4 + a][j] * V[j][tx*4 + c]       (P . V)
__device__ __forceinline__ void mma_nn(float (&acc)[4][4], const float* P, const float* V) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const float* p_row = P + (ty * 4) * kPitch;
  const float* v_col = V + tx * 4;
#pragma unroll 2
  for (int j = 0; j < kTile; j += 4) {
    float p[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float4 t = *reinterpret_cast<const float4*>(p_row + i * kPitch + j);
      p[i][0] = t.x; p[i][1] = t.y; p[i][2] = t.z; p[i][3] = t.w;
    }
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const float4 v = *reinterpret_cast<const float4*>(v_col + (j + jj) * kPitch);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        acc[i][0] += p[i][jj] * v.x;
        acc[i][1] += p[i][jj] * v.y;
        acc[i][2] += p[i][jj] * v.z;
        acc[i][3] += p[i][jj] * v.w;
      }
    }
  }
}

// acc[a][c] += sum_i P[i][ty*4 + a] * X[i][tx*4 + c]       (P^T . X)
__device__ __forceinline__ void mma_tn(float (&acc)[4][4], const float* P, const float* X) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const float* p_col = P + ty * 4;
  const float* x_col = X + tx * 4;
#pragma unroll 8
  for (int i = 0; i < kTile; ++i) {
    const float4 p = *reinterpret_cast<const float4*>(p_col + i * kPitch);
    const float4 x = *reinterpret_cast<const float4*>(x_col + i * kPitch);
    acc[0][0] += p.x * x.x; acc[0][1] += p.x * x.y; acc[0][2] += p.x * x.z; acc[0][3] += p.x * x.w;
    acc[1][0] += p.y * x.x; acc[1][1] += p.y * x.y; acc[1][2] += p.y * x.z; acc[1][3] += p.y * x.w;
    acc[2][0] += p.z * x.x; acc[2][1] += p.z * x.y; acc[2][2] += p.z * x.z; acc[2][3] += p.z * x.w;
    acc[3][0] += p.w * x.x; acc[3][1] += p.w * x.y; acc[3][2] += p.w * x.z; acc[3][3] += p.w * x.w;
  }
}

__device__ __forceinline__ void zero_patch(float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
  }
}

// Maximum / sum over the 16 threads (tx = 0..15) that share a row of a tile:
// they are 16 consecutive lanes of one warp.
__device__ __forceinline__ float row_max16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float row_sum16(float v) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Head widths are compiled as 1, 2 or 8 chunks of 64 columns (up to 64, 128
// and 512 wide). Returns 0 for a width the kernels do not take.
inline int chunks_for_width(int width) {
  if (width <= 0 || width % 4 != 0) return 0;
  if (width <= 64) return 1;
  if (width <= 128) return 2;
  if (width <= 512) return 8;
  return 0;
}

// ---------------------------------------------------------------------------
// The tensor-core set: bfloat16 operands, float32 sums, `wgmma` (sm_90a).
//
// A tile in shared memory is R rows of 64 bfloat16 (one 128-byte row per tile
// row, R a multiple of 8, the tile 1024-byte aligned), its 16-byte chunks
// swizzled: chunk c of row r is stored at chunk c ^ (r % 8). That is the
// 128-byte swizzle a `wgmma` descriptor names, and the same bytes serve two
// readings of the tile:
//   - K-major (the product sums over the tile's columns: Q K^T, K Q^T,
//     V dO^T): 8-row groups 1024 bytes apart (SBO); the next 16 columns are
//     32 bytes further (descriptor + 2);
//   - MN-major, `tnspB` (the product sums over the tile's rows: P V, P^T dO,
//     dS^T Q): the 64 columns are one swizzle atom, 8-row groups again 1024
//     bytes apart; the next 16 rows are 2048 bytes further (descriptor + 128).
// A head wider than 64 is held as several such tiles ("atoms") of 64 columns
// each; columns past the head width are zero-filled.
//
// A block is two warpgroups (256 threads) that multiply and a third that
// starts every copy: a warp that starts 16-byte copies faster than the L2
// cache serves them stalls on them, and the multiplying warps should not
// (`setmaxnreg` moves the third's spare registers to the other two). In a
// warpgroup, warp w owns rows
// 16 w .. 16 w + 15 of a 64-row accumulator; lane l holds, for every 8
// columns j, d[4 j + 0..1] = (row l / 4, columns 8 j + 2 (l % 4) + 0..1) and
// d[4 j + 2..3] = the same columns of row l / 4 + 8. Two neighbouring column
// groups of an accumulator, rounded to bfloat16 and packed in pairs, are
// exactly the A fragment of one 16-deep `wgmma` step: scores never leave the
// registers between the first and the second product.
// ---------------------------------------------------------------------------

typedef __nv_bfloat16 bf16;

constexpr int kTcThreads = 256;      // two warpgroups that multiply
constexpr int kCopyThreads = 128;    // and a third that copies for them
// Registers a thread: a block of 384 threads starts with 168 each; the
// copying warpgroup gives back all but 56 and the multiplying ones take 224
// ((168 - 56) * 128 = (224 - 168) * 256).
constexpr int kCopyRegisters = 56;
constexpr int kTcRegisters = 224;
constexpr int kAtom = 64;            // bfloat16 elements of one 128-byte tile row
constexpr int kRowBytes = 128;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// Byte offset of 16-byte chunk `chunk` (0..7) of row `row` in a swizzled tile.
__device__ __forceinline__ uint32_t swizzled_offset(int row, int chunk) {
  return (uint32_t)(row * kRowBytes + ((chunk ^ (row & 7)) << 4));
}

// 16-byte asynchronous copy global -> shared; with `valid` false nothing is
// read and the 16 bytes become zeros.
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, bool valid) {
  const int bytes = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_4(uint32_t dst, const void* src, bool valid) {
  const int bytes = valid ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst), "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's groups of copies are still on their
// way, then make the arrived ones visible to `wgmma`, which reads shared
// memory through the asynchronous proxy. A barrier follows.
template <int N>
__device__ __forceinline__ void cp_async_wait_and_publish() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Start the copy of rows [row0, row0 + rows) and columns [col0, col0 + 64) of
// a (n_rows, width) bfloat16 matrix into a swizzled tile, shared out over the
// `loaders` threads of which this one is number `loader`. Rows past n_rows
// and columns past `width` (a multiple of 8) become zeros.
__device__ __forceinline__ void load_tile_async(uint32_t tile, const bf16* base, long long stride,
                                                int row0, int n_rows, int rows, int col0,
                                                int width, int loader, int loaders) {
  for (int idx = loader; idx < rows * 8; idx += loaders) {
    const int r = idx >> 3, c = idx & 7;
    const bool valid = row0 + r < n_rows && col0 + c * 8 < width;
    const bf16* src = valid ? base + (long long)(row0 + r) * stride + col0 + c * 8 : base;
    cp_async_16(tile + swizzled_offset(r, c), src, valid);
  }
}

// The `wgmma` descriptor of a swizzled tile (or of a part of it that starts
// at a multiple of 8 rows): 128-byte swizzle, 8-row groups 1024 bytes apart.
// The leading offset is not read when the other dimension is one atom.
__device__ __forceinline__ uint64_t tile_descriptor(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFFu) >> 4) | ((uint64_t)1 << 16) | ((uint64_t)64 << 32) |
         ((uint64_t)1 << 62);
}
constexpr uint64_t kDescNextColumns16 = 2;   // K-major: 16 columns = 32 bytes
constexpr uint64_t kDescNextRows16 = 128;    // MN-major: 16 rows = 2048 bytes

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed groups of products are still running
// (groups finish in the order they were committed).
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Give back (`dec`) or take (`inc`) registers, a whole warpgroup at once.
template <int N>
__device__ __forceinline__ void registers_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void registers_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// 2^x on the special-function unit in one instruction (relative error 2^-22,
// results below 2^-126 become 0): the softmax needs no more, and `exp2f`
// costs four more instructions for the range it adds.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Keep the compiler from moving reads or writes of these registers across
// the asynchronous products that use them.
template <int N>
__device__ __forceinline__ void fence_registers(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The same for A fragments: placed after the wait, it keeps their registers
// from being reused while a product still reads them.
template <int S>
__device__ __forceinline__ void fence_fragments(uint32_t (&a)[S][4]) {
#pragma unroll
  for (int s = 0; s < S; ++s) {
#pragma unroll
    for (int i = 0; i < 4; ++i) asm volatile("" : "+r"(a[s][i])::"memory");
  }
}

#define RGIE_F8(d, o)                                                                     \
  "+f"(d[o + 0]), "+f"(d[o + 1]), "+f"(d[o + 2]), "+f"(d[o + 3]), "+f"(d[o + 4]),         \
      "+f"(d[o + 5]), "+f"(d[o + 6]), "+f"(d[o + 7])
#define RGIE_REGS_0_31                                                                    \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "                \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
#define RGIE_REGS_32_63                                                                   \
  "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "      \
  "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"

// d (64 x 128) = A (64 x 16, K-major tile) . B^T (128 x 16, K-major tile),
// added to d when `accumulate` is non-zero.
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64], uint64_t a, uint64_t b,
                                                    int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{" RGIE_REGS_0_31 ", " RGIE_REGS_32_63 "}, "
      "%64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : RGIE_F8(d, 0), RGIE_F8(d, 8), RGIE_F8(d, 16), RGIE_F8(d, 24), RGIE_F8(d, 32),
        RGIE_F8(d, 40), RGIE_F8(d, 48), RGIE_F8(d, 56)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64) = A (64 x 16, K-major tile) . B^T (64 x 16, K-major tile).
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32], uint64_t a, uint64_t b,
                                                   int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" RGIE_REGS_0_31 "}, "
      "%32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : RGIE_F8(d, 0), RGIE_F8(d, 8), RGIE_F8(d, 16), RGIE_F8(d, 24)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 32) = A (64 x 16, K-major tile) . B^T (32 x 16, K-major tile).
__device__ __forceinline__ void wgmma_m64n32k16_ss(float (&d)[16], uint64_t a, uint64_t b,
                                                   int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : RGIE_F8(d, 0), RGIE_F8(d, 8)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d (64 x 64) += A (64 x 16, a register fragment) . B (16 x 64, 16 rows of
// an MN-major tile).
__device__ __forceinline__ void wgmma_m64n64k16_rs_tb(float (&d)[32], const uint32_t (&a)[4],
                                                      uint64_t b) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{" RGIE_REGS_0_31 "}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : RGIE_F8(d, 0), RGIE_F8(d, 8), RGIE_F8(d, 16), RGIE_F8(d, 24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// Two float32 values rounded to bfloat16 (to nearest even), `lo` in the low
// half: the rounding of P and dS to the inputs' type before the second
// product, as the TPU kernel's `p.astype(v.dtype)` and `ds.astype(k.dtype)`.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Columns [16 s, 16 s + 16) of an accumulator as the A fragment of one
// 16-deep step.
template <int N>
__device__ __forceinline__ void pack_fragment(uint32_t (&a)[4], const float (&d)[N], int s) {
  a[0] = pack_bf16(d[8 * s + 0], d[8 * s + 1]);
  a[1] = pack_bf16(d[8 * s + 2], d[8 * s + 3]);
  a[2] = pack_bf16(d[8 * s + 4], d[8 * s + 5]);
  a[3] = pack_bf16(d[8 * s + 6], d[8 * s + 7]);
}

// Store a warpgroup's 64 x 64 accumulator, each thread's first row times
// `scale_lo` and its second (8 rows below) times `scale_hi`, as
// columns [col0, col0 + 64) of rows [row0, row0 + 64) of a (n_rows, width)
// bfloat16 matrix, skipping what lies outside it (`width` is even).
__device__ __forceinline__ void store_accumulator(bf16* base, long long stride, int row0,
                                                  int n_rows, int col0, int width,
                                                  const float (&d)[32], float scale_lo,
                                                  float scale_hi) {
  const int lane = threadIdx.x & 31, warp = (threadIdx.x >> 5) & 3;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = row0 + warp * 16 + (lane >> 2) + 8 * h;
    const float f = h ? scale_hi : scale_lo;
    if (r < n_rows) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = col0 + 8 * j + 2 * (lane & 3);
        if (c < width) {
          *reinterpret_cast<uint32_t*>(base + (long long)r * stride + c) =
              pack_bf16(d[4 * j + 2 * h] * f, d[4 * j + 2 * h + 1] * f);
        }
      }
    }
  }
}

// The tensor-core kernels take bfloat16 head widths that are multiples of 8
// up to 128: 1 or 2 atoms. Returns 0 for any other width.
inline int atoms_for_width(int width) {
  if (width <= 0 || width % 8 != 0 || width > 128) return 0;
  return width <= 64 ? 1 : 2;
}

// The forward's wide tensor-core kernel takes bfloat16 head widths above 128
// that are multiples of 64, up to 512, held as 4 (up to 256) or 8 atoms.
// Returns 0 for any other width.
inline int wide_atoms_for_width(int width) {
  if (width <= 128 || width % 64 != 0 || width > 512) return 0;
  return width <= 256 ? 4 : 8;
}

// ---------------------------------------------------------------------------
// The float32 set: the forward and dK/dV on the CUDA cores for float32
// inputs (`FFMA`, no tensor core: TF32 would drop 13 bits of each operand).
//
// What bounds a product on the CUDA cores is the path from shared memory to
// the registers: it delivers 32 four-byte values a cycle to a
// multiprocessor (a 16-byte `LDS.128` serves 8 threads a cycle, and a
// broadcast does not serve more), while the four schedulers start 128
// `FFMA` a cycle. A thread whose patch of a product is R x C sums loads
// (R + C) values for 4 R C multiply-adds per 4-deep step, so only patches
// of 8 x 8 and more (0.25 values a multiply-add) leave the `FFMA` the limit;
// the first CUDA-core kernels' 4 x 4 patches (0.5) run at half the rate.
// The float32 kernels therefore give each product 8 x 8 or 8 x 16 patches,
// handing the products of one tile to different warps where one thread
// could not hold two such patches (the registers, 255 a thread, are the
// other limit).
//
// Tiles are float32 in shared memory, 64 columns wide (or a whole head
// row), rows `pitch` floats apart, pitch % 32 == 4 for operands read along
// the columns, 8 or 16 for P and dS written by columns of a score patch, so
// that no access of a warp meets two addresses in one bank. Global -> shared
// copies are 16-byte `cp.async` (no register on the way, nothing to widen)
// into a ring of slots that one barrier per slot hands from the copies to
// the products.
// ---------------------------------------------------------------------------

constexpr int kF32Pitch = 68;    // floats a row of a 64-column operand tile

// Wait until at most N of this thread's groups of copies are still on their
// way. A barrier follows before any thread reads what arrived.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Start the copy of rows [row0, row0 + ROWS) and columns [col0, col0 + COLS)
// of a (n_rows, width) float32 matrix into a tile of PITCH floats a row at
// shared address `tile`, shared out over the block's 256 threads. Rows past
// n_rows and columns past `width` (a multiple of 4) become zeros.
template <int ROWS, int PITCH, int COLS = 64>
__device__ __forceinline__ void copy_tile_f32(uint32_t tile, const float* base, long long stride,
                                              int row0, int n_rows, int col0, int width) {
  static_assert(ROWS * COLS % (4 * kThreads) == 0, "whole 16-byte copies a thread");
#pragma unroll
  for (int step = 0; step < ROWS * COLS / (4 * kThreads); ++step) {
    const unsigned idx = threadIdx.x + step * kThreads;   // unsigned: / and % are shifts
    const int r = idx / (COLS / 4), c = (idx % (COLS / 4)) * 4;
    const bool valid = row0 + r < n_rows && col0 + c < width;
    const float* src = valid ? base + (long long)(row0 + r) * stride + col0 + c : base;
    cp_async_16(tile + (uint32_t)(r * PITCH + c) * 4u, src, valid);
  }
}

// Thread t of a group of RS * TX threads, seen as RS x TX (ty = t / TX,
// tx = t % TX), adds to its R x C patch
//   acc[i][j] += sum over DEPTH columns k of A[ty + RS i][k] B[tx + TX j][k].
template <int R, int C, int AP, int BP, int TX, int RS, int DEPTH = 64>
__device__ __forceinline__ void product_nt(float (&acc)[R][C], const float* A, const float* B,
                                           int t) {
  const float* a_rows = A + (t / TX) * AP;
  const float* b_rows = B + (t % TX) * BP;
#pragma unroll 2
  for (int k = 0; k < DEPTH; k += 4) {
    float4 a[R];
#pragma unroll
    for (int i = 0; i < R; ++i) a[i] = *reinterpret_cast<const float4*>(a_rows + RS * i * AP + k);
#pragma unroll
    for (int j = 0; j < C; ++j) {
      const float4 b = *reinterpret_cast<const float4*>(b_rows + TX * j * BP + k);
#pragma unroll
      for (int i = 0; i < R; ++i) {
        acc[i][j] = fmaf(a[i].x, b.x, acc[i][j]);
        acc[i][j] = fmaf(a[i].y, b.y, acc[i][j]);
        acc[i][j] = fmaf(a[i].z, b.z, acc[i][j]);
        acc[i][j] = fmaf(a[i].w, b.w, acc[i][j]);
      }
    }
  }
}

// The same thread adds to its R x W patch (W / 4 groups of 4 columns, 4 TX
// apart)
//   acc[i][4 e + c] += sum over j < DEPTH of A[ty + RS i][j] X[j][4 tx + 4 TX e + c].
template <int R, int W, int DEPTH, int AP, int XP, int TX, int RS>
__device__ __forceinline__ void product_nn(float (&acc)[R][W], const float* A, const float* X,
                                           int t) {
  const float* a_rows = A + (t / TX) * AP;
  const float* x_cols = X + 4 * (t % TX);
#pragma unroll 2
  for (int j = 0; j < DEPTH; j += 4) {
    float4 a[R];
#pragma unroll
    for (int i = 0; i < R; ++i) a[i] = *reinterpret_cast<const float4*>(a_rows + RS * i * AP + j);
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
      for (int e = 0; e < W / 4; ++e) {
        const float4 x = *reinterpret_cast<const float4*>(x_cols + (j + jj) * XP + 4 * TX * e);
#pragma unroll
        for (int i = 0; i < R; ++i) {
          const float p = jj == 0 ? a[i].x : jj == 1 ? a[i].y : jj == 2 ? a[i].z : a[i].w;
          acc[i][4 * e + 0] = fmaf(p, x.x, acc[i][4 * e + 0]);
          acc[i][4 * e + 1] = fmaf(p, x.y, acc[i][4 * e + 1]);
          acc[i][4 * e + 2] = fmaf(p, x.z, acc[i][4 * e + 2]);
          acc[i][4 * e + 3] = fmaf(p, x.w, acc[i][4 * e + 3]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// The wide float32 backward: dK/dV and dQ for float32 head widths above 128.
//
// Whole head rows sit in shared memory, 128 * NGROUP floats a row (NGROUP =
// 2 up to width 256, 4 up to 512; columns past the width zero-filled). A
// score tile there is 32 x 8 (32 resident rows against 8 streamed ones):
// 256 scores of each of the two score products against a depth of up to
// 512, too few for an 8 x 8 register patch a thread. So each warp computes
// one 8 x 8 patch over the whole width, its 32 lanes splitting the depth
// (lane l takes columns 128 m + 4 l .. + 3), and the lanes' 64 partial sums
// are then folded: five rounds of `shfl.xor`, each halving the entries a
// lane holds, leave lane l the sums of entries 2 l and 2 l + 1 (row l / 4,
// columns 2 (l % 4) and 2 (l % 4) + 1 of the patch). Every read of the
// product is a whole 512-byte row segment for the warp (no bank conflict),
// and a 4-deep step reads 16 float4 for 256 multiply-adds (the 0.25 values a
// multiply-add of an 8 x 8 patch). The fold is 62 shuffles and 62 additions
// a lane for 1024 multiply-adds at width 512, in a fixed order.
// ---------------------------------------------------------------------------

// Head widths above 128, multiples of 4, up to 512: 2 (up to 256) or 4
// groups of 128 columns. Returns 0 for any other width.
inline int wide_groups_for_width(int width) {
  if (width <= 128 || width % 4 != 0 || width > 512) return 0;
  return width <= 256 ? 2 : 4;
}

// Named barriers 1..15 for a part of the block (`threads` a multiple of 32):
// `barrier_arrive` signals and goes on, `barrier_sync` waits for the count.
// What a thread wrote to shared memory before it arrived is visible to the
// threads that waited.
__device__ __forceinline__ void barrier_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void barrier_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// VEC consecutive floats (16- or 8-byte aligned) of shared memory into
// registers. The float2 read is written out as `ld.shared.v2`, so that the
// compiler keeps the reads as the loop orders them instead of merging
// neighbouring pairs into float4 reads first (ptxas may still pair them).
template <int VEC>
__device__ __forceinline__ void load_vec(float (&r)[VEC], const float* p) {
  if constexpr (VEC == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    r[0] = t.x; r[1] = t.y; r[2] = t.z; r[3] = t.w;
  } else {
    asm volatile("ld.shared.v2.f32 {%0, %1}, [%2];\n"
                 : "=f"(r[0]), "=f"(r[1])
                 : "r"(smem_addr(p))
                 : "memory");
  }
}

// The 8 rows of a warp's resident operand of the score product, as lane
// `lane` reads them in `lane_scores`: row i of A at base[i >> (3 - XOR_BITS)]
// + (i % (8 >> XOR_BITS)) AP, each base already at the lane's columns. With
// XOR_BITS > 0 the lane takes the rows in its own order, i ^ x with x the top
// XOR_BITS bits of the 3-bit (lane / 4) % 8: then the first XOR_BITS rounds
// of `fold_lanes<XOR_BITS>` need no select (each lane's entries already sit
// where it keeps them), for 2^XOR_BITS base addresses held across the loop.
template <int XOR_BITS>
struct LaneRows {
  const float* base[1 << XOR_BITS];
};

template <int XOR_BITS, int AP>
__device__ __forceinline__ LaneRows<XOR_BITS> lane_rows(const float* A, int lane) {
  constexpr int kShift = 3 - XOR_BITS;
  const int x = ((lane >> 2) & 7) >> kShift;
  LaneRows<XOR_BITS> rows;
#pragma unroll
  for (int g = 0; g < (1 << XOR_BITS); ++g) rows.base[g] = A + 4 * lane + ((g ^ x) << kShift) * AP;
  return rows;
}

// This lane's share of the 8 x 8 product A B^T over the head width:
//   v[8 i + j] = sum over m < NGROUP, c < 4 of
//                A'[i][128 m + 4 lane + c] B[j][128 m + 4 lane + c],
// A' the rows of A in the lane's order (`lane_rows`), rows AP and BP floats
// apart, each sum in the order m, c. The operands are read VEC (4 or 2)
// floats at a time; the loop over m is unrolled M_UNROLL times.
template <int NGROUP, int AP, int BP, int VEC, int M_UNROLL, int XOR_BITS>
__device__ __forceinline__ void lane_scores(float (&v)[64], const LaneRows<XOR_BITS>& rows,
                                            const float* B, int lane) {
  static_assert(VEC == 4 || VEC == 2, "float4 or float2 reads");
  constexpr int kShift = 3 - XOR_BITS;
#pragma unroll
  for (int i = 0; i < 64; ++i) v[i] = 0.f;
  const float* b_col = B + 4 * lane;
#pragma unroll M_UNROLL
  for (int m = 0; m < NGROUP; ++m) {
#pragma unroll
    for (int c0 = 0; c0 < 4; c0 += VEC) {
      float a[8][VEC];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        load_vec<VEC>(a[i], rows.base[i >> kShift] + (i & ((1 << kShift) - 1)) * AP + 128 * m + c0);
      }
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float b[VEC];
        load_vec<VEC>(b, b_col + j * BP + 128 * m + c0);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
#pragma unroll
          for (int c = 0; c < VEC; ++c) v[8 * i + j] = fmaf(a[i][c], b[c], v[8 * i + j]);
        }
      }
    }
  }
}

// One round of `fold_lanes`: the lanes whose bit HALF / 2 is clear keep
// entries [0, HALF), the others [HALF, 2 HALF) (moved down to [0, HALF)),
// and each adds its partner's copy of the half it keeps. With ORDERED the
// lane's entries are already in its own order (`lane_rows`): every lane
// keeps [0, HALF), and no select is needed.
template <int HALF, bool ORDERED>
__device__ __forceinline__ void fold_round(float (&v)[64], int lane) {
  const bool upper = !ORDERED && (lane & (HALF / 2));
#pragma unroll
  for (int i = 0; i < HALF; ++i) {
    const float send = upper ? v[i] : v[i + HALF];
    const float keep = upper ? v[i + HALF] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, HALF / 2);
  }
}

// Sum v over the warp's 32 lanes, leaving lane l the sums of entries 2 l and
// 2 l + 1 (row l / 4, columns 2 (l % 4) + 0, 1 of the 8 x 8 patch) in v[0]
// and v[1]. Each round is its own instantiation, so that every index is a
// constant and v stays in registers. XOR_BITS as in `lane_rows`.
template <int XOR_BITS>
__device__ __forceinline__ void fold_lanes(float (&v)[64], int lane) {
  fold_round<32, (XOR_BITS > 0)>(v, lane);
  fold_round<16, (XOR_BITS > 1)>(v, lane);
  fold_round<8, (XOR_BITS > 2)>(v, lane);
  fold_round<4, false>(v, lane);
  fold_round<2, false>(v, lane);
}

}  // namespace rgie
