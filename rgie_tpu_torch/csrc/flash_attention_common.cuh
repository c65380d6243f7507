// Shared pieces of the flash-attention kernels (forward, backward dK/dV,
// backward dQ): tile geometry, global<->shared tile copies for float32 and
// bfloat16, and the three 64x64x64 register-blocked tile products.
//
// Geometry, the same in all three kernels. A block has 256 threads seen as a
// 16x16 grid (ty = tid / 16, tx = tid % 16). Every tile in shared memory is
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
// Arithmetic is float32 on the CUDA cores for both input types: bfloat16
// tensors are widened on the way into shared memory and rounded once on the
// way out.

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

}  // namespace rgie
