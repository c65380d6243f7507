// Flash attention, backward for keys and values:
//   P = exp(Q K^T * scale - lse),  dV = P^T dO,
//   dS = P * (dO V^T - di) * scale,  dK = dS^T Q,
// with di = rowsum(O * dO) computed by the caller.
//
// Replaces the TPU kernel `_flash_attention_bwd_dkv`
// (jax/experimental/pallas/ops/tpu/flash_attention.py, `pl.pallas_call` at
// :1121).
//
// Bound on this card: operations (8 N^2 d flops per (batch, head) against
// 6 N d elements moved), in float32 on the CUDA cores. What the design does
// about it: one block owns 64 key rows and walks the query tiles, so each
// dK and dV element is summed by one thread in a fixed order: no atomics,
// and the result is the same from run to run. Scores are recomputed from
// the saved log-sum-exp and live in registers and shared memory only.
//
// Head widths above 64 are walked in 64-column chunks, the scores summed
// over the chunks once and one 4x4 patch per chunk and output kept in
// registers. Up to width 128 a block holds both dK and dV (64 registers).
// At width 512 the two would take 256 registers a thread, so the work is
// split over grid.z by output: the blocks of z = 0 sum dV (they need P only,
// so they skip dO V^T), those of z = 1 sum dK. The Q K^T products are then
// done twice (40 tile products per pair of tiles against the 32 a single
// block would do), and nothing else is repeated. The edit never
// differentiates the VAE, so only width 64, where K and V stay resident in
// shared memory, is on its path.

#include "flash_attention_common.cuh"

namespace rgie {

// At width 64 two blocks share a multiprocessor (the second hides the
// first's barriers), which needs the kernel held to 128 registers a thread.
template <typename T, int NCHUNK>
__global__ void __launch_bounds__(kThreads, NCHUNK == 1 ? 2 : 1)
flash_bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                     const T* __restrict__ d_o, const float* __restrict__ lse,
                     const float* __restrict__ di, T* __restrict__ dk, T* __restrict__ dv,
                     int heads, int n, int width, Strides sq, Strides sk, Strides sv,
                     Strides sdo, Strides sdk, Strides sdv, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* dOs = Qs + kTileFloats;
  float* Ks = dOs + kTileFloats;
  float* Vs = Ks + kTileFloats;
  float* Ps = Vs + kTileFloats;
  float* dSs = Ps + kTileFloats;
  float* lse_s = dSs + kTileFloats;  // 64
  float* di_s = lse_s + kTile;       // 64

  // Which outputs this block sums, and where: with kSplit one accumulator
  // set serves the block's one output, else dV is set 0 and dK set 1.
  constexpr bool kSplit = NCHUNK > 2;
  constexpr int kSetDk = kSplit ? 0 : 1;
  const bool want_dv = !kSplit || blockIdx.z == 0;
  const bool want_dk = !kSplit || blockIdx.z == 1;

  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int k0 = blockIdx.x * kTile;
  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  const T* dob = d_o + b * sdo.b + h * sdo.h;
  const float* lse_b = lse + (long long)bh * n;
  const float* di_b = di + (long long)bh * n;

  float acc[kSetDk + 1][NCHUNK][4][4];
#pragma unroll
  for (int i = 0; i <= kSetDk; ++i) {
#pragma unroll
    for (int c = 0; c < NCHUNK; ++c) zero_patch(acc[i][c]);
  }

  const int n_tiles = (n + kTile - 1) / kTile;
  for (int qt = 0; qt < n_tiles; ++qt) {
    const int q0 = qt * kTile;

    // S = Q K^T and (for dK) dP = dO V^T over the chunks of the head width.
    // Patch entry [a][bb] is query q0 + ty*4 + a, key k0 + tx + 16*bb.
    float s[4][4], dp[4][4];
    zero_patch(s);
    zero_patch(dp);
#pragma unroll
    for (int c = 0; c < NCHUNK; ++c) {
      if (c * kTile < width) {
        __syncthreads();
        load_tile(Qs, qb, sq.n, q0, n, c * kTile, width);
        if (want_dk || NCHUNK == 1) load_tile(dOs, dob, sdo.n, q0, n, c * kTile, width);
        if (NCHUNK > 1 || qt == 0) {
          load_tile(Ks, kb, sk.n, k0, n, c * kTile, width);
          if (want_dk) load_tile(Vs, vb, sv.n, k0, n, c * kTile, width);
        }
        if (c == 0 && threadIdx.x < kTile) {
          const int r = q0 + threadIdx.x;
          lse_s[threadIdx.x] = r < n ? lse_b[r] : 0.f;
          di_s[threadIdx.x] = r < n ? di_b[r] : 0.f;
        }
        __syncthreads();
        mma_nt(s, Qs, Ks);
        if (want_dk) mma_nt(dp, dOs, Vs);
      }
    }

#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int row = ty * 4 + a;
      const float row_lse = lse_s[row], row_di = di_s[row];
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) {
        const bool inside = (q0 + row < n) && (k0 + tx + 16 * bb < n);
        const float p = inside ? expf(s[a][bb] * scale - row_lse) : 0.f;
        Ps[row * kPitch + tx + 16 * bb] = p;
        dSs[row * kPitch + tx + 16 * bb] = p * (dp[a][bb] - row_di) * scale;
      }
    }

    // dV += P^T dO and dK += dS^T Q, chunk by chunk. With one chunk, Qs and
    // dOs already hold it.
#pragma unroll
    for (int c = 0; c < NCHUNK; ++c) {
      if (c * kTile < width) {
        if (NCHUNK > 1) {
          __syncthreads();
          if (want_dk) load_tile(Qs, qb, sq.n, q0, n, c * kTile, width);
          if (want_dv) load_tile(dOs, dob, sdo.n, q0, n, c * kTile, width);
        }
        __syncthreads();
        if (want_dv) mma_tn(acc[0][c], Ps, dOs);
        if (want_dk) mma_tn(acc[kSetDk][c], dSs, Qs);
      }
    }
  }

  T* dkb = dk + b * sdk.b + h * sdk.h;
  T* dvb = dv + b * sdv.b + h * sdv.h;
#pragma unroll
  for (int c = 0; c < NCHUNK; ++c) {
    if (c * kTile < width) {
      if (want_dv) store_patch(dvb, sdv.n, k0, n, c * kTile, width, acc[0][c]);
      if (want_dk) store_patch(dkb, sdk.n, k0, n, c * kTile, width, acc[kSetDk][c]);
    }
  }
}

template <typename T, int NCHUNK>
int launch_dkv(const void* q, const void* k, const void* v, const void* d_o, const float* lse,
               const float* di, void* dk, void* dv, int batch, int heads, int n, int width,
               const long long* st, float scale, cudaStream_t stream) {
  const size_t smem = (6 * kTileFloats + 2 * kTile) * sizeof(float);
  auto kernel = flash_bwd_dkv_kernel<T, NCHUNK>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + kTile - 1) / kTile, batch * heads, NCHUNK > 2 ? 2 : 1);
  kernel<<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)d_o, lse, di, (T*)dk, (T*)dv, heads, n,
      width, Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
      Strides{st[6], st[7], st[8]}, Strides{st[9], st[10], st[11]},
      Strides{st[12], st[13], st[14]}, Strides{st[15], st[16], st[17]}, scale);
  return (int)cudaGetLastError();
}

}  // namespace rgie

// q, k, v, d_o, dk, dv: (batch, heads, n, width) with the width axis
// contiguous; `strides` holds (batch, head, row) strides in elements for
// them in that order (18 values). lse, di: (batch, heads, n) float32,
// contiguous. Returns cudaGetLastError() (0 on success), or -1 for a width
// or a grid the kernel does not take.
extern "C" int rgie_flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                            const void* d_o, const float* lse, const float* di,
                                            void* dk, void* dv, int batch, int heads, int n,
                                            int width, const long long* strides, float scale,
                                            int is_bf16, void* stream) {
  using namespace rgie;
  const int chunks = chunks_for_width(width);
  if (chunks == 0 || n <= 0 || batch * heads <= 0 || batch * heads > 65535) return -1;
  cudaStream_t s = (cudaStream_t)stream;
#define RGIE_DKV(T, C)                                                                        \
  return launch_dkv<T, C>(q, k, v, d_o, lse, di, dk, dv, batch, heads, n, width, strides, scale, \
                          s)
  if (is_bf16) {
    if (chunks == 1) RGIE_DKV(__nv_bfloat16, 1);
    if (chunks == 2) RGIE_DKV(__nv_bfloat16, 2);
    RGIE_DKV(__nv_bfloat16, 8);
  }
  if (chunks == 1) RGIE_DKV(float, 1);
  if (chunks == 2) RGIE_DKV(float, 2);
  RGIE_DKV(float, 8);
#undef RGIE_DKV
}
