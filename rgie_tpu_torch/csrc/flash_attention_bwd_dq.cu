// Flash attention, backward for queries:
//   P = exp(Q K^T * scale - lse),  dS = P * (dO V^T - di) * scale,  dQ = dS K,
// with di = rowsum(O * dO) computed by the caller.
//
// Replaces the TPU kernel `_flash_attention_bwd_dq`
// (jax/experimental/pallas/ops/tpu/flash_attention.py, `pl.pallas_call` at
// :1456).
//
// Bound on this card: operations (6 N^2 d flops per (batch, head) against
// 5 N d elements moved), in float32 on the CUDA cores. What the design does
// about it: one block owns 64 query rows and walks the key tiles, so each dQ
// element is summed by one thread in a fixed order (no atomics); Q and dO
// stay resident in shared memory at width 64 and the scores never leave the
// chip. A head wider than 64 is walked in 64-column chunks as in the forward
// kernel: the scores are summed over the chunks once, and the block keeps one
// 4x4 patch of dQ per chunk in registers (128 at width 512), so no product is
// repeated; the price is that Q, dO, K and V are reloaded chunk by chunk.
// dS is rounded to the inputs' type before dS K (the TPU kernel's
// `ds.astype(k.dtype)`; the identity for float32). bfloat16 inputs still take
// this kernel at every width: its tensor-core version is the next step, on
// the helpers the forward and dK/dV kernels share in the header.

#include "flash_attention_common.cuh"

namespace rgie {

template <typename T, int NCHUNK>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ d_o, const float* __restrict__ lse,
                    const float* __restrict__ di, T* __restrict__ dq, int heads, int n,
                    int width, Strides sq, Strides sk, Strides sv, Strides sdo, Strides sdq,
                    float scale) {
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* dOs = Qs + kTileFloats;
  float* Ks = dOs + kTileFloats;
  float* Vs = Ks + kTileFloats;
  float* dSs = Vs + kTileFloats;

  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int q0 = blockIdx.x * kTile;
  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  const T* dob = d_o + b * sdo.b + h * sdo.h;

  float row_lse[4], row_di[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int r = q0 + ty * 4 + a;
    row_lse[a] = r < n ? lse[(long long)bh * n + r] : 0.f;
    row_di[a] = r < n ? di[(long long)bh * n + r] : 0.f;
  }

  float acc[NCHUNK][4][4];
#pragma unroll
  for (int c = 0; c < NCHUNK; ++c) zero_patch(acc[c]);

  const int n_tiles = (n + kTile - 1) / kTile;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kTile;

    float s[4][4], dp[4][4];
    zero_patch(s);
    zero_patch(dp);
#pragma unroll
    for (int c = 0; c < NCHUNK; ++c) {
      if (c * kTile < width) {
        __syncthreads();
        if (NCHUNK > 1 || kt == 0) {
          load_tile(Qs, qb, sq.n, q0, n, c * kTile, width);
          load_tile(dOs, dob, sdo.n, q0, n, c * kTile, width);
        }
        load_tile(Ks, kb, sk.n, k0, n, c * kTile, width);
        load_tile(Vs, vb, sv.n, k0, n, c * kTile, width);
        __syncthreads();
        mma_nt(s, Qs, Ks);
        mma_nt(dp, dOs, Vs);
      }
    }

#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int row = ty * 4 + a;
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) {
        const bool inside = (q0 + row < n) && (k0 + tx + 16 * bb < n);
        const float p = inside ? expf(s[a][bb] * scale - row_lse[a]) : 0.f;
        dSs[row * kPitch + tx + 16 * bb] =
            rounded_to_input<T>(p * (dp[a][bb] - row_di[a]) * scale);
      }
    }

    // dQ += dS K, chunk by chunk. With one chunk, Ks already holds it.
#pragma unroll
    for (int c = 0; c < NCHUNK; ++c) {
      if (c * kTile < width) {
        if (NCHUNK > 1) {
          __syncthreads();
          load_tile(Ks, kb, sk.n, k0, n, c * kTile, width);
        }
        __syncthreads();
        mma_nn(acc[c], dSs, Ks);
      }
    }
  }

  T* dqb = dq + b * sdq.b + h * sdq.h;
#pragma unroll
  for (int c = 0; c < NCHUNK; ++c) {
    if (c * kTile < width) store_patch(dqb, sdq.n, q0, n, c * kTile, width, acc[c]);
  }
}

template <typename T, int NCHUNK>
int launch_dq(const void* q, const void* k, const void* v, const void* d_o, const float* lse,
              const float* di, void* dq, int batch, int heads, int n, int width,
              const long long* st, float scale, cudaStream_t stream) {
  const size_t smem = 5 * kTileFloats * sizeof(float);
  auto kernel = flash_bwd_dq_kernel<T, NCHUNK>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + kTile - 1) / kTile, batch * heads);
  kernel<<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)d_o, lse, di, (T*)dq, heads, n, width,
      Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]}, Strides{st[6], st[7], st[8]},
      Strides{st[9], st[10], st[11]}, Strides{st[12], st[13], st[14]}, scale);
  return (int)cudaGetLastError();
}

}  // namespace rgie

// q, k, v, d_o, dq: (batch, heads, n, width) with the width axis contiguous;
// `strides` holds (batch, head, row) strides in elements for them in that
// order (15 values). lse, di: (batch, heads, n) float32, contiguous. Returns
// cudaGetLastError() (0 on success), or -1 for a width or a grid the kernel
// does not take.
extern "C" int rgie_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                           const void* d_o, const float* lse, const float* di,
                                           void* dq, int batch, int heads, int n, int width,
                                           const long long* strides, float scale, int is_bf16,
                                           void* stream) {
  using namespace rgie;
  const int chunks = chunks_for_width(width);
  if (chunks == 0 || n <= 0 || batch * heads <= 0 || batch * heads > 65535) return -1;
  cudaStream_t s = (cudaStream_t)stream;
#define RGIE_DQ(T, C) \
  return launch_dq<T, C>(q, k, v, d_o, lse, di, dq, batch, heads, n, width, strides, scale, s)
  if (is_bf16) {
    if (chunks == 1) RGIE_DQ(__nv_bfloat16, 1);
    if (chunks == 2) RGIE_DQ(__nv_bfloat16, 2);
    RGIE_DQ(__nv_bfloat16, 8);
  }
  if (chunks == 1) RGIE_DQ(float, 1);
  if (chunks == 2) RGIE_DQ(float, 2);
  RGIE_DQ(float, 8);
#undef RGIE_DQ
}
