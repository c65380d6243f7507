// Flash attention, forward: O = softmax(Q K^T * scale) V and the row
// log-sum-exp, without the N x N score matrix.
//
// Replaces the TPU kernel behind `flash_attention` ->
// `_flash_attention_impl` (jax/experimental/pallas/ops/tpu/flash_attention.py,
// `pl.pallas_call` at :758), which the JAX package reaches from the UNet's
// self-attention and the VAE's mid-block attention for sequences of 8192 and
// longer.
//
// Bound on this card: operations. The call does 4 N^2 d multiply-adds' worth
// of flops per (batch, head) and moves only 4 N d elements, so at N = 16384
// it sits far above the memory roofline; in float32 on the CUDA cores the
// limit is the card's float32 rate. What the design does about it: one block
// owns 64 query rows of one (batch, head) and walks the key tiles with the
// online softmax, so scores live in registers and shared memory only; each
// thread keeps a 4x4 patch of the score tile and a 4x4 patch per 64-column
// chunk of the output in registers, and every shared-memory read is a float4
// that feeds 16 multiply-adds. It does not use the tensor cores (float32
// inputs would lose their last 13 mantissa bits there) nor asynchronous
// copies: both are later work.
//
// One float32 log-sum-exp per row is written (the TPU kernel's separate `l`
// and `m` are a TPU layout choice). No mask, bias or segment ids.

#include "flash_attention_common.cuh"

namespace rgie {

template <typename T, int NCHUNK>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 T* __restrict__ o, float* __restrict__ lse, int heads, int n, int width,
                 Strides sq, Strides sk, Strides sv, Strides so, float scale) {
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ks = Qs + kTileFloats;
  float* Vs = Ks + kTileFloats;
  float* Ps = Vs + kTileFloats;

  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int q0 = blockIdx.x * kTile;
  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + h * sk.h;
  const T* vb = v + b * sv.b + h * sv.h;
  T* ob = o + b * so.b + h * so.h;

  float acc[NCHUNK][4][4];
#pragma unroll
  for (int c = 0; c < NCHUNK; ++c) zero_patch(acc[c]);
  float row_m[4], row_l[4];
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    row_m[a] = -INFINITY;
    row_l[a] = 0.f;
  }

  const int n_tiles = (n + kTile - 1) / kTile;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * kTile;

    // S = Q K^T over the chunks of the head width.
    float s[4][4];
    zero_patch(s);
#pragma unroll
    for (int c = 0; c < NCHUNK; ++c) {
      if (c * kTile < width) {
        __syncthreads();
        if (NCHUNK > 1 || kt == 0) load_tile(Qs, qb, sq.n, q0, n, c * kTile, width);
        load_tile(Ks, kb, sk.n, k0, n, c * kTile, width);
        __syncthreads();
        mma_nt(s, Qs, Ks);
      }
    }

    // Online softmax. s[a][bb] is row ty*4 + a, key k0 + tx + 16*bb.
    float alpha[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      float m = -INFINITY;
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) {
        s[a][bb] = (k0 + tx + 16 * bb < n) ? s[a][bb] * scale : -INFINITY;
        m = fmaxf(m, s[a][bb]);
      }
      const float m_new = fmaxf(row_m[a], row_max16(m));  // finite: key k0 exists
      float sum = 0.f;
#pragma unroll
      for (int bb = 0; bb < 4; ++bb) {
        const float p = expf(s[a][bb] - m_new);
        sum += p;
        Ps[(ty * 4 + a) * kPitch + tx + 16 * bb] = p;
      }
      alpha[a] = expf(row_m[a] - m_new);
      row_l[a] = row_l[a] * alpha[a] + row_sum16(sum);
      row_m[a] = m_new;
    }

    // O = O * alpha + P V, chunk by chunk.
#pragma unroll
    for (int c = 0; c < NCHUNK; ++c) {
      if (c * kTile < width) {
#pragma unroll
        for (int a = 0; a < 4; ++a) {
#pragma unroll
          for (int j = 0; j < 4; ++j) acc[c][a][j] *= alpha[a];
        }
        __syncthreads();
        load_tile(Vs, vb, sv.n, k0, n, c * kTile, width);
        __syncthreads();
        mma_nn(acc[c], Ps, Vs);
      }
    }
  }

#pragma unroll
  for (int c = 0; c < NCHUNK; ++c) {
    if (c * kTile < width) {
#pragma unroll
      for (int a = 0; a < 4; ++a) {
        const float inv = 1.f / row_l[a];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[c][a][j] *= inv;
      }
      store_patch(ob, so.n, q0, n, c * kTile, width, acc[c]);
    }
  }
  if (tx == 0) {
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int r = q0 + ty * 4 + a;
      if (r < n) lse[(long long)bh * n + r] = row_m[a] + logf(row_l[a]);
    }
  }
}

template <typename T, int NCHUNK>
int launch_fwd(const void* q, const void* k, const void* v, void* o, float* lse, int batch,
               int heads, int n, int width, const long long* st, float scale,
               cudaStream_t stream) {
  const size_t smem = 4 * kTileFloats * sizeof(float);
  auto kernel = flash_fwd_kernel<T, NCHUNK>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + kTile - 1) / kTile, batch * heads);
  kernel<<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, lse, heads, n, width,
      Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]}, Strides{st[6], st[7], st[8]},
      Strides{st[9], st[10], st[11]}, scale);
  return (int)cudaGetLastError();
}

}  // namespace rgie

// q, k, v, o: (batch, heads, n, width) with the width axis contiguous;
// `strides` holds (batch, head, row) strides in elements for q, k, v, o in
// that order (12 values). lse: (batch, heads, n) float32, contiguous.
// Returns cudaGetLastError() (0 on success), or -1 for a width or a grid the
// kernel does not take.
extern "C" int rgie_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                        float* lse, int batch, int heads, int n, int width,
                                        const long long* strides, float scale, int is_bf16,
                                        void* stream) {
  using namespace rgie;
  const int chunks = chunks_for_width(width);
  if (chunks == 0 || n <= 0 || batch * heads <= 0 || batch * heads > 65535) return -1;
  cudaStream_t s = (cudaStream_t)stream;
#define RGIE_FWD(T, C) \
  return launch_fwd<T, C>(q, k, v, o, lse, batch, heads, n, width, strides, scale, s)
  if (is_bf16) {
    if (chunks == 1) RGIE_FWD(__nv_bfloat16, 1);
    if (chunks == 2) RGIE_FWD(__nv_bfloat16, 2);
    RGIE_FWD(__nv_bfloat16, 8);
  }
  if (chunks == 1) RGIE_FWD(float, 1);
  if (chunks == 2) RGIE_FWD(float, 2);
  RGIE_FWD(float, 8);
#undef RGIE_FWD
}
