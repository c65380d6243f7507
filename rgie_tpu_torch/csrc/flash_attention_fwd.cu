// Flash attention, forward: O = softmax(Q K^T * scale) V and the row
// log-sum-exp, without the N x N score matrix.
//
// Replaces the TPU kernel behind `flash_attention` ->
// `_flash_attention_impl` (jax/experimental/pallas/ops/tpu/flash_attention.py,
// `pl.pallas_call` at :758), which the JAX package reaches from the UNet's
// self-attention and the VAE's mid-block attention for sequences of 8192 and
// longer.
//
// Bound on this card: operations. The call does 4 N^2 d flops per (batch,
// head) and moves only 4 N d elements, so at N = 16384 it sits far above the
// memory roofline: for bfloat16 the limit is the tensor cores' rate (989
// TFLOP/s: 0.695 ms at (2, 5, 16384, 64)), for float32 the CUDA cores' (67
// TFLOP/s: 10.26 ms). Two kernels, chosen by shape in the C entry point:
//
// 1. `flash_fwd_tc_kernel`: bfloat16, head widths that are multiples of 8 up
//    to 128 (what the UNet launches ~1500 times an edit). Both products run
//    as `wgmma` with bfloat16 operands and float32 sums. Q, K and V stay
//    bfloat16 in shared memory as 128-byte swizzled tiles; a third warpgroup
//    keeps a three-stage ring of `cp.async` copies ahead of the two that
//    multiply. S = Q K^T lands in registers (m64n128k16), the online softmax
//    runs there in base 2 with the scale folded into one multiply-add per
//    score, P is rounded to bfloat16 in registers and is the A operand of
//    O += P V, V read MN-major from the tile its copy wrote. The softmax of
//    tile t + 1 runs while P_t V_t is on the tensor cores. No score touches
//    shared or device memory. 384 threads, 168 registers each at launch (224
//    for the multiplying warpgroups, 56 for the copying one, no spill);
//    dynamic shared memory 113 KB (widths up to 64) or 225 KB (up to 128).
//    Measured at that shape on an NVIDIA H100 80GB HBM3 at 700 W
//    (`chip_smoke.py`): 2.47 ms, 3.5x its bound and 1.5x PyTorch's own
//    fused attention call (1.60 ms). At d = 64 one `ex2` per score
//    occupies the special-function unit for as many cycles as both products
//    occupy the tensor cores, and the two warpgroups meet at one barrier per
//    tile instead of alternating between softmax and products: open items.
// 2. `flash_fwd_kernel`: float32 (the tensor cores would drop its last 13
//    mantissa bits) and the other bfloat16 widths (multiples of 4 that are
//    not of 8; 128 < d <= 512, the VAE's 512-wide head). One block owns 64
//    query rows; operands are widened to float32 in shared memory, each
//    thread keeps a 4x4 patch of the score tile and a 4x4 patch per
//    64-column chunk of the output in registers, and every shared-memory
//    read is a float4 that feeds 16 multiply-adds on the CUDA cores.
//
// Both round P to the inputs' type before P V (the TPU kernel's
// `p.astype(v.dtype)`; the identity for float32) and keep the row maximum,
// the row sum and the log-sum-exp in float32. One float32 log-sum-exp per
// row is written (the TPU kernel's separate `l` and `m` are a TPU layout
// choice). No mask, bias or segment ids.

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
        Ps[(ty * 4 + a) * kPitch + tx + 16 * bb] = rounded_to_input<T>(p);
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


// ---------------------------------------------------------------------------
// bfloat16, head widths that are multiples of 8 up to 128: the tensor cores.
//
// One block = 128 query rows of one (batch, head), two warpgroups of 64 rows,
// and a third that starts every copy. Q is copied once; the K and V
// tiles of 128 keys go through a three-stage ring of 16-byte `cp.async`
// copies (one barrier per tile; tile t + 2 is copied while tiles t and t + 1
// are in use). NATOM is the number of
// 64-column atoms of the head width (1: up to 64, 2: up to 128).
//
// A warpgroup overlaps its softmax with its second product: with P_t packed
// in registers it starts S_{t+1} = Q K_{t+1}^T and O += P_t V_t together,
// waits for S_{t+1} alone, and runs the softmax of tile t + 1 while P_t V_t
// is still on the tensor cores; O is rescaled once that product is done.
// ---------------------------------------------------------------------------

constexpr int kFwdRows = 128;                              // queries a block, keys a tile
constexpr int kFwdStages = 3;
constexpr uint32_t kFwdTileBytes = kFwdRows * kRowBytes;   // one atom of 128 rows

// Every register a product of the coming stage reads or writes is fenced
// before the stage's first `wgmma`: a register fence between two products of
// one stage makes the assembler run them one after the other.
template <int NATOM>
__device__ __forceinline__ void open_stage(float (&s)[64], float (&acc)[NATOM][32]) {
  fence_registers(s);
#pragma unroll
  for (int a = 0; a < NATOM; ++a) fence_registers(acc[a]);
  wgmma_fence();
}

// Start S = Q K^T (64 x 128 for this warpgroup) over the head width.
template <int NATOM>
__device__ __forceinline__ void start_scores(float (&s)[64], uint32_t q_tiles, uint32_t k_tiles) {
#pragma unroll
  for (int ks = 0; ks < NATOM * 4; ++ks) {
    const uint32_t atom = (ks >> 2) * kFwdTileBytes;
    wgmma_m64n128k16_ss(s, tile_descriptor(q_tiles + atom) + (ks & 3) * kDescNextColumns16,
                        tile_descriptor(k_tiles + atom) + (ks & 3) * kDescNextColumns16, ks > 0);
  }
  wgmma_commit();
}

// Start O += P V with P as register fragments.
template <int NATOM>
__device__ __forceinline__ void start_pv(float (&acc)[NATOM][32], const uint32_t (&pa)[8][4],
                                         uint32_t v_tiles) {
#pragma unroll
  for (int ks = 0; ks < 8; ++ks) {
#pragma unroll
    for (int a = 0; a < NATOM; ++a) {
      wgmma_m64n64k16_rs_tb(acc[a], pa[ks],
                            tile_descriptor(v_tiles + a * kFwdTileBytes) + ks * kDescNextRows16);
    }
  }
  wgmma_commit();
}

// One step of the online softmax on a thread's share of a 64 x 128 score
// tile, in base 2 with the scale folded into one multiply-add per score.
// s[4 j + i] is key k0 + 8 j + 2 (lane % 4) + i % 2 of row i / 2; on return
// it holds P, and alpha the factor that brings the old sums to the new
// maximum. The row maximum is taken over the raw scores (the smallest when
// the scale is negative), so keys past n are first set to a value that
// cannot win it, and their P is set to 0 afterwards.
__device__ __forceinline__ void softmax_step(float (&s)[64], float (&row_m)[2], float (&row_l)[2],
                                             float (&alpha)[2], float scale2, int k0, int n) {
  const int lane = threadIdx.x & 31;
  const bool ragged = k0 + kFwdRows > n;
  const bool positive = scale2 >= 0.f;
  if (ragged) {
    const float loser = positive ? -3.0e38f : 3.0e38f;
#pragma unroll
    for (int i = 0; i < 64; ++i) {
      if (k0 + (i >> 2) * 8 + (lane & 3) * 2 + (i & 1) >= n) s[i] = loser;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float ext = s[2 * r];
    if (positive) {
#pragma unroll
      for (int j = 0; j < 16; ++j) ext = fmaxf(ext, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
      ext = fmaxf(ext, __shfl_xor_sync(0xffffffffu, ext, 1));
      ext = fmaxf(ext, __shfl_xor_sync(0xffffffffu, ext, 2));
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j) ext = fminf(ext, fminf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
      ext = fminf(ext, __shfl_xor_sync(0xffffffffu, ext, 1));
      ext = fminf(ext, __shfl_xor_sync(0xffffffffu, ext, 2));
    }
    const float m_new = fmaxf(row_m[r], ext * scale2);   // finite: every tile has a key below n
    alpha[r] = fast_exp2(row_m[r] - m_new);              // 0 at the first tile (row_m = -inf)
    row_m[r] = m_new;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float p = fast_exp2(fmaf(s[4 * j + 2 * r + e], scale2, -m_new));
        if (ragged && k0 + 8 * j + (lane & 3) * 2 + e >= n) p = 0.f;
        sum += p;
        s[4 * j + 2 * r + e] = p;
      }
    }
    row_l[r] = row_l[r] * alpha[r] + sum;
  }
}

template <int NATOM>
__global__ void __launch_bounds__(kTcThreads + kCopyThreads, 1)
flash_fwd_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                    int heads, int n, int width, Strides sq, Strides sk, Strides sv, Strides so,
                    float scale) {
  constexpr uint32_t kStageBytes = 2 * NATOM * kFwdTileBytes;   // K's atoms, then V's
  extern __shared__ char smem_raw[];
  const uint32_t Qs = (smem_addr(smem_raw) + 1023u) & ~1023u;   // NATOM tiles
  const uint32_t KVs = Qs + NATOM * kFwdTileBytes;              // kFwdStages stages

  const int lane = threadIdx.x & 31, wg = threadIdx.x >> 7;
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int q0 = blockIdx.x * kFwdRows;
  const int n_tiles = (n + kFwdRows - 1) / kFwdRows;

  if (threadIdx.x >= kTcThreads) {
    registers_dec<kCopyRegisters>();
    // The copying warpgroup. It meets the multiplying warps at one barrier per
    // tile: there tile t + 1 has arrived and tile t - 1 is no longer read,
    // so the copy of tile t + 2 may overwrite its stage.
    const int loader = threadIdx.x - kTcThreads;
    const bf16* qb = q + b * sq.b + h * sq.h;
    const bf16* kb = k + b * sk.b + h * sk.h;
    const bf16* vb = v + b * sv.b + h * sv.h;
    auto load_kv = [&](int kt) {
      if (kt < n_tiles) {
        const uint32_t stage = KVs + (kt % kFwdStages) * kStageBytes;
#pragma unroll
        for (int a = 0; a < NATOM; ++a) {
          load_tile_async(stage + a * kFwdTileBytes, kb, sk.n, kt * kFwdRows, n, kFwdRows,
                          a * kAtom, width, loader, kCopyThreads);
          load_tile_async(stage + (NATOM + a) * kFwdTileBytes, vb, sv.n, kt * kFwdRows, n,
                          kFwdRows, a * kAtom, width, loader, kCopyThreads);
        }
      }
      cp_async_commit();   // an empty group past the last tile keeps the count of groups
    };
#pragma unroll
    for (int a = 0; a < NATOM; ++a) {
      load_tile_async(Qs + a * kFwdTileBytes, qb, sq.n, q0, n, kFwdRows, a * kAtom, width, loader,
                      kCopyThreads);
    }
    load_kv(0);
    load_kv(1);
    cp_async_wait_and_publish<1>();   // Q and tile 0
    __syncthreads();
    for (int kt = 0; kt + 1 < n_tiles; ++kt) {
      cp_async_wait_and_publish<0>();   // tile kt + 1
      __syncthreads();
      load_kv(kt + 2);
    }
    return;
  }
  registers_inc<kTcRegisters>();

  // Per thread: rows lane / 4 and lane / 4 + 8 of its warp's 16-row band.
  float acc[NATOM][32];
#pragma unroll
  for (int a = 0; a < NATOM; ++a) {
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[a][i] = 0.f;
  }
  float row_m[2] = {-INFINITY, -INFINITY};   // running maximum, in the log2 domain
  float row_l[2] = {0.f, 0.f};               // this thread's share of the running sum
  float alpha[2];
  const float scale2 = scale * kLog2e;
  const uint32_t q_tiles = Qs + wg * 64 * kRowBytes;   // this warpgroup's 64 rows of Q

  // Tile 0 alone: its scores, its softmax (O is still zero), P_0 packed.
  float s[64];
  uint32_t pa[8][4];
  __syncthreads();
  open_stage<NATOM>(s, acc);
  start_scores<NATOM>(s, q_tiles, KVs);
  wgmma_wait<0>();
  fence_registers(s);
  softmax_step(s, row_m, row_l, alpha, scale2, 0, n);
#pragma unroll
  for (int ks = 0; ks < 8; ++ks) pack_fragment(pa[ks], s, ks);

  // No `wgmma` sits under a condition: the assembler runs the products of a
  // stage one after the other when one of them does.
  for (int kt = 0; kt + 1 < n_tiles; ++kt) {
    // Tile kt + 1 has arrived, and both warpgroups are done with tile kt - 1.
    __syncthreads();
    open_stage<NATOM>(s, acc);
    start_scores<NATOM>(s, q_tiles, KVs + ((kt + 1) % kFwdStages) * kStageBytes);
    start_pv<NATOM>(acc, pa, KVs + (kt % kFwdStages) * kStageBytes + NATOM * kFwdTileBytes);
    wgmma_wait<1>();   // S_{kt+1} is there; P_kt V_kt still runs
    fence_registers(s);
    softmax_step(s, row_m, row_l, alpha, scale2, (kt + 1) * kFwdRows, n);
    wgmma_wait<0>();
    fence_fragments(pa);
#pragma unroll
    for (int a = 0; a < NATOM; ++a) {
      fence_registers(acc[a]);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          acc[a][4 * j + 2 * r] *= alpha[r];
          acc[a][4 * j + 2 * r + 1] *= alpha[r];
        }
      }
    }
#pragma unroll
    for (int ks = 0; ks < 8; ++ks) pack_fragment(pa[ks], s, ks);
  }
  // The last tile's second product.
  open_stage<NATOM>(s, acc);
  start_pv<NATOM>(acc, pa, KVs + ((n_tiles - 1) % kFwdStages) * kStageBytes +
                               NATOM * kFwdTileBytes);
  wgmma_wait<0>();
  fence_fragments(pa);
#pragma unroll
  for (int a = 0; a < NATOM; ++a) fence_registers(acc[a]);

  // A row's sum is spread over the 4 lanes of its quad.
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    row_l[r] += __shfl_xor_sync(0xffffffffu, row_l[r], 1);
    row_l[r] += __shfl_xor_sync(0xffffffffu, row_l[r], 2);
    inv[r] = 1.f / row_l[r];
  }
  bf16* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int a = 0; a < NATOM; ++a) {
    store_accumulator(ob, so.n, q0 + wg * 64, n, a * kAtom, width, acc[a], inv[0], inv[1]);
  }
  if ((lane & 3) == 0) {
    const int warp = (threadIdx.x >> 5) & 3;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + wg * 64 + warp * 16 + (lane >> 2) + 8 * r;
      if (row < n) lse[(long long)bh * n + row] = (row_m[r] + log2f(row_l[r])) * kLn2;
    }
  }
}

template <int NATOM>
int launch_fwd_tc(const void* q, const void* k, const void* v, void* o, float* lse, int batch,
                  int heads, int n, int width, const long long* st, float scale,
                  cudaStream_t stream) {
  // Q, the stages of K and V, and the slack to align the first tile.
  const size_t smem = (size_t)NATOM * (1 + 2 * kFwdStages) * kFwdTileBytes + 1024;
  auto kernel = flash_fwd_tc_kernel<NATOM>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + 127) / 128, batch * heads);
  kernel<<<grid, kTcThreads + kCopyThreads, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (bf16*)o, lse, heads, n, width,
      Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]}, Strides{st[6], st[7], st[8]},
      Strides{st[9], st[10], st[11]}, scale);
  return (int)cudaGetLastError();
}

}  // namespace rgie

// q, k, v, o: (batch, heads, n, width) with the width axis contiguous;
// `strides` holds (batch, head, row) strides in elements for q, k, v, o in
// that order (12 values). lse: (batch, heads, n) float32, contiguous.
// Returns cudaGetLastError() (0 on success), or -1 for a width or a grid the
// kernel does not take. Dispatch by shape: bfloat16 with a width that is a
// multiple of 8 up to 128 runs the tensor-core kernel (its tensors 16-byte
// aligned, strides multiples of 8 elements); float32, and every other
// bfloat16 width, the CUDA-core kernel.
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
    const int atoms = atoms_for_width(width);
    if (atoms == 1) {
      return launch_fwd_tc<1>(q, k, v, o, lse, batch, heads, n, width, strides, scale, s);
    }
    if (atoms == 2) {
      return launch_fwd_tc<2>(q, k, v, o, lse, batch, heads, n, width, strides, scale, s);
    }
    if (chunks == 1) RGIE_FWD(__nv_bfloat16, 1);
    if (chunks == 2) RGIE_FWD(__nv_bfloat16, 2);
    RGIE_FWD(__nv_bfloat16, 8);
  }
  if (chunks == 1) RGIE_FWD(float, 1);
  if (chunks == 2) RGIE_FWD(float, 2);
  RGIE_FWD(float, 8);
#undef RGIE_FWD
}
