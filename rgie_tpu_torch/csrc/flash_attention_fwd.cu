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
// TFLOP/s: 10.26 ms). Five kernels, chosen by shape in the C entry point
// (`kernel_route` in ops/kernels/flash_attention.py names them):
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
// 2. `flash_fwd_wide_kernel`: bfloat16, head widths above 128 that are
//    multiples of 64, up to 512 (the VAE's single 512-wide head, once per
//    VAE pass). Both products as `wgmma`; a block owns 64 query rows and its
//    two multiplying warpgroups each own half of the output's columns and
//    compute the whole score tile themselves (the note above the kernel says
//    why). Q resident, K and V tiles of 32 keys as separate items of a
//    four-slot `cp.async` ring; softmax and products not overlapped. Dynamic shared
//    memory 97 KB (widths up to 256) or 193 KB (up to 512).
//    No spill. Measured at (1, 1, 16384, 512) on the same card: 2.99 ms
//    (27.2 on the CUDA cores before), 5.4x its bound (0.556 ms), 0.65x the
//    library's call (4.58 ms). 64-row blocks read 8.6 GB of K and V from
//    the L2 cache, and the copies alone take 2.59 ms (`python -m
//    rgie_tpu_torch.cli.kernel_variants`; 3.28 of 3.82 ms with the two-stage
//    ring of whole K + V tiles this kernel had first): blocks of more rows
//    are the open item.
// 3. `flash_fwd_float32_kernel` (widths up to 64) and
//    `flash_fwd_float32_wide_kernel` (above 64, up to 512): float32 on the
//    CUDA cores (the tensor cores would drop the last 13 mantissa bits). What
//    bounds a product there is the path from shared memory to the registers
//    (32 values a cycle against 128 `FFMA`), so each product gets an 8 x 8
//    or 8 x 16 register patch, with the products of a tile split over the
//    block's warps where one thread cannot hold two; K and V through a ring
//    of 16-byte `cp.async` copies, Q resident. The note above the kernels
//    has the design.
// 4. `flash_fwd_kernel`: the other bfloat16 widths (multiples of 4 that are
//    not of 8 up to 128, or not of 64 above). One block owns 64
//    query rows; operands are widened to float32 in shared memory, each
//    thread keeps a 4x4 patch of the score tile and a 4x4 patch per
//    64-column chunk of the output in registers, and every shared-memory
//    read is a float4 that feeds 16 multiply-adds on the CUDA cores. It
//    served float32 too until the float32 kernels replaced it there.
//
// All round P to the inputs' type before P V (the TPU kernel's
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
// float32, every head width: the CUDA cores, a ring of `cp.async` copies, Q
// resident, and 8 x 8 or 8 x 16 register patches (the float32 set's note in
// the shared header says why those sizes).
//
// Both kernels walk key tiles with the online softmax in base 2 (the scale
// folded into one multiply a score, `ex2` on the special-function unit). The
// 256 threads compute the score tile S = Q K^T as 16 x 16 (a thread: rows
// ty + 16 i, keys tx + 16 j), keep the row maximum and their share of the row
// sum in registers, and write P and the factor alpha that rescales each
// row's sums to shared memory. O += P V is computed by the same threads seen
// another way, which reads alpha there, and the barrier of the item that
// brings V publishes P and alpha.
//
// K and V stream through a ring of slots: at the barrier of item i that item
// has arrived and item i - 1 is no longer read, so the copy of item
// i + SLOTS - 1 goes into its slot and SLOTS - 1 items are on their way while
// one is multiplied. Q is copied once, with the first item.
//
// `flash_fwd_float32_kernel`, widths up to 64: a block owns 128 query rows
// and walks tiles of 128 keys, a K tile and a V tile as the two items of a
// tile in a three-slot ring. S: an 8 x 8 patch a thread. P V: the 128 x 64
// output is only 32 values a thread, too few for an 8 x 8 patch, so each
// half of the block (warps 0-3, 4-7) sums the product over one half of the
// tile's keys with an 8 x 8 patch (rows ty + 16 i, columns 4 tx + 32 e of a
// half seen as 16 x 8), and the two partial outputs are added once, at the
// end. 128 + 64 + 64 registers of sums would not fit one thread.
//
// `flash_fwd_float32_wide_kernel`, widths above 64 up to 512 (the VAE's
// single 512-wide head): 64 query rows (128 KB of Q resident at width 512)
// and 128-key tiles. S: the K tile in items of 32 columns, a 4 x 8 patch a
// thread (0.375 values read a multiply-add; an 8 x 8 patch would need a
// 256-key tile, more shared memory than Q leaves; 64-key tiles with 4 x 4
// patches took 18.86 ms against this design's 17.03 on an NVIDIA H100 80GB
// HBM3 at 700 W). P V: a thread owns 8
// rows x 16 columns of the output (rows warp + 8 i, columns 4 lane + 128 e),
// all of its 512 columns in 128 registers, and V comes as items of 8 keys x
// 512 columns (zero past the width), so one read of P feeds 16 columns. A
// three-slot ring; the softmax folds the scale into the exponent's
// multiply-add (`softmax_f32`).
// ---------------------------------------------------------------------------

// One step of the online softmax on a thread's R x C patch of raw scores
// (rows ty + 16 i, keys k0 + tx + 16 j of a block seen as 16 x 16: the 16
// threads of a row are 16 neighbouring lanes), in base 2 with the scale
// folded into one multiply-add a score. The row maximum is taken over the raw
// scores (their minimum when the scale is negative), so on a ragged tile the
// keys past n are first set to a value that cannot win it, and their P to 0
// after. Writes P (row pitch PP) and alpha, the factor that brings a row's
// old sums to its new maximum, to shared memory.
template <int R, int C, int PP>
__device__ __forceinline__ void softmax_f32(float (&s)[R][C], float (&row_m)[R], float (&row_l)[R],
                                            float* Ps, float* alpha_s, float scale2, int k0,
                                            int n) {
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const bool ragged = k0 + 16 * C > n, positive = scale2 >= 0.f;
#pragma unroll
  for (int i = 0; i < R; ++i) {
    if (ragged) {
#pragma unroll
      for (int j = 0; j < C; ++j) {
        if (k0 + tx + 16 * j >= n) s[i][j] = positive ? -3.0e38f : 3.0e38f;
      }
    }
    float ext = s[i][0];
    if (positive) {
#pragma unroll
      for (int j = 1; j < C; ++j) ext = fmaxf(ext, s[i][j]);
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) ext = fmaxf(ext, __shfl_xor_sync(0xffffffffu, ext, off));
    } else {
#pragma unroll
      for (int j = 1; j < C; ++j) ext = fminf(ext, s[i][j]);
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) ext = fminf(ext, __shfl_xor_sync(0xffffffffu, ext, off));
    }
    const float m_new = fmaxf(row_m[i], ext * scale2);   // finite: key k0 exists
    const float alpha = fast_exp2(row_m[i] - m_new);      // 0 at the first tile
    row_m[i] = m_new;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < C; ++j) {
      float p = fast_exp2(fmaf(s[i][j], scale2, -m_new));
      if (ragged && k0 + tx + 16 * j >= n) p = 0.f;
      sum += p;
      Ps[(ty + 16 * i) * PP + tx + 16 * j] = p;
    }
    row_l[i] = row_l[i] * alpha + sum;
    if (tx == 0) alpha_s[ty + 16 * i] = alpha;
  }
}

struct Fwd32 {   // widths up to 64
  static constexpr int kRows = 128, kKeys = 128, kSlots = 3;
  static constexpr int kPPitch = kKeys + 16;                 // % 32 == 16
  static constexpr int kItemFloats = kKeys * kF32Pitch;
  static constexpr int kStatFloats = 2 * kRows;              // alpha, 1 / row sum
  static constexpr size_t kSmemBytes =
      sizeof(float) * ((size_t)kRows * kF32Pitch + (size_t)kRows * kPPitch + kStatFloats +
                       (size_t)kSlots * kItemFloats);
};

__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_float32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         float* __restrict__ lse, int heads, int n, int width, Strides sq,
                         Strides sk, Strides sv, Strides so, float scale) {
  using G = Fwd32;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ps = Qs + G::kRows * kF32Pitch;
  float* alpha_s = Ps + G::kRows * G::kPPitch;
  float* inv_s = alpha_s + G::kRows;
  float* ring = inv_s + G::kRows;
  const uint32_t ring_addr = smem_addr(ring);

  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int half = threadIdx.x >> 7, t = threadIdx.x & 127;   // P V: a half, seen as 16 x 8
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int q0 = blockIdx.x * G::kRows;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  const int n_tiles = (n + G::kKeys - 1) / G::kKeys;

  // Item 2 kt is K's tile kt, item 2 kt + 1 V's.
  auto fetch = [&](int it) {
    if (it < 2 * n_tiles) {
      const bool is_v = it & 1;
      copy_tile_f32<G::kKeys, kF32Pitch>(
          ring_addr + (uint32_t)((it % G::kSlots) * G::kItemFloats) * 4u, is_v ? vb : kb,
          is_v ? sv.n : sk.n, (it >> 1) * G::kKeys, n, 0, width);
    }
    cp_async_commit();   // an empty group past the last item keeps the count of groups
  };
  auto next_item = [&](int it) {
    cp_async_wait<G::kSlots - 2>();
    __syncthreads();
    fetch(it + G::kSlots - 1);
    return ring + (it % G::kSlots) * G::kItemFloats;
  };

  copy_tile_f32<G::kRows, kF32Pitch>(smem_addr(Qs), q + b * sq.b + h * sq.h, sq.n, q0, n, 0,
                                     width);
#pragma unroll
  for (int it = 0; it + 1 < G::kSlots; ++it) fetch(it);      // Q rides with item 0

  float acc[8][8];                  // this half's share of O: rows t / 8 + 16 i
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[i][e] = 0.f;
  }
  float row_m[8], row_l[8];         // rows ty + 16 i: running maximum (log2), share of the sum
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    row_m[i] = -INFINITY;
    row_l[i] = 0.f;
  }
  const float scale2 = scale * kLog2e;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * G::kKeys;
    float s[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
    }
    const float* Ks = next_item(2 * kt);
    product_nt<8, 8, kF32Pitch, kF32Pitch, 16, 16>(s, Qs, Ks, threadIdx.x);

    // Online softmax; the 16 threads of a row are 16 neighbouring lanes.
    // (The wide kernel's `softmax_f32`, which folds the scale into the
    // exponent's multiply-add, costs this kernel spills: 19.4 against 17.3 ms
    // on an NVIDIA H100 80GB HBM3 at 700 W.)
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      float m = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        s[i][j] = k0 + tx + 16 * j < n ? s[i][j] * scale2 : -INFINITY;
        m = fmaxf(m, s[i][j]);
      }
      const float m_new = fmaxf(row_m[i], row_max16(m));   // finite: key k0 exists
      const float alpha = fast_exp2(row_m[i] - m_new);      // 0 at the first tile
      row_m[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = fast_exp2(s[i][j] - m_new);
        sum += p;
        Ps[(ty + 16 * i) * G::kPPitch + tx + 16 * j] = p;
      }
      row_l[i] = row_l[i] * alpha + sum;
      if (tx == 0) alpha_s[ty + 16 * i] = alpha;
    }

    // O += P V: this half's 64 keys of the tile.
    const float* Vs = next_item(2 * kt + 1);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float alpha = alpha_s[t / 8 + 16 * i];
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[i][e] *= alpha;
    }
    product_nn<8, 8, 64, G::kPPitch, kF32Pitch, 8, 16>(acc, Ps + 64 * half,
                                                       Vs + 64 * half * kF32Pitch, t);
  }
  cp_async_wait<0>();   // the empty groups past the last item

  // Row sums and the log-sum-exp from the score threads; the second half's
  // partial output through shared memory (Ps is free once every thread is
  // past its last product).
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const float l = row_sum16(row_l[i]);
    const int r = q0 + ty + 16 * i;
    if (tx == 0) {
      inv_s[ty + 16 * i] = 1.f / l;
      if (r < n) lse[(long long)bh * n + r] = (row_m[i] + log2f(l)) * kLn2;
    }
  }
  __syncthreads();
  float* partial = Ps + (t / 8) * kF32Pitch + 4 * (t % 8);   // rows t / 8 + 16 i
  if (half == 1) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        store4(partial + 16 * i * kF32Pitch + 32 * e,
               make_float4(acc[i][4 * e], acc[i][4 * e + 1], acc[i][4 * e + 2], acc[i][4 * e + 3]));
      }
    }
  }
  __syncthreads();
  if (half == 0) {
    float* ob = o + b * so.b + h * so.h;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = t / 8 + 16 * i, r = q0 + row;
      const float inv = inv_s[row];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 4 * (t % 8) + 32 * e;
        const float4 other = *reinterpret_cast<const float4*>(partial + 16 * i * kF32Pitch + 32 * e);
        if (r < n && col < width) {
          store4(ob + (long long)r * so.n + col,
                 make_float4((acc[i][4 * e] + other.x) * inv, (acc[i][4 * e + 1] + other.y) * inv,
                             (acc[i][4 * e + 2] + other.z) * inv,
                             (acc[i][4 * e + 3] + other.w) * inv));
        }
      }
    }
  }
}

struct Fwd32Wide {   // widths above 64 up to 512
  static constexpr int kRows = 64, kKeys = 128, kSlots = 3;
  static constexpr int kKCols = 32;                          // columns of a K item
  static constexpr int kKPitch = kKCols + 4;                 // % 32 == 4
  static constexpr int kVKeys = 8;                           // keys of a V item
  static constexpr int kRowPitch = 512 + 4;                  // Q and V items, % 32 == 4
  static constexpr int kPPitch = kKeys + 16;                 // % 32 == 16
  static constexpr int kSlotFloats = kKeys * kKPitch;        // >= kVKeys * kRowPitch
  static constexpr int kStatFloats = 2 * kRows;
  static constexpr size_t kSmemBytes =
      sizeof(float) * ((size_t)kRows * kRowPitch + (size_t)kRows * kPPitch + kStatFloats +
                       (size_t)kSlots * kSlotFloats);
  static_assert(kVKeys * kRowPitch <= kSlotFloats, "a V item fits a slot");
};

__global__ void __launch_bounds__(kThreads, 1)
flash_fwd_float32_wide_kernel(const float* __restrict__ q, const float* __restrict__ k,
                              const float* __restrict__ v, float* __restrict__ o,
                              float* __restrict__ lse, int heads, int n, int width, Strides sq,
                              Strides sk, Strides sv, Strides so, float scale) {
  using G = Fwd32Wide;
  constexpr int kVItems = G::kKeys / G::kVKeys;              // V items a tile
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* Ps = Qs + G::kRows * G::kRowPitch;
  float* alpha_s = Ps + G::kRows * G::kPPitch;
  float* inv_s = alpha_s + G::kRows;
  float* ring = inv_s + G::kRows;
  const uint32_t ring_addr = smem_addr(ring);

  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;   // P V: rows warp + 8 i
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int q0 = blockIdx.x * G::kRows;
  const float* qb = q + b * sq.b + h * sq.h;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  const int nk = (width + G::kKCols - 1) / G::kKCols;        // K items a tile
  const int per_tile = nk + kVItems;
  const int n_tiles = (n + G::kKeys - 1) / G::kKeys;

  // Items of tile kt: K's columns in nk groups of 32, then V's keys in
  // kVItems groups of kVKeys rows x 512 columns.
  auto fetch = [&](int it) {
    if (it < n_tiles * per_tile) {
      const int kt = it / per_tile, rest = it - kt * per_tile;
      const uint32_t slot = ring_addr + (uint32_t)((it % G::kSlots) * G::kSlotFloats) * 4u;
      if (rest < nk) {
        copy_tile_f32<G::kKeys, G::kKPitch, G::kKCols>(slot, kb, sk.n, kt * G::kKeys, n,
                                                       rest * G::kKCols, width);
      } else {
        const int row0 = kt * G::kKeys + (rest - nk) * G::kVKeys;
#pragma unroll
        for (int c = 0; c < 8; c += 2) {   // two chunks of 8 rows a pass of the 256 threads
          const int half = threadIdx.x >> 7, idx = threadIdx.x & 127;
          const int r = idx >> 4, col = (c + half) * 64 + ((idx & 15) << 2);
          const bool valid = row0 + r < n && col < width;
          cp_async_16(slot + (uint32_t)(r * G::kRowPitch + col) * 4u,
                      valid ? vb + (long long)(row0 + r) * sv.n + col : vb, valid);
        }
      }
    }
    cp_async_commit();
  };
  auto next_item = [&](int it) {
    cp_async_wait<G::kSlots - 2>();
    __syncthreads();
    fetch(it + G::kSlots - 1);
    return ring + (it % G::kSlots) * G::kSlotFloats;
  };

  for (int c = 0; c * 64 < width; ++c) {
    copy_tile_f32<G::kRows, G::kRowPitch>(smem_addr(Qs + c * 64), qb, sq.n, q0, n, c * 64, width);
  }
#pragma unroll
  for (int it = 0; it + 1 < G::kSlots; ++it) fetch(it);

  float acc[8][16];                 // rows warp + 8 i, columns 4 lane + 128 e
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[i][e] = 0.f;
  }
  float row_m[4], row_l[4];         // rows ty + 16 i
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    row_m[i] = -INFINITY;
    row_l[i] = 0.f;
  }
  const float scale2 = scale * kLog2e;

  int it = 0;
  for (int kt = 0; kt < n_tiles; ++kt) {
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
    }
    for (int c = 0; c < nk; ++c) {
      const float* Ks = next_item(it++);
      product_nt<4, 8, G::kRowPitch, G::kKPitch, 16, 16, G::kKCols>(s, Qs + c * G::kKCols, Ks,
                                                                     threadIdx.x);
    }
    softmax_f32<4, 8, G::kPPitch>(s, row_m, row_l, Ps, alpha_s, scale2, kt * G::kKeys, n);

#pragma unroll 2
    for (int g = 0; g < kVItems; ++g) {
      const float* Vs = next_item(it++);
      if (g == 0) {
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const float alpha = alpha_s[warp + 8 * i];
#pragma unroll
          for (int e = 0; e < 16; ++e) acc[i][e] *= alpha;
        }
      }
      product_nn<8, 16, G::kVKeys, G::kPPitch, G::kRowPitch, 32, 8>(
          acc, Ps + g * G::kVKeys, Vs, threadIdx.x);
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float l = row_sum16(row_l[i]);
    const int r = q0 + ty + 16 * i;
    if (tx == 0) {
      inv_s[ty + 16 * i] = 1.f / l;
      if (r < n) lse[(long long)bh * n + r] = (row_m[i] + log2f(l)) * kLn2;
    }
  }
  __syncthreads();
  float* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int row = warp + 8 * i, r = q0 + row;
    const float inv = inv_s[row];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 4 * lane + 128 * e;
      if (r < n && col < width) {
        store4(ob + (long long)r * so.n + col,
               make_float4(acc[i][4 * e] * inv, acc[i][4 * e + 1] * inv, acc[i][4 * e + 2] * inv,
                           acc[i][4 * e + 3] * inv));
      }
    }
  }
}

template <typename G>
int launch_fwd_f32(void (*kernel)(const float*, const float*, const float*, float*, float*, int,
                                  int, int, Strides, Strides, Strides, Strides, float),
                   const void* q, const void* k, const void* v, void* o, float* lse, int batch,
                   int heads, int n, int width, const long long* st, float scale,
                   cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)G::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + G::kRows - 1) / G::kRows, batch * heads);
  kernel<<<grid, kThreads, G::kSmemBytes, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, lse, heads, n, width,
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

// One step of the online softmax on a thread's share of a 64 x KEYS score
// tile, in base 2 with the scale folded into one multiply-add per score.
// s[4 j + i] is key k0 + 8 j + 2 (lane % 4) + i % 2 of row i / 2; on return
// it holds P, and alpha the factor that brings the old sums to the new
// maximum. The row maximum is taken over the raw scores (the smallest when
// the scale is negative), so keys past n are first set to a value that
// cannot win it, and their P is set to 0 afterwards.
template <int KEYS>
__device__ __forceinline__ void softmax_step(float (&s)[KEYS / 2], float (&row_m)[2],
                                             float (&row_l)[2], float (&alpha)[2], float scale2,
                                             int k0, int n) {
  const int lane = threadIdx.x & 31;
  const bool ragged = k0 + KEYS > n;
  const bool positive = scale2 >= 0.f;
  if (ragged) {
    const float loser = positive ? -3.0e38f : 3.0e38f;
#pragma unroll
    for (int i = 0; i < KEYS / 2; ++i) {
      if (k0 + (i >> 2) * 8 + (lane & 3) * 2 + (i & 1) >= n) s[i] = loser;
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float ext = s[2 * r];
    if (positive) {
#pragma unroll
      for (int j = 0; j < KEYS / 8; ++j) ext = fmaxf(ext, fmaxf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
      ext = fmaxf(ext, __shfl_xor_sync(0xffffffffu, ext, 1));
      ext = fmaxf(ext, __shfl_xor_sync(0xffffffffu, ext, 2));
    } else {
#pragma unroll
      for (int j = 0; j < KEYS / 8; ++j) ext = fminf(ext, fminf(s[4 * j + 2 * r], s[4 * j + 2 * r + 1]));
      ext = fminf(ext, __shfl_xor_sync(0xffffffffu, ext, 1));
      ext = fminf(ext, __shfl_xor_sync(0xffffffffu, ext, 2));
    }
    const float m_new = fmaxf(row_m[r], ext * scale2);   // finite: every tile has a key below n
    alpha[r] = fast_exp2(row_m[r] - m_new);              // 0 at the first tile (row_m = -inf)
    row_m[r] = m_new;
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < KEYS / 8; ++j) {
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
  softmax_step<kFwdRows>(s, row_m, row_l, alpha, scale2, 0, n);
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
    softmax_step<kFwdRows>(s, row_m, row_l, alpha, scale2, (kt + 1) * kFwdRows, n);
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


// ---------------------------------------------------------------------------
// bfloat16, head widths above 128 that are multiples of 64, up to 512 (the
// VAE's single 512-wide head): the tensor cores, the output split by columns.
//
// A warpgroup that owned 64 rows of a 512-wide output would need 256
// registers a thread for its sums alone. So one block owns 64 query rows and
// each of its two multiplying warpgroups owns half of the output's columns
// (NATOM / 2 atoms, at most four 64 x 64 accumulators: 128 registers). Both
// need the whole P tile: each computes S = Q K^T over the full head width
// itself and runs the same softmax. That repeats the first product (1.5 x the
// nominal 4 N^2 d operations) and spares a float32 exchange of partial
// scores through shared memory with a second barrier per tile; the bound
// with the repeat (0.83 ms at (1, 1, 16384, 512)) is far below what the rest
// of this simple version costs.
//
// Q stays resident (NATOM tiles of 64 rows). What feeds the kernel is the
// limit, not what multiplies: every block reads all of K and V from the L2
// cache (8.6 GB at (1, 1, 16384, 512)), so the copies must never drain. K
// and V tiles of 32 keys (32 KB each at width 512) are separate items of one
// ring of four slots, in the order K_0, V_0, K_1, V_1, ...: while item i is
// multiplied, items i + 1 and i + 2 are on their way or there, and the copy
// of item i + 3 takes the slot of item i - 1 (one barrier per item: there
// item i has arrived and item i - 1 is no longer read). The third warpgroup
// starts every copy. Softmax and products are not overlapped.
// ---------------------------------------------------------------------------

constexpr int kWideRows = 64;    // queries a block
constexpr int kWideKeys = 32;    // keys a tile
constexpr int kWideSlots = 4;    // ring slots, each one K tile or one V tile
constexpr uint32_t kWideQueryTileBytes = kWideRows * kRowBytes;   // one atom of Q
constexpr uint32_t kWideKeyTileBytes = kWideKeys * kRowBytes;     // one atom of K or V

template <int NATOM>
__global__ void __launch_bounds__(kTcThreads + kCopyThreads, 1)
flash_fwd_wide_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                      const bf16* __restrict__ v, bf16* __restrict__ o, float* __restrict__ lse,
                      int heads, int n, int width, Strides sq, Strides sk, Strides sv, Strides so,
                      float scale) {
  constexpr int kOwn = NATOM / 2;                                   // output atoms a warpgroup
  constexpr uint32_t kSlotBytes = NATOM * kWideKeyTileBytes;        // the atoms of K or of V
  extern __shared__ char smem_raw[];
  const uint32_t Qs = (smem_addr(smem_raw) + 1023u) & ~1023u;   // NATOM tiles
  const uint32_t ring = Qs + NATOM * kWideQueryTileBytes;       // kWideSlots slots

  const int lane = threadIdx.x & 31, wg = threadIdx.x >> 7;
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int q0 = blockIdx.x * kWideRows;
  const int n_tiles = (n + kWideKeys - 1) / kWideKeys;

  if (threadIdx.x >= kTcThreads) {
    registers_dec<kCopyRegisters>();
    // The copying warpgroup. Item 2 t of the ring is K's tile t, item 2 t + 1
    // V's. At the barrier of item i that item has arrived (the two after it
    // may still be on their way) and item i - 1 is no longer read.
    const int loader = threadIdx.x - kTcThreads;
    const bf16* qb = q + b * sq.b + h * sq.h;
    const bf16* kb = k + b * sk.b + h * sk.h;
    const bf16* vb = v + b * sv.b + h * sv.h;
    auto load_item = [&](int item) {
      if (item < 2 * n_tiles) {
        const uint32_t slot = ring + (item % kWideSlots) * kSlotBytes;
        const bf16* base = (item & 1) ? vb : kb;
        const long long stride = (item & 1) ? sv.n : sk.n;
#pragma unroll 1   // the copying warpgroup keeps 56 registers a thread
        for (int a = 0; a < NATOM; ++a) {
          load_tile_async(slot + a * kWideKeyTileBytes, base, stride, (item >> 1) * kWideKeys, n,
                          kWideKeys, a * kAtom, width, loader, kCopyThreads);
        }
      }
      cp_async_commit();   // an empty group past the last item keeps the count of groups
    };
#pragma unroll 1
    for (int a = 0; a < NATOM; ++a) {
      load_tile_async(Qs + a * kWideQueryTileBytes, qb, sq.n, q0, n, kWideRows, a * kAtom, width,
                      loader, kCopyThreads);
    }
    load_item(0);
    load_item(1);
    load_item(2);
    for (int item = 0; item < 2 * n_tiles; ++item) {
      cp_async_wait_and_publish<2>();   // this item (and, with item 0, Q)
      __syncthreads();
      load_item(item + 3);
    }
    return;
  }
  registers_inc<kTcRegisters>();

  // Per thread: rows lane / 4 and lane / 4 + 8 of its warp's 16-row band, in
  // this warpgroup's columns [wg * kOwn * 64, (wg + 1) * kOwn * 64).
  float acc[kOwn][32];
#pragma unroll
  for (int a = 0; a < kOwn; ++a) {
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[a][i] = 0.f;
  }
  float row_m[2] = {-INFINITY, -INFINITY};   // running maximum, in the log2 domain
  float row_l[2] = {0.f, 0.f};               // this thread's share of the running sum
  float alpha[2];
  const float scale2 = scale * kLog2e;
  float s[kWideKeys / 2];
  uint32_t pa[kWideKeys / 16][4];

  for (int kt = 0; kt < n_tiles; ++kt) {
    const uint32_t k_slot = ring + ((2 * kt) % kWideSlots) * kSlotBytes;
    const uint32_t v_slot = ring + ((2 * kt + 1) % kWideSlots) * kSlotBytes;
    __syncthreads();   // K's tile kt has arrived
    fence_registers(s);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < NATOM * 4; ++ks) {
      const uint64_t step = (ks & 3) * kDescNextColumns16;
      wgmma_m64n32k16_ss(s, tile_descriptor(Qs + (ks >> 2) * kWideQueryTileBytes) + step,
                         tile_descriptor(k_slot + (ks >> 2) * kWideKeyTileBytes) + step, ks > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_registers(s);
    softmax_step<kWideKeys>(s, row_m, row_l, alpha, scale2, kt * kWideKeys, n);
#pragma unroll
    for (int a = 0; a < kOwn; ++a) {
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
    for (int ks = 0; ks < kWideKeys / 16; ++ks) pack_fragment(pa[ks], s, ks);
    __syncthreads();   // V's tile kt has arrived; both warpgroups are done with K's
    fence_fragments(pa);
#pragma unroll
    for (int a = 0; a < kOwn; ++a) fence_registers(acc[a]);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kWideKeys / 16; ++ks) {
#pragma unroll
      for (int a = 0; a < kOwn; ++a) {
        wgmma_m64n64k16_rs_tb(
            acc[a], pa[ks],
            tile_descriptor(v_slot + (wg * kOwn + a) * kWideKeyTileBytes) +
                ks * kDescNextRows16);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_fragments(pa);
#pragma unroll
    for (int a = 0; a < kOwn; ++a) fence_registers(acc[a]);
  }

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
  for (int a = 0; a < kOwn; ++a) {
    store_accumulator(ob, so.n, q0, n, (wg * kOwn + a) * kAtom, width, acc[a], inv[0], inv[1]);
  }
  if (wg == 0 && (lane & 3) == 0) {   // both warpgroups hold the same row sums
    const int warp = (threadIdx.x >> 5) & 3;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = q0 + warp * 16 + (lane >> 2) + 8 * r;
      if (row < n) lse[(long long)bh * n + row] = (row_m[r] + log2f(row_l[r])) * kLn2;
    }
  }
}

template <int NATOM>
int launch_fwd_wide(const void* q, const void* k, const void* v, void* o, float* lse, int batch,
                    int heads, int n, int width, const long long* st, float scale,
                    cudaStream_t stream) {
  // Q, the ring's slots, and the slack to align the first tile.
  const size_t smem = (size_t)NATOM * (kWideQueryTileBytes + kWideSlots * kWideKeyTileBytes) +
                      1024;
  auto kernel = flash_fwd_wide_kernel<NATOM>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + kWideRows - 1) / kWideRows, batch * heads);
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
// kernel does not take. Dispatch by shape (``kernel_route`` in
// ops/kernels/flash_attention.py states the same rule): bfloat16 with a width
// that is a multiple of 8 up to 128 runs the tensor-core kernel ("tensor"),
// bfloat16 with a width that is a multiple of 64 above 128 up to 512 the wide
// one ("wide"; both take tensors 16-byte aligned, strides multiples of 8
// elements); float32 at every width the float32 kernel ("float32"; 16-byte
// aligned, strides multiples of 4); every other bfloat16 width the first
// CUDA-core kernel ("cuda_cores").
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
    const int wide_atoms = wide_atoms_for_width(width);
    if (wide_atoms == 4) {
      return launch_fwd_wide<4>(q, k, v, o, lse, batch, heads, n, width, strides, scale, s);
    }
    if (wide_atoms == 8) {
      return launch_fwd_wide<8>(q, k, v, o, lse, batch, heads, n, width, strides, scale, s);
    }
    if (chunks == 1) RGIE_FWD(__nv_bfloat16, 1);
    if (chunks == 2) RGIE_FWD(__nv_bfloat16, 2);
    RGIE_FWD(__nv_bfloat16, 8);
  }
#undef RGIE_FWD
  if (chunks == 1) {
    return launch_fwd_f32<Fwd32>(flash_fwd_float32_kernel, q, k, v, o, lse, batch, heads, n,
                                 width, strides, scale, s);
  }
  return launch_fwd_f32<Fwd32Wide>(flash_fwd_float32_wide_kernel, q, k, v, o, lse, batch, heads,
                                   n, width, strides, scale, s);
}
