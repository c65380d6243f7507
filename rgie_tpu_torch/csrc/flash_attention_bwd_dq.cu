// Flash attention, backward for queries:
//   P = exp(Q K^T * scale - lse),  dS = P * (dO V^T - di) * scale,  dQ = dS K,
// with di = rowsum(O * dO) computed by the caller.
//
// Replaces the TPU kernel `_flash_attention_bwd_dq`
// (jax/experimental/pallas/ops/tpu/flash_attention.py, `pl.pallas_call` at
// :1456).
//
// Bound on this card: operations (6 N^2 d flops per (batch, head) against
// 5 N d elements moved): the tensor cores' rate for bfloat16 (1.04 ms at
// (2, 5, 16384, 64)), the CUDA cores' for float32 (15.4 ms; 12.3 ms at the
// VAE's (1, 1, 16384, 512)). In every kernel a block owns its query rows and
// walks the key tiles, so each dQ element is summed in a fixed order: no
// atomics, and the result is the same from run to run. Scores are recomputed
// from the saved log-sum-exp. dS is rounded to the inputs' type before dS K
// (the TPU kernel's `ds.astype(k.dtype)`; the identity for float32). Four
// kernels, chosen by type and width in the C entry point (`kernel_route` in
// ops/kernels/flash_attention.py names them):
//
// 1. `flash_bwd_dq_tc_kernel`: bfloat16, head widths that are multiples of 8
//    up to 128 (what the UNet's backward launches 840 times an edit; the note
//    above the kernel has the design: all three products as `wgmma` with
//    bfloat16 operands and float32 sums, Q and dO resident, K and V through a
//    `cp.async` ring fed by a third warpgroup, P and dS in registers only,
//    dS rounded there and handed to dS K as the register operand, the
//    arithmetic of tile t + 1 under the dS K of tile t). 384 threads, 168
//    registers each at launch (224 / 56 after `setmaxnreg`); dynamic shared
//    memory 129 KB (widths up to 64) or 161 KB (up to 128).
//    No spill. Measured at that shape on an NVIDIA H100 80GB HBM3 at 700 W
//    (`chip_smoke.py`): 2.73 ms (32.7 on the CUDA cores before), 2.6x its
//    bound; the library's one backward call for dQ, dK and dV takes 3.94 ms.
//    The copies alone take 1.31 ms and taking `ex2` out changes nothing
//    (`python -m rgie_tpu_torch.cli.kernel_variants`): what is left is the
//    wait between a stage's products and its arithmetic, which both
//    warpgroups do at the same time (one barrier per tile); letting them run
//    free of each other on named barriers measured slower (3.30 ms). Open
//    items.
// 2. `flash_bwd_dq_float32_kernel`: float32 at head widths up to 128, on the
//    CUDA cores (the tensor cores would drop the last 13 mantissa bits of
//    every operand): Q and dO resident, K and V through a two-stage
//    `cp.async` ring, and the products of a tile handed to the block's two
//    warp halves so that each runs with an 8 x 8 register patch (the note
//    above the kernel has the design). 238 registers, no spill; 209 KB of
//    dynamic shared memory at width 64. Measured at (2, 5, 16384, 64) on an
//    NVIDIA H100 80GB HBM3 at 700 W (`python -m
//    rgie_tpu_torch.cli.kernel_variants dq32`): 25.74 ms against the 32.52
//    of the kernel before it, 1.67x its bound; the products alone 24.63, the
//    copies alone 3.19, the exponential 0.55. What is left is the loops'
//    rate: both the `FFMA` and the shared-memory reads need 12,288 cycles a
//    tile, and the loops reach about 62% of that.
// 3. `flash_bwd_dq_float32_wide_kernel`: float32 above width 128 up to 512
//    (the VAE's single 512-wide head), on the CUDA cores: whole head rows of
//    32 query rows' Q and dO resident, K and V tiles of 8 keys through a
//    three-stage `cp.async` ring, each score product one warp's 8 x 8 patch
//    split over its lanes by columns and folded by shuffles, dQ with 8 x 8
//    patches, each warp of a pair on half the columns (the note above the
//    kernel has the design). Compiled for 2 (widths up to 256) and 4 groups
//    of 128 columns. No spill; 230,400 bytes of dynamic shared memory at
//    width 512. Its times, its bound and what bounds it are in PERF.md
//    (`python -m rgie_tpu_torch.cli.kernel_variants dq32w`).
// 4. `flash_bwd_dq_kernel`: the bfloat16 widths the tensor-core kernel does
//    not take, on the CUDA cores (bfloat16 widened to float32 in shared
//    memory). One block owns 64 query rows; Q and dO stay resident in shared
//    memory at width 64 and the scores never leave the chip. A head wider
//    than 64 is walked in 64-column chunks as in the forward kernel: the
//    scores are summed over the chunks once, and the block keeps one 4x4
//    patch of dQ per chunk in registers (128 at width 512), so no product is
//    repeated; the price is that Q, dO, K and V are reloaded chunk by chunk.
//    It served float32 above width 128 too until kernel 3 replaced it there.
// The edit never differentiates the VAE, so only width 64 is on its path,
// and there the float32 and tensor-core kernels run.

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


// ---------------------------------------------------------------------------
// float32, head widths up to 128: the CUDA cores, a ring of `cp.async`
// copies, and the three products of a tile handed to the two halves of the
// block.
//
// A block owns kRows = 128 / NCHUNK query rows; Q and dO are copied once and
// stay resident, with -lse log2(e) and di beside them. K and V tiles of 64
// keys go through a two-stage ring (the copy of tile t + 1 runs while tile t
// is multiplied; a third stage measured no faster). A thread holds one 8 x 8 patch of a score tile beside one
// of dQ (255 registers), and smaller patches are bound by shared-memory
// reads (the float32 set's note in the shared header), so (warps 0-3 and
// 4-7; a half seen as 16 x 8 for the scores):
//   half 0: S = Q K^T, P = exp(S scale - lse), half of it -> shared memory;
//   half 1: dP = dO V^T, the other half of it -> shared memory;
//   (barrier) both: dS = P (dP - di) scale over P, each half on the rows of
//     its patch whose other factor the other half stored;
//   (barrier) half h: dQ_h += dS[:, 32 h .. 32 h + 31] K[32 h .. 32 h + 31, :].
// dQ is thus split by keys, not by rows: each half sums the whole block of dQ
// over its 32 keys of every tile, with an 8 x 8 patch (rows ty + RS i,
// columns 4 tx + 4 TX e), where a split by rows would leave each thread an
// 8 x 4 patch that reads 0.375 values a multiply-add. The two halves' sums
// are added once at the end, half 0's first: every sum runs in a fixed
// order, no atomics. Three barriers a tile. Per tile and multiprocessor at
// width 64: 3 products of 128 x 64 x 64 (6,144 warp `FFMA` each of 8
// warps), and 1,024 warp `LDS.128` per product (4 cycles each): the `FFMA`
// and shared-memory reads take 12,288 cycles each. Width up to 64: 128 rows,
// a score patch of 8 rows x 8 keys (212 KB of shared memory); up to 128: 64
// rows, 4 x 8, so that Q and dO resident fit beside two stages (216 KB),
// and there dP does not fit beside P: half 1 computes all of dS.
// ---------------------------------------------------------------------------

template <int NCHUNK>
struct Dq32 {
  static constexpr int kQI = 8 / NCHUNK;                // score rows a thread
  static constexpr int kRows = 16 * kQI;                // query rows a block
  static constexpr int kKeys = 64;                      // keys a tile
  static constexpr int kDPitch = 64 * NCHUNK + 4;       // % 32 == 4
  static constexpr int kPPitch = kKeys + 8;             // % 32 == 8
  static constexpr int kTX = 8 * NCHUNK;                // dQ patch: threads across the width,
  static constexpr int kRS = 128 / kTX;                 // and down the rows
  // dS split over both halves where dP fits in shared memory beside P.
  static constexpr bool kSplitDs = NCHUNK == 1;
  static constexpr int kStageFloats = 2 * kKeys * kDPitch;
  static constexpr size_t kSmemBytes =
      sizeof(float) * (2 * (size_t)kRows * kDPitch + 2 * (size_t)kStageFloats +
                       (kSplitDs ? 2 : 1) * (size_t)kRows * kPPitch + 2 * (size_t)kRows);
  static_assert(8 * kRS == kRows, "the dQ patches cover the block's rows");
};

template <int NCHUNK>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_float32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const float* __restrict__ d_o,
                            const float* __restrict__ lse, const float* __restrict__ di,
                            float* __restrict__ dq, int heads, int n, int width, Strides sq,
                            Strides sk, Strides sv, Strides sdo, Strides sdq, float scale) {
  using G = Dq32<NCHUNK>;
  constexpr int kRows = G::kRows, kQI = G::kQI, kKeys = G::kKeys;
  constexpr int kDP = G::kDPitch, kPP = G::kPPitch;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* dOs = Qs + kRows * kDP;
  float* ring = dOs + kRows * kDP;            // 2 stages: K, V
  float* Ps = ring + 2 * G::kStageFloats;     // P, then dS over it
  float* dPs = Ps + kRows * kPP;              // dP (with kSplitDs)
  float* row_s = dPs + (G::kSplitDs ? kRows * kPP : 0);   // -lse log2(e), then di
  const uint32_t ring_addr = smem_addr(ring);

  const int half = threadIdx.x >> 7, t = threadIdx.x & 127;
  const int ty = t >> 3, tx = t & 7;
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int q0 = blockIdx.x * kRows;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  const int n_tiles = (n + kKeys - 1) / kKeys;

  // Key tile kt into stage kt % 2: K's chunks, then V's.
  auto fetch = [&](int kt) {
    if (kt < n_tiles) {
      const uint32_t stage = ring_addr + (uint32_t)((kt & 1) * G::kStageFloats) * 4u;
#pragma unroll
      for (int c = 0; c < NCHUNK; ++c) {
        copy_tile_f32<kKeys, kDP>(stage + (uint32_t)(c * 64) * 4u, kb, sk.n, kt * kKeys, n,
                                  c * 64, width);
        copy_tile_f32<kKeys, kDP>(stage + (uint32_t)(kKeys * kDP + c * 64) * 4u, vb, sv.n,
                                  kt * kKeys, n, c * 64, width);
      }
    }
    cp_async_commit();
  };

#pragma unroll
  for (int c = 0; c < NCHUNK; ++c) {
    copy_tile_f32<kRows, kDP>(smem_addr(Qs + c * 64), q + b * sq.b + h * sq.h, sq.n, q0, n,
                              c * 64, width);
    copy_tile_f32<kRows, kDP>(smem_addr(dOs + c * 64), d_o + b * sdo.b + h * sdo.h, sdo.n, q0,
                              n, c * 64, width);
  }
  fetch(0);   // Q and dO ride with tile 0
  // Rows past n get lse = di = 0: with zero Q and dO rows their dS is 0.
  if (threadIdx.x < 2 * kRows) {
    const int row = q0 + threadIdx.x % kRows;
    const bool first = threadIdx.x < kRows;
    const float x = row < n ? (first ? lse : di)[(long long)bh * n + row] : 0.f;
    row_s[threadIdx.x] = first ? -x * kLog2e : x;
  }

  float acc[8][8];   // dQ over this half's keys: rows ty' + RS i, columns 4 tx' + 4 TX e + c
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  }
  const float scale2 = scale * kLog2e;
  const float* A = half == 0 ? Qs : dOs;      // the score product's resident operand
  const float* row_v = row_s + half * kRows;  // half 0: -lse log2(e); half 1: di

  for (int kt = 0; kt < n_tiles; ++kt) {
    // Tile kt has arrived, and every thread is done with tile kt - 1: its
    // stage takes tile kt + 1, and P may be written again.
    cp_async_wait<0>();
    __syncthreads();
    fetch(kt + 1);
    const float* Ks = ring + (kt & 1) * G::kStageFloats;
    const float* Vs = Ks + kKeys * kDP;
    const int k0 = kt * kKeys;

    // S (half 0) or dP (half 1): entry [i][j] is query row ty + 16 i, key
    // k0 + tx + 8 j.
    float sc[kQI][8];
#pragma unroll
    for (int i = 0; i < kQI; ++i) {
#pragma unroll
      for (int j = 0; j < 8; ++j) sc[i][j] = 0.f;
    }
    const float* B = half == 0 ? Ks : Vs;
#pragma unroll
    for (int c = 0; c < NCHUNK; ++c) {
      product_nt<kQI, 8, kDP, kDP, 8, 16>(sc, A + c * 64, B + c * 64, t);
    }
    // dS = P (dP - di) scale. Keys past n have zero K and V rows but a P
    // that need not be finite: their P is set to 0, so that their dS is 0.
    // With kSplitDs each half finishes the rows i < kQI / 2 (half 0) or the
    // others (half 1) of its patch from its own registers and the other
    // half's values in shared memory; else half 1 finishes them all.
    constexpr int kHalfRows = G::kSplitDs ? kQI / 2 : 0;
    if (half == 0) {
#pragma unroll
      for (int i = 0; i < kQI; ++i) {
        const float neg_lse2 = row_v[ty + 16 * i];   // base 2, one fma a score
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          sc[i][j] = k0 + tx + 8 * j < n ? fast_exp2(fmaf(sc[i][j], scale2, neg_lse2)) : 0.f;
          if (i >= kHalfRows) Ps[(ty + 16 * i) * kPP + tx + 8 * j] = sc[i][j];
        }
      }
    } else if (G::kSplitDs) {
#pragma unroll
      for (int i = 0; i < kHalfRows; ++i) {
#pragma unroll
        for (int j = 0; j < 8; ++j) dPs[(ty + 16 * i) * kPP + tx + 8 * j] = sc[i][j];
      }
    }
    __syncthreads();
    if (half == 0) {
#pragma unroll
      for (int i = 0; i < kHalfRows; ++i) {
        const float row_di = row_s[kRows + ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int at = (ty + 16 * i) * kPP + tx + 8 * j;
          Ps[at] = sc[i][j] * (dPs[at] - row_di) * scale;
        }
      }
    } else {
#pragma unroll
      for (int i = kHalfRows; i < kQI; ++i) {
        const float row_di = row_v[ty + 16 * i];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int at = (ty + 16 * i) * kPP + tx + 8 * j;
          Ps[at] = Ps[at] * (sc[i][j] - row_di) * scale;
        }
      }
    }
    __syncthreads();

    // dQ_half += dS[:, 32 half ..] K[32 half .., :]
    product_nn<8, 8, 32, kPP, kDP, G::kTX, G::kRS>(acc, Ps + 32 * half, Ks + 32 * half * kDP, t);
  }
  cp_async_wait<0>();

  // Half 1's sums reach half 0 through shared memory over Q, which no thread
  // reads after the last tile's score product; half 0 adds them to its own
  // and stores the block's dQ.
  const int ry = t / G::kTX, rx = t % G::kTX;
  if (half == 1) {
#pragma unroll
    for (int i = 0; i < 8; ++i) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        store4(Qs + (ry + G::kRS * i) * kDP + 4 * rx + 4 * G::kTX * e,
               make_float4(acc[i][4 * e], acc[i][4 * e + 1], acc[i][4 * e + 2],
                           acc[i][4 * e + 3]));
      }
    }
  }
  __syncthreads();
  if (half == 0) {
    float* dqb = dq + b * sdq.b + h * sdq.h;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int r = q0 + ry + G::kRS * i;
      if (r >= n) continue;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = 4 * rx + 4 * G::kTX * e;
        if (col < width) {
          const float4 o = load4(Qs + (ry + G::kRS * i) * kDP + col);
          store4(dqb + (long long)r * sdq.n + col,
                 make_float4(acc[i][4 * e] + o.x, acc[i][4 * e + 1] + o.y,
                             acc[i][4 * e + 2] + o.z, acc[i][4 * e + 3] + o.w));
        }
      }
    }
  }
}

template <int NCHUNK>
int launch_dq_f32(const void* q, const void* k, const void* v, const void* d_o, const float* lse,
                  const float* di, void* dq, int batch, int heads, int n, int width,
                  const long long* st, float scale, cudaStream_t stream) {
  using G = Dq32<NCHUNK>;
  auto kernel = flash_bwd_dq_float32_kernel<NCHUNK>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)G::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + G::kRows - 1) / G::kRows, batch * heads);
  kernel<<<grid, kThreads, G::kSmemBytes, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)d_o, lse, di, (float*)dq,
      heads, n, width, Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
      Strides{st[6], st[7], st[8]}, Strides{st[9], st[10], st[11]},
      Strides{st[12], st[13], st[14]}, scale);
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// float32, head widths above 128 up to 512 (the VAE's single 512-wide head):
// the CUDA cores, whole head rows in shared memory, and each score product
// split over a warp's lanes (the wide float32 backward set's note in the
// shared header).
//
// A block owns 32 query rows; Q and dO (128 KB at width 512) are copied once
// and stay, each thread's row of -lse log2(e) or di in a register. K and V
// tiles of 8 keys go through a three-stage `cp.async` ring (32 KB a stage;
// the copy of tile t + 2 starts at tile t), so each block reads K and V once
// from the L2 cache: (N / 32) N 128 NGROUP 8 bytes, 32.2 GB at
// (1, 1, 16384, 512). A pair of warps w and w + 4 owns query rows
// 8 w .. 8 w + 7:
//   warp w:     S = Q K^T (its 8 rows x the tile's 8 keys), P = exp(S scale -
//               lse) -> shared memory; signals warp w + 4;
//   warp w + 4: dP = dO V^T, waits for warp w, dS = P (dP - di) scale over P
//               in shared memory; signals warp w;
//   then both: dQ += dS K for the pair's 8 rows, warp w over the first half
//   of the columns, warp w + 4 over the second (lane l: columns 4 l + 128 e),
//   8 x 2 NGROUP sums a thread.
// A pair meets only itself within a tile (named barriers 1 + w and 5 + w, 64
// threads); the block meets once a tile, where the next stage's copy starts.
// Each dQ element is summed over the key tiles in order by one thread, and
// each score over the lanes in the fold's fixed order: no atomics. Keys past
// n have zero K and V rows but a P that need not be finite: their P is set to
// 0. Query rows past n have zero Q and dO and lse = di = 0: their dS is 0,
// and they are not stored.
// ---------------------------------------------------------------------------

template <int NGROUP>
struct Dq32Wide {
  static constexpr int kRows = 32;                           // query rows a block
  static constexpr int kKeys = 8;                            // keys a tile
  static constexpr int kRow = 128 * NGROUP;                  // floats a row of Q, dO, K, V
  static constexpr int kStages = 3;                          // of the ring
  static constexpr int kStageFloats = 2 * kKeys * kRow;      // K, V
  static constexpr int kScoreVec = 4;                        // the score product's float4 reads
  static constexpr int kScoreUnroll = NGROUP;                // and its loop, unrolled
  static constexpr int kXorBits = 3;                         // `lane_rows`
  static constexpr size_t kSmemBytes =
      sizeof(float) * (2 * (size_t)kRows * kRow + (size_t)kRows * kKeys +
                       kStages * (size_t)kStageFloats);
};

template <int NGROUP>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dq_float32_wide_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                 const float* __restrict__ v, const float* __restrict__ d_o,
                                 const float* __restrict__ lse, const float* __restrict__ di,
                                 float* __restrict__ dq, int heads, int n, int width, Strides sq,
                                 Strides sk, Strides sv, Strides sdo, Strides sdq, float scale) {
  using G = Dq32Wide<NGROUP>;
  constexpr int kRows = G::kRows, kKeys = G::kKeys, kRow = G::kRow;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;
  float* dOs = Qs + kRows * kRow;
  float* Ss = dOs + kRows * kRow;            // P, then dS over it: 32 rows x 8 keys
  float* ring = Ss + kRows * kKeys;          // kStages stages: K, V
  const uint32_t ring_addr = smem_addr(ring);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool p_warp = warp < 4;              // P; else dS
  const int row0 = 8 * (warp & 3);           // the pair's rows within the block
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int q0 = blockIdx.x * kRows;
  const float* kb = k + b * sk.b + h * sk.h;
  const float* vb = v + b * sv.b + h * sv.h;
  const int n_tiles = (n + kKeys - 1) / kKeys;

  // Key tile kt into stage kt % kStages: K's rows, then V's.
  auto fetch = [&](int kt) {
    if (kt < n_tiles) {
      const int k0 = kt * kKeys;
      const uint32_t stage = ring_addr + (uint32_t)((kt % G::kStages) * G::kStageFloats) * 4u;
      copy_tile_f32<kKeys, kRow, kRow>(stage, kb, sk.n, k0, n, 0, width);
      copy_tile_f32<kKeys, kRow, kRow>(stage + (uint32_t)(kKeys * kRow) * 4u, vb, sv.n, k0, n, 0,
                                       width);
    }
    cp_async_commit();
  };

  copy_tile_f32<kRows, kRow, kRow>(smem_addr(Qs), q + b * sq.b + h * sq.h, sq.n, q0, n, 0, width);
  copy_tile_f32<kRows, kRow, kRow>(smem_addr(dOs), d_o + b * sdo.b + h * sdo.h, sdo.n, q0, n, 0,
                                   width);
#pragma unroll
  for (int kt = 0; kt + 1 < G::kStages; ++kt) fetch(kt);   // Q and dO ride with tile 0
  // This lane's score row: -lse log2(e) for warps 0-3, di for the others.
  const int row = q0 + row0 + (lane >> 2);
  const float row_value =
      row < n ? (p_warp ? -lse[(long long)bh * n + row] * kLog2e : di[(long long)bh * n + row])
              : 0.f;

  float acc[8][2 * NGROUP];   // dQ: rows row0 + i, columns 4 lane + 128 (e + half NGROUP / 2) + c
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int e = 0; e < 2 * NGROUP; ++e) acc[i][e] = 0.f;
  }
  const float scale2 = scale * kLog2e;
  // The score product's resident rows, in this lane's order.
  const auto rows = lane_rows<G::kXorBits, kRow>((p_warp ? Qs : dOs) + row0 * kRow, lane);
  float* S = Ss + row0 * kKeys;                         // its 8 x 8 result, then dS
  const int at = (lane >> 2) * kKeys + 2 * (lane & 3);  // this lane's two entries of it
  const int pair = 1 + (warp & 3);
  const int col0 = p_warp ? 0 : 64 * NGROUP;            // this warp's half of dQ's columns

  for (int kt = 0; kt < n_tiles; ++kt) {
    // Tile kt has arrived, and every thread is done with tile kt - 1: its
    // stage takes tile kt + kStages - 1, and P may be written again.
    cp_async_wait<G::kStages - 2>();
    __syncthreads();
    fetch(kt + G::kStages - 1);
    const float* Ks = ring + (kt % G::kStages) * G::kStageFloats;
    const float* Vs = Ks + kKeys * kRow;

    // S (warps 0-3) or dP: row row0 + lane / 4, keys kt 8 + 2 (lane % 4) + 0, 1.
    float sc[64];
    lane_scores<NGROUP, kRow, kRow, G::kScoreVec, G::kScoreUnroll>(sc, rows, p_warp ? Ks : Vs,
                                                                   lane);
    fold_lanes<G::kXorBits>(sc, lane);
    if (p_warp) {
      const int key = kt * kKeys + 2 * (lane & 3);
      *reinterpret_cast<float2*>(S + at) =
          make_float2(key < n ? fast_exp2(fmaf(sc[0], scale2, row_value)) : 0.f,
                      key + 1 < n ? fast_exp2(fmaf(sc[1], scale2, row_value)) : 0.f);
      barrier_arrive(pair, 64);
      barrier_sync(pair + 4, 64);
    } else {
      barrier_sync(pair, 64);
      const float2 p = *reinterpret_cast<const float2*>(S + at);
      *reinterpret_cast<float2*>(S + at) =
          make_float2(p.x * (sc[0] - row_value) * scale, p.y * (sc[1] - row_value) * scale);
      barrier_arrive(pair + 4, 64);
      __syncwarp();
    }

    // dQ += dS K over this warp's half of the columns.
    product_nn<8, 2 * NGROUP, kKeys, kKeys, kRow, 32, 1>(acc, S, Ks + col0, lane);
  }
  cp_async_wait<0>();

  float* dqb = dq + b * sdq.b + h * sdq.h;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = q0 + row0 + i;
    if (r >= n) continue;
#pragma unroll
    for (int e = 0; e < NGROUP / 2; ++e) {
      const int c = col0 + 4 * lane + 128 * e;
      if (c < width) {
        store4(dqb + (long long)r * sdq.n + c,
               make_float4(acc[i][4 * e], acc[i][4 * e + 1], acc[i][4 * e + 2],
                           acc[i][4 * e + 3]));
      }
    }
  }
}

template <int NGROUP>
int launch_dq_f32_wide(const void* q, const void* k, const void* v, const void* d_o,
                       const float* lse, const float* di, void* dq, int batch, int heads, int n,
                       int width, const long long* st, float scale, cudaStream_t stream) {
  using G = Dq32Wide<NGROUP>;
  auto kernel = flash_bwd_dq_float32_wide_kernel<NGROUP>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)G::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + G::kRows - 1) / G::kRows, batch * heads);
  kernel<<<grid, kThreads, G::kSmemBytes, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)d_o, lse, di, (float*)dq,
      heads, n, width, Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
      Strides{st[6], st[7], st[8]}, Strides{st[9], st[10], st[11]},
      Strides{st[12], st[13], st[14]}, scale);
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// bfloat16, head widths that are multiples of 8 up to 128: the tensor cores.
//
// One block = 128 query rows of one (batch, head), two warpgroups of 64 rows,
// and a third that starts every copy. Q and dO are copied once and stay; the
// rows' lse and di are read once into registers. K and V tiles of KEYS keys
// go through a three-stage ring of 16-byte `cp.async` copies (one barrier per
// tile; tile t + 2 is copied while tiles t and t + 1 are in use). NATOM is
// the number of 64-column atoms of the head width. KEYS is 128 at one atom
// (64-key tiles measured 1.2 x slower there); at two, dQ's 64 x 128 sums
// beside two 64 x 128 score tiles and the packed dS would pass the registers
// a thread may have, and Q and dO resident (64 KB) leave room for no three
// stages of 128 keys: 64-key tiles there.
//
// Per key tile: S = Q K^T and dP = dO V^T (K and V read K-major),
// P = 2^(S scale2 - lse2) and dS = P (dP scale - di scale) in registers, dS
// written over dP, rounded to bfloat16 and packed as the A operand of
// dQ += dS K, with K read MN-major from the same tile its copy wrote. With
// dS_t packed a warpgroup starts S_{t+1}, dP_{t+1} and dQ += dS_t K_t
// together, waits for the first two, and does the arithmetic of tile t + 1
// while the third still runs.
// ---------------------------------------------------------------------------

constexpr int kDqRows = 128;                              // queries a block
constexpr int kDqStages = 3;
constexpr uint32_t kDqQueryTileBytes = kDqRows * kRowBytes;   // one atom of Q or dO

// Keys a tile, by the number of atoms of the head width.
template <int NATOM>
constexpr int kDqKeys = NATOM == 1 ? 128 : 64;

// d (64 x KEYS) = A (64 x 16) . B^T (KEYS x 16), both K-major tiles.
template <int KEYS>
__device__ __forceinline__ void wgmma_scores(float (&d)[KEYS / 2], uint64_t a, uint64_t b,
                                             int accumulate) {
  if constexpr (KEYS == 128) {
    wgmma_m64n128k16_ss(d, a, b, accumulate);
  } else {
    wgmma_m64n64k16_ss(d, a, b, accumulate);
  }
}

// Every register a product of the coming stage reads or writes is fenced
// before the stage's first `wgmma`: a register fence between two products of
// one stage makes the assembler run them one after the other.
template <int NATOM, int KEYS>
__device__ __forceinline__ void open_stage(float (&s)[KEYS / 2], float (&dp)[KEYS / 2],
                                           float (&acc)[NATOM][32]) {
  fence_registers(s);
  fence_registers(dp);
#pragma unroll
  for (int a = 0; a < NATOM; ++a) fence_registers(acc[a]);
  wgmma_fence();
}

// Start S = Q K^T and dP = dO V^T (64 x KEYS for this warpgroup) over the
// head width.
template <int NATOM, int KEYS>
__device__ __forceinline__ void start_scores(float (&s)[KEYS / 2], float (&dp)[KEYS / 2],
                                             uint32_t q_tiles, uint32_t do_tiles,
                                             uint32_t k_tiles, uint32_t v_tiles) {
#pragma unroll
  for (int ks = 0; ks < NATOM * 4; ++ks) {
    const uint32_t query_atom = (ks >> 2) * kDqQueryTileBytes;
    const uint32_t key_atom = (ks >> 2) * (KEYS * kRowBytes);
    const uint64_t step = (ks & 3) * kDescNextColumns16;
    wgmma_scores<KEYS>(s, tile_descriptor(q_tiles + query_atom) + step,
                       tile_descriptor(k_tiles + key_atom) + step, ks > 0);
    wgmma_scores<KEYS>(dp, tile_descriptor(do_tiles + query_atom) + step,
                       tile_descriptor(v_tiles + key_atom) + step, ks > 0);
  }
  wgmma_commit();
}

// Start dQ += dS K with dS as register fragments.
template <int NATOM, int KEYS>
__device__ __forceinline__ void start_dq(float (&acc)[NATOM][32],
                                         const uint32_t (&dsa)[KEYS / 16][4], uint32_t k_tiles) {
#pragma unroll
  for (int ks = 0; ks < KEYS / 16; ++ks) {
#pragma unroll
    for (int a = 0; a < NATOM; ++a) {
      wgmma_m64n64k16_rs_tb(acc[a], dsa[ks],
                            tile_descriptor(k_tiles + a * (KEYS * kRowBytes)) +
                                ks * kDescNextRows16);
    }
  }
  wgmma_commit();
}

// In place: dp <- dS = P (dP - di) scale with P = exp(S scale - lse), in base
// 2 and with each difference as one multiply-add. Entry [4 j + i] is key
// k0 + 8 j + 2 (lane % 4) + i % 2 of row i / 2 of the thread's pair. Keys
// past n have zero K and V rows (S = dP = 0) but a P that need not be finite:
// their dS is set to 0, not multiplied to it. Query rows past n have zero Q
// and dO rows and zero lse and di, so their dS is 0; they are not stored.
template <int KEYS>
__device__ __forceinline__ void score_gradients(const float (&s)[KEYS / 2], float (&dp)[KEYS / 2],
                                                const float (&neg_lse2)[2],
                                                const float (&neg_di_scaled)[2], float scale,
                                                float scale2, int k0, int n) {
  const int lane = threadIdx.x & 31;
  const bool ragged = k0 + KEYS > n;
#pragma unroll
  for (int j = 0; j < KEYS / 8; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float p = fast_exp2(fmaf(s[4 * j + i], scale2, neg_lse2[i >> 1]));
      float ds = p * fmaf(dp[4 * j + i], scale, neg_di_scaled[i >> 1]);
      if (ragged && k0 + 8 * j + 2 * (lane & 3) + (i & 1) >= n) ds = 0.f;
      dp[4 * j + i] = ds;
    }
  }
}

template <int NATOM>
__global__ void __launch_bounds__(kTcThreads + kCopyThreads, 1)
flash_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const bf16* __restrict__ d_o,
                       const float* __restrict__ lse, const float* __restrict__ di,
                       bf16* __restrict__ dq, int heads, int n, int width, Strides sq, Strides sk,
                       Strides sv, Strides sdo, Strides sdq, float scale) {
  constexpr int KEYS = kDqKeys<NATOM>;
  constexpr uint32_t kKeyTileBytes = KEYS * kRowBytes;          // one atom of K or V
  constexpr uint32_t kStageBytes = 2 * NATOM * kKeyTileBytes;   // K's atoms, then V's
  extern __shared__ char smem_raw[];
  const uint32_t Qs = (smem_addr(smem_raw) + 1023u) & ~1023u;   // NATOM tiles
  const uint32_t dOs = Qs + NATOM * kDqQueryTileBytes;          // NATOM tiles
  const uint32_t KVs = dOs + NATOM * kDqQueryTileBytes;         // kDqStages stages

  const int lane = threadIdx.x & 31, wg = threadIdx.x >> 7;
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int q0 = blockIdx.x * kDqRows;
  const int n_tiles = (n + KEYS - 1) / KEYS;

  if (threadIdx.x >= kTcThreads) {
    registers_dec<kCopyRegisters>();
    // The copying warpgroup. It meets the multiplying warps at one barrier per
    // tile: there tile t + 1 has arrived and tile t - 1 is no longer read,
    // so the copy of tile t + 2 may overwrite its stage.
    const int loader = threadIdx.x - kTcThreads;
    const bf16* qb = q + b * sq.b + h * sq.h;
    const bf16* kb = k + b * sk.b + h * sk.h;
    const bf16* vb = v + b * sv.b + h * sv.h;
    const bf16* dob = d_o + b * sdo.b + h * sdo.h;
    auto load_kv = [&](int kt) {
      if (kt < n_tiles) {
        const uint32_t stage = KVs + (kt % kDqStages) * kStageBytes;
#pragma unroll
        for (int a = 0; a < NATOM; ++a) {
          load_tile_async(stage + a * kKeyTileBytes, kb, sk.n, kt * KEYS, n, KEYS, a * kAtom,
                          width, loader, kCopyThreads);
          load_tile_async(stage + (NATOM + a) * kKeyTileBytes, vb, sv.n, kt * KEYS, n, KEYS,
                          a * kAtom, width, loader, kCopyThreads);
        }
      }
      cp_async_commit();   // an empty group past the last tile keeps the count of groups
    };
#pragma unroll
    for (int a = 0; a < NATOM; ++a) {
      load_tile_async(Qs + a * kDqQueryTileBytes, qb, sq.n, q0, n, kDqRows, a * kAtom, width,
                      loader, kCopyThreads);
      load_tile_async(dOs + a * kDqQueryTileBytes, dob, sdo.n, q0, n, kDqRows, a * kAtom, width,
                      loader, kCopyThreads);
    }
    load_kv(0);
    load_kv(1);
    cp_async_wait_and_publish<1>();   // Q, dO and tile 0
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
  const float scale2 = scale * kLog2e;
  float neg_lse2[2], neg_di_scaled[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = q0 + wg * 64 + ((threadIdx.x >> 5) & 3) * 16 + (lane >> 2) + 8 * r;
    neg_lse2[r] = row < n ? -lse[(long long)bh * n + row] * kLog2e : 0.f;
    neg_di_scaled[r] = row < n ? -di[(long long)bh * n + row] * scale : 0.f;
  }
  float acc[NATOM][32];
#pragma unroll
  for (int a = 0; a < NATOM; ++a) {
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[a][i] = 0.f;
  }
  const uint32_t q_tiles = Qs + wg * 64 * kRowBytes;     // this warpgroup's 64 rows of Q
  const uint32_t do_tiles = dOs + wg * 64 * kRowBytes;   // and of dO

  // Tile 0 alone: its scores, dS_0 packed.
  float s[KEYS / 2], dp[KEYS / 2];
  uint32_t dsa[KEYS / 16][4];
  __syncthreads();
  open_stage<NATOM, KEYS>(s, dp, acc);
  start_scores<NATOM, KEYS>(s, dp, q_tiles, do_tiles, KVs, KVs + NATOM * kKeyTileBytes);
  wgmma_wait<0>();
  fence_registers(s);
  fence_registers(dp);
  score_gradients<KEYS>(s, dp, neg_lse2, neg_di_scaled, scale, scale2, 0, n);
#pragma unroll
  for (int ks = 0; ks < KEYS / 16; ++ks) pack_fragment(dsa[ks], dp, ks);

  // No `wgmma` sits under a condition: the assembler runs the products of a
  // stage one after the other when one of them does.
  for (int kt = 0; kt + 1 < n_tiles; ++kt) {
    // Tile kt + 1 has arrived, and both warpgroups are done with tile kt - 1.
    const uint32_t next = KVs + ((kt + 1) % kDqStages) * kStageBytes;
    __syncthreads();
    open_stage<NATOM, KEYS>(s, dp, acc);
    start_scores<NATOM, KEYS>(s, dp, q_tiles, do_tiles, next, next + NATOM * kKeyTileBytes);
    start_dq<NATOM, KEYS>(acc, dsa, KVs + (kt % kDqStages) * kStageBytes);
    wgmma_wait<1>();   // S and dP of tile kt + 1 are there; dS_kt K_kt still runs
    fence_registers(s);
    fence_registers(dp);
    score_gradients<KEYS>(s, dp, neg_lse2, neg_di_scaled, scale, scale2, (kt + 1) * KEYS, n);
    wgmma_wait<0>();
    fence_fragments(dsa);
#pragma unroll
    for (int a = 0; a < NATOM; ++a) fence_registers(acc[a]);
#pragma unroll
    for (int ks = 0; ks < KEYS / 16; ++ks) pack_fragment(dsa[ks], dp, ks);
  }
  // The last tile's dS K.
  open_stage<NATOM, KEYS>(s, dp, acc);
  start_dq<NATOM, KEYS>(acc, dsa, KVs + ((n_tiles - 1) % kDqStages) * kStageBytes);
  wgmma_wait<0>();
  fence_fragments(dsa);
#pragma unroll
  for (int a = 0; a < NATOM; ++a) fence_registers(acc[a]);

  bf16* dqb = dq + b * sdq.b + h * sdq.h;
#pragma unroll
  for (int a = 0; a < NATOM; ++a) {
    store_accumulator(dqb, sdq.n, q0 + wg * 64, n, a * kAtom, width, acc[a], 1.f, 1.f);
  }
}

template <int NATOM>
int launch_dq_tc(const void* q, const void* k, const void* v, const void* d_o, const float* lse,
                 const float* di, void* dq, int batch, int heads, int n, int width,
                 const long long* st, float scale, cudaStream_t stream) {
  // Q and dO resident, the stages of K and V, and the slack to align the
  // first tile.
  const size_t smem = (size_t)2 * NATOM * kDqQueryTileBytes +
                      (size_t)kDqStages * 2 * NATOM * kDqKeys<NATOM> * kRowBytes + 1024;
  auto kernel = flash_bwd_dq_tc_kernel<NATOM>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + kDqRows - 1) / kDqRows, batch * heads);
  kernel<<<grid, kTcThreads + kCopyThreads, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)d_o, lse, di, (bf16*)dq, heads,
      n, width, Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
      Strides{st[6], st[7], st[8]}, Strides{st[9], st[10], st[11]},
      Strides{st[12], st[13], st[14]}, scale);
  return (int)cudaGetLastError();
}

}  // namespace rgie

// q, k, v, d_o, dq: (batch, heads, n, width) with the width axis contiguous;
// `strides` holds (batch, head, row) strides in elements for them in that
// order (15 values). lse, di: (batch, heads, n) float32, contiguous. Returns
// cudaGetLastError() (0 on success), or -1 for a width or a grid the kernel
// does not take. Dispatch by shape (``kernel_route`` in
// ops/kernels/flash_attention.py states the same rule): bfloat16 with a
// width that is a multiple of 8 up to 128 runs the tensor-core kernel
// ("tensor"; its tensors 16-byte aligned, strides multiples of 8 elements);
// float32 up to width 128 the float32 kernel and above 128 the wide float32
// kernel ("float32"; both 16-byte aligned, strides multiples of 4); every
// other bfloat16 width the first CUDA-core kernel ("cuda_cores").
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
    const int atoms = atoms_for_width(width);
    if (atoms == 1) {
      return launch_dq_tc<1>(q, k, v, d_o, lse, di, dq, batch, heads, n, width, strides, scale,
                             s);
    }
    if (atoms == 2) {
      return launch_dq_tc<2>(q, k, v, d_o, lse, di, dq, batch, heads, n, width, strides, scale,
                             s);
    }
    if (chunks == 1) RGIE_DQ(__nv_bfloat16, 1);
    if (chunks == 2) RGIE_DQ(__nv_bfloat16, 2);
    RGIE_DQ(__nv_bfloat16, 8);
  }
  if (chunks == 1) {
    return launch_dq_f32<1>(q, k, v, d_o, lse, di, dq, batch, heads, n, width, strides, scale, s);
  }
  if (chunks == 2) {
    return launch_dq_f32<2>(q, k, v, d_o, lse, di, dq, batch, heads, n, width, strides, scale, s);
  }
  if (wide_groups_for_width(width) == 2) {
    return launch_dq_f32_wide<2>(q, k, v, d_o, lse, di, dq, batch, heads, n, width, strides, scale,
                                 s);
  }
  return launch_dq_f32_wide<4>(q, k, v, d_o, lse, di, dq, batch, heads, n, width, strides, scale,
                               s);
#undef RGIE_DQ
}
