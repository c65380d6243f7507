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
// 6 N d elements moved): the tensor cores' rate for bfloat16 (1.39 ms at
// (2, 5, 16384, 64); 1.11 ms at the VAE's (1, 1, 16384, 512)), the CUDA
// cores' for float32 (20.5 ms; 16.4 ms at the VAE's shape). In every kernel a block owns its key rows and
// walks the query tiles, so each dK and dV element is summed in a fixed
// order: no atomics, and the result is the same from run to run. Scores are
// recomputed from the saved log-sum-exp. P and dS are rounded to the inputs'
// type before the second products (the TPU kernel's `p.T.astype(do.dtype)`,
// `ds.T.astype(do.dtype)`). Five kernels, chosen by type and width in the C
// entry point (`kernel_route` names them):
//
// 1. `flash_bwd_dkv_tc_kernel`: bfloat16, head widths that are multiples of
//    8 up to 128 (the note above the kernel has the design: transposed score
//    tiles by `wgmma`, P^T and dS^T from accumulator registers straight into
//    the second products, K and V resident, Q / dO / lse / di through a
//    `cp.async` ring fed by a third warpgroup). 384 threads, 168 registers
//    each at launch (224 / 56 after `setmaxnreg`, no spill); dynamic shared
//    memory 84 KB (widths up to 64) or 132 KB (up to 128). Measured at that
//    shape on an NVIDIA H100 80GB HBM3 at 700 W (`chip_smoke.py`): 3.38 ms,
//    2.4x its bound (the library's one backward call for dQ, dK and dV takes
//    4.01 ms). The 64 x 64 `wgmma` shape (the widest the registers allow
//    beside two accumulators) and the one barrier per tile are the open items.
// 2. `flash_bwd_dkv_float32_kernel`: float32 at head widths up to 128, on
//    the CUDA cores: K and V resident, Q / dO / lse / di through a two-stage
//    `cp.async` ring, and the four products handed to the block's two warp
//    halves so that each runs with an 8 x 8 register patch (the note above
//    the kernel has the design).
// 3. `flash_bwd_dkv_float32_wide_kernel`: float32 above width 128 up to 512
//    (the VAE's single 512-wide head), on the CUDA cores: whole head rows of
//    32 keys' K and V resident, Q / dO / lse / di tiles of 8 queries through
//    a three-stage `cp.async` ring, each score product one warp's 8 x 8
//    patch split over its lanes by columns and folded by shuffles, the sums
//    (128 a thread at width 512) with 8 x 16 patches (the note above the
//    kernel has the design). Compiled for 2 (widths up to 256) and 4 groups
//    of 128 columns. 255 registers, no spill; 231,616 bytes of dynamic shared
//    memory at width 512. Its times, its bound and what bounds it are in
//    PERF.md (`python -m rgie_tpu_torch.cli.kernel_variants dkv32w`).
// 4. `flash_bwd_dkv_wide_kernel`: bfloat16 above width 128 at multiples of
//    64, up to 512 (the VAE's single 512-wide head), on the tensor cores (the
//    note above the kernel has the design): a block owns 64 keys with K and
//    V resident at the full width, Q / dO / lse / di tiles of 16 queries
//    through a `cp.async` ring fed by a third warpgroup with little work a
//    copy, the 64 x 16 score tiles (`wgmma` m64n16k16) summed over the width
//    in two halves, one a warpgroup, added through shared memory, and the
//    output's columns split over grid.z above width 256 (two groups of four
//    atoms) and over the two warpgroups: 1.5 x the nominal operations at
//    width 512, 1.0 x up to 256. 384 threads, 168 registers each at launch
//    (224 / 56 after `setmaxnreg`, no spill); 214-215 KB of dynamic shared
//    memory. Measured at (1, 1, 16384, 512) on an NVIDIA H100 80GB HBM3 at
//    700 W (`python -m rgie_tpu_torch.cli.kernel_variants dkv16w`): 5.18 ms
//    against 70.5 for kernel 5 in the same call, 3.1 x its bound with the
//    repeat (1.67 ms); the products alone 4.9, the copies alone 3.0-3.1.
// 5. `flash_bwd_dkv_kernel`: the bfloat16 widths the tensor-core kernels do
//    not take, on the CUDA cores (bfloat16 widened to float32 in shared
//    memory). Head widths above 64 are walked in 64-column chunks, the scores
//    summed over the chunks once and one 4x4 patch per chunk and output kept
//    in registers. Up to width 128 a block holds both dK and dV (64
//    registers). At width 512 the two would take 256 registers a thread, so
//    the work is split over grid.z by output: the blocks of z = 0 sum dV
//    (they need P only, so they skip dO V^T), those of z = 1 sum dK. The Q
//    K^T products are then done twice (40 tile products per pair of tiles
//    against the 32 a single block would do), and nothing else is repeated.
//    It served float32 above width 128 too until kernel 3 replaced it there,
//    and bfloat16 at multiples of 64 above 128 until kernel 4 did; it keeps
//    the other bfloat16 widths (multiples of 4 that are not of 8 up to 128,
//    or not of 64 above).
// The edit never differentiates the VAE, so only width 64 is on its path.

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
        Ps[row * kPitch + tx + 16 * bb] = rounded_to_input<T>(p);
        dSs[row * kPitch + tx + 16 * bb] = rounded_to_input<T>(p * (dp[a][bb] - row_di) * scale);
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


// ---------------------------------------------------------------------------
// float32, head widths up to 128: the CUDA cores, a ring of `cp.async`
// copies, and the four products handed to the two halves of the block.
//
// A block owns KEYS = 16 KI key rows; K and V are copied once and stay
// resident. Q, dO, lse and di tiles of QUERIES = 8 QJ queries go through a
// two-stage ring (the copy of tile t + 1 runs while tile t is multiplied).
// A thread could hold only one 8 x 8 patch of a score tile beside one of an
// output (255 registers), and smaller patches are bound by shared-memory
// reads (the float32 set's note in the shared header), so each product
// belongs to one half of the block (warps 0-3, 4-7; a half seen as 16 x 8):
//   half 0: S^T = K Q^T, P^T = exp(S^T scale - lse) -> shared memory;
//   half 1: dP^T = V dO^T -> shared memory;
//   (barrier) half 1: dS^T = P^T (dP^T - di) scale over its own entries;
//   (barrier) half 0: dV += P^T dO;  half 1: dK += dS^T Q.
// A thread: KI keys (ty + 16 i) x QJ queries (tx + 8 j) of a score tile, KI
// keys x 8 columns (4 tx + 32 e) of each 64-column chunk of dV or dK. The
// sums run over the tile's queries in a fixed order: no atomics. Three
// barriers a tile. Width up to 64: KI = QJ = 8 (128 keys, 64 queries, every
// product 0.25 values read a multiply-add); up to 128: KI = QJ = 4, so that
// the resident K and V and two stages fit in shared memory.
// ---------------------------------------------------------------------------

template <int NCHUNK, int KI, int QJ>
struct Dkv32 {
  static constexpr int kKeys = 16 * KI;
  static constexpr int kQueries = 8 * QJ;
  static constexpr int kDPitch = 64 * NCHUNK + 4;            // % 32 == 4
  static constexpr int kTPitch = kQueries + 8;               // % 32 == 8
  static constexpr int kStageFloats = 2 * kQueries * kDPitch + 2 * kQueries;
  static constexpr size_t kSmemBytes =
      sizeof(float) * (2 * (size_t)kKeys * kDPitch + 2 * (size_t)kKeys * kTPitch +
                       2 * (size_t)kStageFloats);
};

template <int NCHUNK, int KI, int QJ>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_float32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                             const float* __restrict__ v, const float* __restrict__ d_o,
                             const float* __restrict__ lse, const float* __restrict__ di,
                             float* __restrict__ dk, float* __restrict__ dv, int heads, int n,
                             int width, Strides sq, Strides sk, Strides sv, Strides sdo,
                             Strides sdk, Strides sdv, float scale) {
  using G = Dkv32<NCHUNK, KI, QJ>;
  constexpr int kKeys = G::kKeys, kQueries = G::kQueries, kDP = G::kDPitch, kTP = G::kTPitch;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + kKeys * kDP;
  float* Pt = Vs + kKeys * kDP;
  float* dSt = Pt + kKeys * kTP;
  float* ring = dSt + kKeys * kTP;   // 2 stages: Q, dO, lse, di
  const uint32_t ring_addr = smem_addr(ring);

  const int half = threadIdx.x >> 7, t = threadIdx.x & 127;
  const int ty = t >> 3, tx = t & 7;
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int k0 = blockIdx.x * kKeys;
  const float* qb = q + b * sq.b + h * sq.h;
  const float* dob = d_o + b * sdo.b + h * sdo.h;
  const float* lse_b = lse + (long long)bh * n;
  const float* di_b = di + (long long)bh * n;
  const int nc = (width + 63) / 64;
  const int n_tiles = (n + kQueries - 1) / kQueries;

  // Query tile qt into stage qt % 2: Q's and dO's chunks, then lse and di.
  auto fetch = [&](int qt) {
    if (qt < n_tiles) {
      const int q0 = qt * kQueries;
      const uint32_t stage = ring_addr + (uint32_t)((qt & 1) * G::kStageFloats) * 4u;
      for (int c = 0; c < nc; ++c) {
        copy_tile_f32<kQueries, kDP>(stage + (uint32_t)(c * 64) * 4u, qb, sq.n, q0, n, c * 64,
                                     width);
        copy_tile_f32<kQueries, kDP>(stage + (uint32_t)(kQueries * kDP + c * 64) * 4u, dob,
                                     sdo.n, q0, n, c * 64, width);
      }
      if (threadIdx.x < 2 * kQueries) {
        const int r = threadIdx.x % kQueries;
        const bool valid = q0 + r < n;
        const float* src = threadIdx.x < kQueries ? lse_b : di_b;
        cp_async_4(stage + (uint32_t)(2 * kQueries * kDP + threadIdx.x) * 4u,
                   valid ? src + q0 + r : src, valid);
      }
    }
    cp_async_commit();
  };

  for (int c = 0; c < nc; ++c) {
    copy_tile_f32<kKeys, kDP>(smem_addr(Ks + c * 64), k + b * sk.b + h * sk.h, sk.n, k0, n,
                              c * 64, width);
    copy_tile_f32<kKeys, kDP>(smem_addr(Vs + c * 64), v + b * sv.b + h * sv.h, sv.n, k0, n,
                              c * 64, width);
  }
  fetch(0);   // K and V ride with tile 0

  // dV (half 0) or dK (half 1): keys ty + 16 i, columns 64 c + 4 tx + 32 e.
  float acc[NCHUNK][KI][8];
#pragma unroll
  for (int c = 0; c < NCHUNK; ++c) {
#pragma unroll
    for (int i = 0; i < KI; ++i) {
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[c][i][e] = 0.f;
    }
  }
  const float scale2 = scale * kLog2e;
  const float* A = half == 0 ? Ks : Vs;      // the score product's resident operand
  float* T = half == 0 ? Pt : dSt;           // where its result goes
  const float* Tsum = half == 0 ? Pt : dSt;  // the sum's left operand

  for (int qt = 0; qt < n_tiles; ++qt) {
    // Tile qt has arrived, and every thread is done with tile qt - 1: its
    // stage takes tile qt + 1, and P^T and dS^T may be written again.
    cp_async_wait<0>();
    __syncthreads();
    fetch(qt + 1);
    const float* Qs = ring + (qt & 1) * G::kStageFloats;
    const float* dOs = Qs + kQueries * kDP;
    const float* lse_s = dOs + kQueries * kDP;
    const float* di_s = lse_s + kQueries;
    const float* B = half == 0 ? Qs : dOs;

    // S^T (half 0) or dP^T (half 1): entry [i][j] is key k0 + ty + 16 i,
    // query tx + 8 j of the tile. Queries past n have zero Q, dO, lse and di:
    // their P is 1 and meets only zeros. Keys past n reach only rows that
    // are not stored.
    float sc[KI][QJ];
#pragma unroll
    for (int i = 0; i < KI; ++i) {
#pragma unroll
      for (int j = 0; j < QJ; ++j) sc[i][j] = 0.f;
    }
#pragma unroll
    for (int c = 0; c < NCHUNK; ++c) {
      if (c < nc) product_nt<KI, QJ, kDP, kDP, 8, 16>(sc, A + c * 64, B + c * 64, t);
    }
    if (half == 0) {
#pragma unroll
      for (int j = 0; j < QJ; ++j) {
        const float neg_lse2 = -lse_s[tx + 8 * j] * kLog2e;   // base 2, one fma a score
#pragma unroll
        for (int i = 0; i < KI; ++i) sc[i][j] = fast_exp2(fmaf(sc[i][j], scale2, neg_lse2));
      }
    }
#pragma unroll
    for (int i = 0; i < KI; ++i) {
#pragma unroll
      for (int j = 0; j < QJ; ++j) T[(ty + 16 * i) * kTP + tx + 8 * j] = sc[i][j];
    }
    __syncthreads();
    // (Splitting this between the halves, each finishing half the entries,
    // was slower: 35.96 against 33.77 ms on an NVIDIA H100 80GB HBM3 at 700 W.)
    if (half == 1) {
#pragma unroll
      for (int j = 0; j < QJ; ++j) {
        const float col_di = di_s[tx + 8 * j];
#pragma unroll
        for (int i = 0; i < KI; ++i) {
          const int at = (ty + 16 * i) * kTP + tx + 8 * j;
          dSt[at] = Pt[at] * (sc[i][j] - col_di) * scale;
        }
      }
    }
    __syncthreads();

    // dV += P^T dO (half 0), dK += dS^T Q (half 1).
    const float* X = half == 0 ? dOs : Qs;
#pragma unroll
    for (int c = 0; c < NCHUNK; ++c) {
      if (c < nc) product_nn<KI, 8, kQueries, kTP, kDP, 8, 16>(acc[c], Tsum, X + c * 64, t);
    }
  }
  cp_async_wait<0>();

  float* out = half == 0 ? dv + b * sdv.b + h * sdv.h : dk + b * sdk.b + h * sdk.h;
  const long long stride = half == 0 ? sdv.n : sdk.n;
#pragma unroll
  for (int i = 0; i < KI; ++i) {
    const int r = k0 + ty + 16 * i;
    if (r >= n) continue;
#pragma unroll
    for (int c = 0; c < NCHUNK; ++c) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = c * 64 + 4 * tx + 32 * e;
        if (c < nc && col < width) {
          store4(out + (long long)r * stride + col,
                 make_float4(acc[c][i][4 * e], acc[c][i][4 * e + 1], acc[c][i][4 * e + 2],
                             acc[c][i][4 * e + 3]));
        }
      }
    }
  }
}

template <int NCHUNK, int KI, int QJ>
int launch_dkv_f32(const void* q, const void* k, const void* v, const void* d_o, const float* lse,
                   const float* di, void* dk, void* dv, int batch, int heads, int n, int width,
                   const long long* st, float scale, cudaStream_t stream) {
  using G = Dkv32<NCHUNK, KI, QJ>;
  auto kernel = flash_bwd_dkv_float32_kernel<NCHUNK, KI, QJ>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)G::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + G::kKeys - 1) / G::kKeys, batch * heads);
  kernel<<<grid, kThreads, G::kSmemBytes, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)d_o, lse, di, (float*)dk,
      (float*)dv, heads, n, width, Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
      Strides{st[6], st[7], st[8]}, Strides{st[9], st[10], st[11]},
      Strides{st[12], st[13], st[14]}, Strides{st[15], st[16], st[17]}, scale);
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// float32, head widths above 128 up to 512 (the VAE's single 512-wide head):
// the CUDA cores, whole head rows in shared memory, and each score product
// split over a warp's lanes (the wide float32 backward set's note in the
// shared header).
//
// A block owns 32 keys; K and V (128 KB at width 512) are copied once and
// stay. Q, dO, lse and di tiles of 8 queries go through a three-stage
// `cp.async` ring (32 KB a stage; the copy of tile t + 2 starts at tile t),
// so each block reads Q and dO once from the L2 cache: (N / 32) N 128 NGROUP
// 8 bytes, 32.2 GB at (1, 1, 16384, 512).
// A pair of warps w and w + 4 owns keys 8 w .. 8 w + 7:
//   warp w:     S^T = K Q^T (its 8 keys x the tile's 8 queries), P^T =
//               exp(S^T scale - lse) -> shared memory; signals warp w + 4;
//   warp w + 4: dP^T = V dO^T, waits for warp w, dS^T = P^T (dP^T - di)
//               scale -> shared memory;
//   then warp w: dV += P^T dO, warp w + 4: dK += dS^T Q, each for its 8 keys
//   and every column (lane l: columns 4 l + 128 e), 8 x 4 NGROUP sums a
//   thread (128 registers at width 512).
// A pair meets only itself within a tile (named barrier 1 + w, 64 threads);
// the block meets once a tile, where the next stage's copy starts. Each dK
// and dV element is summed over the query tiles in order, and each score
// over the lanes in the fold's fixed order: no atomics. Queries past n have
// zero Q, dO, lse and di: their P is 1 and meets only zeros. Keys past n
// reach only rows that are not stored.
// ---------------------------------------------------------------------------

template <int NGROUP>
struct Dkv32Wide {
  static constexpr int kKeys = 32;                           // keys a block
  static constexpr int kQueries = 8;                         // queries a tile
  static constexpr int kRow = 128 * NGROUP;                  // floats a row of K, V, Q, dO
  static constexpr int kStages = 3;                          // of the ring
  static constexpr int kStageFloats = 2 * kQueries * kRow + 2 * kQueries;   // Q, dO, lse, di
  static constexpr int kScoreFloats = kKeys * kQueries;      // P^T or dS^T
  // At width 512, where the 128 sums a thread leave few registers beside the
  // 64 partial scores, the score product reads float2 pairs and its loop
  // over the column groups stays rolled up: both measured faster there than
  // float4 reads and the unrolled loop, which made ptxas move and spill
  // registers; at width 256 (64 sums) the unrolled loop is the faster
  // (`kernel_variants dkv32w_float4`, `dkv32w_unrolled`; PERF.md).
  static constexpr int kScoreVec = NGROUP == 4 ? 2 : 4;
  static constexpr int kScoreUnroll = NGROUP == 4 ? 1 : NGROUP;
  static constexpr int kXorBits = 0;                         // `lane_rows`
  static constexpr size_t kSmemBytes =
      sizeof(float) * (2 * (size_t)kKeys * kRow + 2 * (size_t)kScoreFloats +
                       kStages * (size_t)kStageFloats);
};

template <int NGROUP>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_dkv_float32_wide_kernel(const float* __restrict__ q, const float* __restrict__ k,
                                  const float* __restrict__ v, const float* __restrict__ d_o,
                                  const float* __restrict__ lse, const float* __restrict__ di,
                                  float* __restrict__ dk, float* __restrict__ dv, int heads, int n,
                                  int width, Strides sq, Strides sk, Strides sv, Strides sdo,
                                  Strides sdk, Strides sdv, float scale) {
  using G = Dkv32Wide<NGROUP>;
  constexpr int kKeys = G::kKeys, kQueries = G::kQueries, kRow = G::kRow;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;
  float* Vs = Ks + kKeys * kRow;
  float* Pt = Vs + kKeys * kRow;             // P^T: 32 keys x 8 queries
  float* dSt = Pt + G::kScoreFloats;         // dS^T
  float* ring = dSt + G::kScoreFloats;       // kStages stages: Q, dO, lse, di
  const uint32_t ring_addr = smem_addr(ring);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool p_warp = warp < 4;              // P^T and dV; else dS^T and dK
  const int key0 = 8 * (warp & 3);           // the pair's keys within the block
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int k0 = blockIdx.x * kKeys;
  const int n_tiles = (n + kQueries - 1) / kQueries;

  // The streamed tensors of this (batch, head) are found through shared
  // memory at each tile, not held in registers across the loop: at width
  // 512 the 128 sums, the 64 partial scores and their operands leave few to
  // spare, and holding the four pointers measured slower
  // (`kernel_variants dkv32w_pointers_in_registers`).
  __shared__ const float* streamed[4];   // Q, dO, lse, di
  if (threadIdx.x == 0) {
    streamed[0] = q + b * sq.b + h * sq.h;
    streamed[1] = d_o + b * sdo.b + h * sdo.h;
    streamed[2] = lse + (long long)bh * n;
    streamed[3] = di + (long long)bh * n;
  }
  __syncthreads();

  // Query tile qt into stage qt % kStages: Q's rows, dO's rows, lse and di.
  auto fetch = [&](int qt) {
    if (qt < n_tiles) {
      const uint32_t stage = ring_addr + (uint32_t)((qt % G::kStages) * G::kStageFloats) * 4u;
      const int q0 = qt * kQueries;
      copy_tile_f32<kQueries, kRow, kRow>(stage, streamed[0], sq.n, q0, n, 0, width);
      copy_tile_f32<kQueries, kRow, kRow>(stage + (uint32_t)(kQueries * kRow) * 4u, streamed[1],
                                          sdo.n, q0, n, 0, width);
      if (threadIdx.x < 2 * kQueries) {
        const int r = threadIdx.x % kQueries;
        const bool valid = q0 + r < n;
        const float* src = streamed[2 + threadIdx.x / kQueries];
        cp_async_4(stage + (uint32_t)(2 * kQueries * kRow + threadIdx.x) * 4u,
                   valid ? src + q0 + r : src, valid);
      }
    }
    cp_async_commit();
  };

  copy_tile_f32<kKeys, kRow, kRow>(smem_addr(Ks), k + b * sk.b + h * sk.h, sk.n, k0, n, 0, width);
  copy_tile_f32<kKeys, kRow, kRow>(smem_addr(Vs), v + b * sv.b + h * sv.h, sv.n, k0, n, 0, width);
#pragma unroll
  for (int qt = 0; qt + 1 < G::kStages; ++qt) fetch(qt);   // K and V ride with tile 0

  float acc[8][4 * NGROUP];   // dV (warps 0-3) or dK: keys key0 + i, columns 4 lane + 128 e + c
#pragma unroll
  for (int i = 0; i < 8; ++i) {
#pragma unroll
    for (int e = 0; e < 4 * NGROUP; ++e) acc[i][e] = 0.f;
  }
  const float scale2 = scale * kLog2e;
  // The score product's resident rows, in this lane's order.
  const auto rows = lane_rows<G::kXorBits, kRow>((p_warp ? Ks : Vs) + key0 * kRow, lane);
  // Its 8 x 8 result, then the left operand of the sums.
  float* T = (p_warp ? Pt : dSt) + key0 * kQueries;
  const int at = (lane >> 2) * kQueries + 2 * (lane & 3);   // this lane's two entries of it
  const int pair = 1 + (warp & 3);

  for (int qt = 0; qt < n_tiles; ++qt) {
    // Tile qt has arrived, and every thread is done with tile qt - 1: its
    // stage takes tile qt + kStages - 1, and P^T and dS^T may be written again.
    cp_async_wait<G::kStages - 2>();
    __syncthreads();
    fetch(qt + G::kStages - 1);
    const float* Qs = ring + (qt % G::kStages) * G::kStageFloats;
    const float* dOs = Qs + kQueries * kRow;
    const float* lse_s = dOs + kQueries * kRow;
    const float* di_s = lse_s + kQueries;

    // S^T (warps 0-3) or dP^T: key key0 + lane / 4, queries 2 (lane % 4) + 0, 1.
    float sc[64];
    lane_scores<NGROUP, kRow, kRow, G::kScoreVec, G::kScoreUnroll>(sc, rows, p_warp ? Qs : dOs,
                                                                   lane);
    fold_lanes<G::kXorBits>(sc, lane);
    const int col = 2 * (lane & 3);
    if (p_warp) {
      const float2 l2 = *reinterpret_cast<const float2*>(lse_s + col);
      *reinterpret_cast<float2*>(T + at) =
          make_float2(fast_exp2(fmaf(sc[0], scale2, -l2.x * kLog2e)),
                      fast_exp2(fmaf(sc[1], scale2, -l2.y * kLog2e)));
      barrier_arrive(pair, 64);
    } else {
      barrier_sync(pair, 64);
      const float2 p = *reinterpret_cast<const float2*>(Pt + key0 * kQueries + at);
      const float2 d2 = *reinterpret_cast<const float2*>(di_s + col);
      *reinterpret_cast<float2*>(T + at) =
          make_float2(p.x * (sc[0] - d2.x) * scale, p.y * (sc[1] - d2.y) * scale);
    }
    __syncwarp();

    // dV += P^T dO (warps 0-3), dK += dS^T Q (warps 4-7).
    product_nn<8, 4 * NGROUP, kQueries, kQueries, kRow, 32, 1>(acc, T, p_warp ? dOs : Qs,
                                                               lane);
  }
  cp_async_wait<0>();

  float* out = p_warp ? dv + b * sdv.b + h * sdv.h : dk + b * sdk.b + h * sdk.h;
  const long long stride = p_warp ? sdv.n : sdk.n;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = k0 + key0 + i;
    if (r >= n) continue;
#pragma unroll
    for (int e = 0; e < NGROUP; ++e) {
      const int c = 4 * lane + 128 * e;
      if (c < width) {
        store4(out + (long long)r * stride + c,
               make_float4(acc[i][4 * e], acc[i][4 * e + 1], acc[i][4 * e + 2],
                           acc[i][4 * e + 3]));
      }
    }
  }
}

template <int NGROUP>
int launch_dkv_f32_wide(const void* q, const void* k, const void* v, const void* d_o,
                        const float* lse, const float* di, void* dk, void* dv, int batch,
                        int heads, int n, int width, const long long* st, float scale,
                        cudaStream_t stream) {
  using G = Dkv32Wide<NGROUP>;
  auto kernel = flash_bwd_dkv_float32_wide_kernel<NGROUP>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)G::kSmemBytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + G::kKeys - 1) / G::kKeys, batch * heads);
  kernel<<<grid, kThreads, G::kSmemBytes, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (const float*)d_o, lse, di, (float*)dk,
      (float*)dv, heads, n, width, Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
      Strides{st[6], st[7], st[8]}, Strides{st[9], st[10], st[11]},
      Strides{st[12], st[13], st[14]}, Strides{st[15], st[16], st[17]}, scale);
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// bfloat16, head widths that are multiples of 8 up to 128: the tensor cores.
//
// The tiles are computed transposed, keys as the accumulator's rows:
//   S^T = K Q^T,  dP^T = V dO^T     (64 keys x 64 queries per warpgroup),
// so that P^T and dS^T land in accumulator registers and are, rounded to
// bfloat16, the A operands of dV += P^T dO and dK += dS^T Q, with dO and Q
// read MN-major from the same tiles. lse and di index the fragment's columns.
//
// NATOM = 1 (widths up to 64): a block owns 128 keys, 64 per warpgroup.
// NATOM = 2 (up to 128): dK and dV of 64 keys x 128 columns would take 128
// registers beside the two score tiles, so a block owns 64 keys, both
// warpgroups compute their scores, and each sums one 64-column half of dK
// and dV. K and V stay resident; Q, dO, lse and di tiles of 64 queries go
// through a three-stage ring of `cp.async` copies started by a third warpgroup, one
// barrier per tile.
//
// A warpgroup overlaps its exponentials with its second products: with
// P^T_t and dS^T_t packed in registers it starts the two score products of
// tile t + 1 and the two sums of tile t together, waits for the scores
// alone, and computes P^T_{t+1} and dS^T_{t+1} while the sums still run.
// ---------------------------------------------------------------------------

constexpr int kDkvQueries = 64;   // queries a tile
constexpr int kDkvStages = 3;
constexpr uint32_t kDkvQueryTileBytes = kDkvQueries * kRowBytes;

// Every register a product of the coming stage reads or writes is fenced
// before the stage's first `wgmma`: a register fence between two products of
// one stage makes the assembler run them one after the other.
__device__ __forceinline__ void open_stage(float (&st)[32], float (&dpt)[32],
                                           float (&acc_dv)[32], float (&acc_dk)[32]) {
  fence_registers(st);
  fence_registers(dpt);
  fence_registers(acc_dv);
  fence_registers(acc_dk);
  wgmma_fence();
}

// Start S^T = K Q^T and dP^T = V dO^T for this warpgroup's 64 keys.
template <int NATOM>
__device__ __forceinline__ void start_scores_t(float (&st)[32], float (&dpt)[32], uint32_t k_rows,
                                               uint32_t v_rows, uint32_t key_tile_bytes,
                                               uint32_t q_tiles, uint32_t do_tiles) {
#pragma unroll
  for (int ks = 0; ks < NATOM * 4; ++ks) {
    const uint32_t key_atom = (ks >> 2) * key_tile_bytes;
    const uint32_t query_atom = (ks >> 2) * kDkvQueryTileBytes;
    const uint64_t step = (ks & 3) * kDescNextColumns16;
    wgmma_m64n64k16_ss(st, tile_descriptor(k_rows + key_atom) + step,
                       tile_descriptor(q_tiles + query_atom) + step, ks > 0);
    wgmma_m64n64k16_ss(dpt, tile_descriptor(v_rows + key_atom) + step,
                       tile_descriptor(do_tiles + query_atom) + step, ks > 0);
  }
  wgmma_commit();
}

// In place: st <- P^T = exp(S^T scale - lse), dpt <- dS^T = P^T (dP^T - di)
// scale, for a tile of QUERIES queries. Entry [4 j + i] is key row i / 2 of
// the thread's pair, query 8 j + 2 (lane % 4) + i % 2 of the tile. Queries
// past n have zero Q and dO rows and zero lse and di: their P is 1 and meets
// only zeros. Keys past n only reach rows of dK and dV that are not stored.
template <int QUERIES = kDkvQueries>
__device__ __forceinline__ void probabilities_t(float (&st)[QUERIES / 2],
                                                float (&dpt)[QUERIES / 2], const float* lse_s,
                                                const float* di_s, float scale, float scale2) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < QUERIES / 8; ++j) {
    const float2 l2 = *reinterpret_cast<const float2*>(lse_s + 8 * j + 2 * (lane & 3));
    const float2 d2 = *reinterpret_cast<const float2*>(di_s + 8 * j + 2 * (lane & 3));
    const float neg_lse2[2] = {-l2.x * kLog2e, -l2.y * kLog2e};   // base 2, one fma a score
    const float col_di[2] = {d2.x, d2.y};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float p = fast_exp2(fmaf(st[4 * j + i], scale2, neg_lse2[i & 1]));
      st[4 * j + i] = p;
      dpt[4 * j + i] = p * (dpt[4 * j + i] - col_di[i & 1]) * scale;
    }
  }
}

template <int NATOM>
__global__ void __launch_bounds__(kTcThreads + kCopyThreads, 1)
flash_bwd_dkv_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, const bf16* __restrict__ d_o,
                        const float* __restrict__ lse, const float* __restrict__ di,
                        bf16* __restrict__ dk, bf16* __restrict__ dv, int heads, int n,
                        int width, Strides sq, Strides sk, Strides sv, Strides sdo, Strides sdk,
                        Strides sdv, float scale) {
  constexpr int kKeys = NATOM == 1 ? 128 : 64;   // keys a block
  constexpr uint32_t kKeyTileBytes = kKeys * kRowBytes;
  // A stage: Q's atoms, dO's atoms, 64 lse, 64 di, rounded up to 1024 bytes.
  constexpr uint32_t kStageBytes = 2 * NATOM * kDkvQueryTileBytes + 1024;
  constexpr uint32_t kRowValues = 2 * NATOM * kDkvQueryTileBytes;   // lse, di within a stage
  extern __shared__ char smem_raw[];
  const uint32_t smem0 = smem_addr(smem_raw);
  const uint32_t Ks = (smem0 + 1023u) & ~1023u;      // NATOM tiles
  const uint32_t Vs = Ks + NATOM * kKeyTileBytes;    // NATOM tiles
  const uint32_t ring = Vs + NATOM * kKeyTileBytes;  // kDkvStages stages
  const char* ring_ptr = smem_raw + (ring - smem0);

  const int wg = threadIdx.x >> 7;
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int k0 = blockIdx.x * kKeys;
  const int n_tiles = (n + kDkvQueries - 1) / kDkvQueries;

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
    const float* lse_b = lse + (long long)bh * n;
    const float* di_b = di + (long long)bh * n;
    auto load_queries = [&](int qt) {
      if (qt < n_tiles) {
        const uint32_t stage = ring + (qt % kDkvStages) * kStageBytes;
        const int q0 = qt * kDkvQueries;
#pragma unroll
        for (int a = 0; a < NATOM; ++a) {
          load_tile_async(stage + a * kDkvQueryTileBytes, qb, sq.n, q0, n, kDkvQueries,
                          a * kAtom, width, loader, kCopyThreads);
          load_tile_async(stage + (NATOM + a) * kDkvQueryTileBytes, dob, sdo.n, q0, n,
                          kDkvQueries, a * kAtom, width, loader, kCopyThreads);
        }
#pragma unroll
        for (int r = loader; r < kDkvQueries; r += kCopyThreads) {
          const bool valid = q0 + r < n;
          cp_async_4(stage + kRowValues + r * sizeof(float), valid ? lse_b + q0 + r : lse_b,
                     valid);
          cp_async_4(stage + kRowValues + (kDkvQueries + r) * sizeof(float),
                     valid ? di_b + q0 + r : di_b, valid);
        }
      }
      cp_async_commit();   // an empty group past the last tile keeps the count of groups
    };
#pragma unroll
    for (int a = 0; a < NATOM; ++a) {
      load_tile_async(Ks + a * kKeyTileBytes, kb, sk.n, k0, n, kKeys, a * kAtom, width, loader,
                      kCopyThreads);
      load_tile_async(Vs + a * kKeyTileBytes, vb, sv.n, k0, n, kKeys, a * kAtom, width, loader,
                      kCopyThreads);
    }
    load_queries(0);
    load_queries(1);
    cp_async_wait_and_publish<1>();   // K, V and tile 0
    __syncthreads();
    for (int qt = 0; qt + 1 < n_tiles; ++qt) {
      cp_async_wait_and_publish<0>();   // tile qt + 1
      __syncthreads();
      load_queries(qt + 2);
    }
    return;
  }
  registers_inc<kTcRegisters>();

  const int key_row = NATOM == 1 ? wg * 64 : 0;   // this warpgroup's keys within the block
  const int out_atom = NATOM == 1 ? 0 : wg;       // and its 64 columns of dK and dV

  float acc_dv[32], acc_dk[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc_dv[i] = acc_dk[i] = 0.f;
  const float scale2 = scale * kLog2e;
  const uint32_t k_rows = Ks + key_row * kRowBytes, v_rows = Vs + key_row * kRowBytes;

  // Tile 0 alone: its scores, P^T_0 and dS^T_0 packed as A fragments.
  float st[32], dpt[32];
  uint32_t pa[4][4], dsa[4][4];
  __syncthreads();
  open_stage(st, dpt, acc_dv, acc_dk);
  start_scores_t<NATOM>(st, dpt, k_rows, v_rows, kKeyTileBytes, ring,
                        ring + NATOM * kDkvQueryTileBytes);
  wgmma_wait<0>();
  fence_registers(st);
  fence_registers(dpt);
  probabilities_t(st, dpt, reinterpret_cast<const float*>(ring_ptr + kRowValues),
                  reinterpret_cast<const float*>(ring_ptr + kRowValues) + kDkvQueries, scale,
                  scale2);
#pragma unroll
  for (int s = 0; s < 4; ++s) {
    pack_fragment(pa[s], st, s);
    pack_fragment(dsa[s], dpt, s);
  }

  // dV += P^T dO, dK += dS^T Q over this warpgroup's 64 columns, from the
  // stage at byte offset `stage` of the ring.
  auto start_sums = [&](uint32_t stage) {
    const uint32_t Qs = ring + stage + out_atom * kDkvQueryTileBytes;
    const uint32_t dOs = Qs + NATOM * kDkvQueryTileBytes;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      wgmma_m64n64k16_rs_tb(acc_dv, pa[s], tile_descriptor(dOs) + s * kDescNextRows16);
      wgmma_m64n64k16_rs_tb(acc_dk, dsa[s], tile_descriptor(Qs) + s * kDescNextRows16);
    }
    wgmma_commit();
  };

  // No `wgmma` sits under a condition: the assembler runs the products of a
  // stage one after the other when one of them does.
  for (int qt = 0; qt + 1 < n_tiles; ++qt) {
    // Tile qt + 1 has arrived, and both warpgroups are done with tile qt - 1.
    const uint32_t next = ((qt + 1) % kDkvStages) * kStageBytes;
    __syncthreads();
    open_stage(st, dpt, acc_dv, acc_dk);
    start_scores_t<NATOM>(st, dpt, k_rows, v_rows, kKeyTileBytes, ring + next,
                          ring + next + NATOM * kDkvQueryTileBytes);
    start_sums((qt % kDkvStages) * kStageBytes);
    wgmma_wait<1>();   // the scores of tile qt + 1 are there; the sums of tile qt still run
    fence_registers(st);
    fence_registers(dpt);
    const float* lse_s = reinterpret_cast<const float*>(ring_ptr + next + kRowValues);
    probabilities_t(st, dpt, lse_s, lse_s + kDkvQueries, scale, scale2);
    wgmma_wait<0>();
    fence_fragments(pa);
    fence_fragments(dsa);
    fence_registers(acc_dv);
    fence_registers(acc_dk);
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      pack_fragment(pa[s], st, s);
      pack_fragment(dsa[s], dpt, s);
    }
  }
  // The last tile's sums.
  open_stage(st, dpt, acc_dv, acc_dk);
  start_sums(((n_tiles - 1) % kDkvStages) * kStageBytes);
  wgmma_wait<0>();
  fence_fragments(pa);
  fence_fragments(dsa);
  fence_registers(acc_dv);
  fence_registers(acc_dk);

  store_accumulator(dv + b * sdv.b + h * sdv.h, sdv.n, k0 + key_row, n, out_atom * kAtom, width,
                    acc_dv, 1.f, 1.f);
  store_accumulator(dk + b * sdk.b + h * sdk.h, sdk.n, k0 + key_row, n, out_atom * kAtom, width,
                    acc_dk, 1.f, 1.f);
}

template <int NATOM>
int launch_dkv_tc(const void* q, const void* k, const void* v, const void* d_o, const float* lse,
                  const float* di, void* dk, void* dv, int batch, int heads, int n, int width,
                  const long long* st, float scale, cudaStream_t stream) {
  constexpr int kKeys = NATOM == 1 ? 128 : 64;
  // K and V resident, the stages of (Q, dO, lse, di) rounded up to 1024
  // bytes each, and the slack to align the first tile.
  const size_t smem = (size_t)2 * NATOM * kKeys * kRowBytes +
                      kDkvStages * ((size_t)2 * NATOM * kDkvQueryTileBytes + 1024) + 1024;
  auto kernel = flash_bwd_dkv_tc_kernel<NATOM>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + kKeys - 1) / kKeys, batch * heads);
  kernel<<<grid, kTcThreads + kCopyThreads, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)d_o, lse, di, (bf16*)dk,
      (bf16*)dv, heads, n, width, Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
      Strides{st[6], st[7], st[8]}, Strides{st[9], st[10], st[11]},
      Strides{st[12], st[13], st[14]}, Strides{st[15], st[16], st[17]}, scale);
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// bfloat16, head widths above 128 that are multiples of 64, up to 512 (the
// VAE's single 512-wide head): the tensor cores, the output split by columns.
//
// dK and dV of 64 keys x 512 columns are 256 KB of float32 sums, the whole
// register file. So the output columns are split into groups over grid.z
// (one group up to width 256, two above: `kDkvWideGroups`), and each of a
// block's two multiplying warpgroups sums two 64-column atoms of dK and two
// of dV (128 registers a thread). A block owns 64 keys. K and V stay
// resident at the full width (128 KB at 512), since S^T = K Q^T and
// dP^T = V dO^T sum over all of it. Q, dO, lse and di stream in tiles of 16
// queries (32 KB of Q and dO at width 512) through a ring of `cp.async`
// stages fed by the third warpgroup, one barrier per tile.
//
// The 64 x 16 score tiles S^T and dP^T (`wgmma` m64n16k16) are summed over
// the head width in two halves, one a warpgroup, and the halves added
// through shared memory (`add_partial_scores`, one named barrier a tile):
// each block computes the scores once, each group's block again, so the
// work is 1.5 x the nominal 8 N^2 d operations at width 512 (two groups) and
// 1.0 x up to 256; each warpgroup computing the whole tile instead, as the
// kernel above does at two atoms (2.5 x and 1.5 x), measured 1.5 x slower
// at (1, 1, 16384, 512). P^T and dS^T then sit in the
// accumulator registers of both warpgroups and are, rounded to bfloat16,
// the A operands of dV += P^T dO and dK += dS^T Q, with dO and Q read
// MN-major from the stage.
//
// The copying warpgroup keeps ahead with little work a copy
// (`load_rows16_async`): the ring alone takes less time than the products
// (3.0-3.1 against 4.9 ms at (1, 1, 16384, 512)), so a tile's sums are not
// overlapped with the next tile's scores (which would hold one more stage),
// and two stages suffice at width 512 (as fast as three, measured before
// the exchange took the third's room), eight up to 256.
// ---------------------------------------------------------------------------

constexpr int kDkvWideKeys = 64;      // keys a block
constexpr int kDkvWideQueries = 16;   // queries a tile
constexpr int kDkvWideOwn = 2;        // atoms of dK and of dV a warpgroup sums
constexpr uint32_t kDkvWideKeyTileBytes = kDkvWideKeys * kRowBytes;        // one atom of K or V
constexpr uint32_t kDkvWideQueryTileBytes = kDkvWideQueries * kRowBytes;   // one atom of Q or dO

// Groups of output columns over grid.z: 1 at 4 atoms, 2 at 8.
template <int NATOM>
constexpr int kDkvWideGroups = NATOM / (2 * kDkvWideOwn);
// Stages of the ring (beside K and V and the exchange of partial scores).
template <int NATOM>
constexpr int kDkvWideStages = NATOM == 8 ? 2 : 8;
// Floats of the exchange of partial score tiles: 2 warpgroups x 2 tiles x
// 8 values x 128 threads.
constexpr int kDkvWideExchange = 2 * 2 * (kDkvWideQueries / 2) * 128;

template <int NATOM>
__global__ void __launch_bounds__(kTcThreads + kCopyThreads, 1)
flash_bwd_dkv_wide_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                          const bf16* __restrict__ v, const bf16* __restrict__ d_o,
                          const float* __restrict__ lse, const float* __restrict__ di,
                          bf16* __restrict__ dk, bf16* __restrict__ dv, int heads, int n,
                          int width, Strides sq, Strides sk, Strides sv, Strides sdo,
                          Strides sdk, Strides sdv, float scale) {
  constexpr int kQueries = kDkvWideQueries;
  constexpr int kStages = kDkvWideStages<NATOM>;
  constexpr uint32_t kStageBytes = 2 * NATOM * kDkvWideQueryTileBytes;   // Q's atoms, dO's
  extern __shared__ char smem_raw[];
  const uint32_t smem0 = smem_addr(smem_raw);
  const uint32_t Ks = (smem0 + 1023u) & ~1023u;                 // NATOM tiles
  const uint32_t Vs = Ks + NATOM * kDkvWideKeyTileBytes;        // NATOM tiles
  const uint32_t ring = Vs + NATOM * kDkvWideKeyTileBytes;      // kStages stages
  const uint32_t row_values = ring + kStages * kStageBytes;     // a stage's lse, then di
  const float* row_values_ptr = reinterpret_cast<const float*>(smem_raw + (row_values - smem0));
  float* exchange = reinterpret_cast<float*>(smem_raw + (row_values - smem0)) +
                    kStages * 2 * kQueries;                      // kDkvWideExchange floats

  const int wg = threadIdx.x >> 7;
  const int bh = blockIdx.y, b = bh / heads, h = bh % heads;
  const int k0 = blockIdx.x * kDkvWideKeys;
  const int n_tiles = (n + kQueries - 1) / kQueries;

  if (threadIdx.x >= kTcThreads) {
    registers_dec<kCopyRegisters>();
    // The copying warpgroup. At the barrier of tile t, tile t has arrived
    // and tile t - 1 is no longer read: the copy of tile t + kStages - 1
    // takes its stage.
    const int loader = threadIdx.x - kTcThreads;
    const bf16* qb = q + b * sq.b + h * sq.h;
    const bf16* dob = d_o + b * sdo.b + h * sdo.h;
    auto load_query_tile = [&](int qt) {
      if (qt < n_tiles) {
        const int slot = qt % kStages;
        const uint32_t stage = ring + slot * kStageBytes;
        const int q0 = qt * kQueries;
        load_rows16_async<NATOM>(stage, kDkvWideQueryTileBytes, qb, sq.n, q0, n, width, loader);
        load_rows16_async<NATOM>(stage + NATOM * kDkvWideQueryTileBytes, kDkvWideQueryTileBytes,
                                 dob, sdo.n, q0, n, width, loader);
        if (loader < 2 * kQueries) {   // lse by loaders 0-15, di by 16-31
          const int r = loader % kQueries;
          const float* src = (loader < kQueries ? lse : di) + (long long)bh * n;
          const bool valid = q0 + r < n;
          cp_async_4(row_values + (slot * 2 * kQueries + loader) * sizeof(float),
                     valid ? src + q0 + r : src, valid);
        }
      }
      cp_async_commit();   // an empty group past the last tile keeps the count of groups
    };
    const bf16* kb = k + b * sk.b + h * sk.h;
    const bf16* vb = v + b * sv.b + h * sv.h;
#pragma unroll 1
    for (int a = 0; a < NATOM; ++a) {
      load_tile_async(Ks + a * kDkvWideKeyTileBytes, kb, sk.n, k0, n, kDkvWideKeys, a * kAtom,
                      width, loader, kCopyThreads);
      load_tile_async(Vs + a * kDkvWideKeyTileBytes, vb, sv.n, k0, n, kDkvWideKeys, a * kAtom,
                      width, loader, kCopyThreads);
    }
#pragma unroll 1
    for (int qt = 0; qt < kStages - 1; ++qt) load_query_tile(qt);   // K and V go with tile 0
#pragma unroll 1
    for (int qt = 0; qt < n_tiles; ++qt) {
      cp_async_wait_and_publish<kStages - 2>();   // tile qt (the ones after it may not be)
      __syncthreads();
      load_query_tile(qt + kStages - 1);
    }
    return;
  }
  registers_inc<kTcRegisters>();

  // This warpgroup's first atom of dK and dV: group blockIdx.z owns atoms
  // [4 z, 4 z + 4), its warpgroup wg the two from 4 z + 2 wg. Its scores sum
  // over atoms [wg NATOM / 2, (wg + 1) NATOM / 2) of the head width.
  const int out_atom = (blockIdx.z * 2 + wg) * kDkvWideOwn;
  const uint32_t score_atom = wg * (NATOM / 2);
  float acc_dv[kDkvWideOwn][32], acc_dk[kDkvWideOwn][32];
#pragma unroll
  for (int a = 0; a < kDkvWideOwn; ++a) {
#pragma unroll
    for (int i = 0; i < 32; ++i) acc_dv[a][i] = acc_dk[a][i] = 0.f;
  }
  const float scale2 = scale * kLog2e;
  float st[kQueries / 2], dpt[kQueries / 2];
  uint32_t pa[1][4], dsa[1][4];

  // Every register a product of the coming stage reads or writes is fenced
  // before its first `wgmma` (see `open_stage`).
  auto open_wide_stage = [&]() {
    fence_registers(st);
    fence_registers(dpt);
#pragma unroll
    for (int a = 0; a < kDkvWideOwn; ++a) {
      fence_registers(acc_dv[a]);
      fence_registers(acc_dk[a]);
    }
    wgmma_fence();
  };
  auto close_wide_sums = [&]() {
    fence_fragments(pa);
    fence_fragments(dsa);
#pragma unroll
    for (int a = 0; a < kDkvWideOwn; ++a) {
      fence_registers(acc_dv[a]);
      fence_registers(acc_dk[a]);
    }
  };

  // No `wgmma` sits under a condition (see the kernel above).
  for (int qt = 0; qt < n_tiles; ++qt) {
    const int slot = qt % kStages;
    const uint32_t q_tiles = ring + slot * kStageBytes;
    const uint32_t do_tiles = q_tiles + NATOM * kDkvWideQueryTileBytes;
    __syncthreads();   // tile qt has arrived; both warpgroups are done with tile qt - 1

    // S^T = K Q^T and dP^T = V dO^T for the block's 64 keys and the tile's
    // 16 queries, over this warpgroup's half of the head width.
    const uint64_t k_desc = opaque(tile_descriptor(Ks + score_atom * kDkvWideKeyTileBytes));
    const uint64_t v_desc = opaque(tile_descriptor(Vs + score_atom * kDkvWideKeyTileBytes));
    const uint64_t q_desc = tile_descriptor(q_tiles + score_atom * kDkvWideQueryTileBytes);
    const uint64_t do_desc = tile_descriptor(do_tiles + score_atom * kDkvWideQueryTileBytes);
    open_wide_stage();
#pragma unroll
    for (int ks = 0; ks < NATOM * 2; ++ks) {
      const uint32_t key_atom = (ks >> 2) * kDkvWideKeyTileBytes;
      const uint32_t query_atom = (ks >> 2) * kDkvWideQueryTileBytes;
      const uint64_t step = (ks & 3) * kDescNextColumns16;
      wgmma_m64n16k16_ss(st, descriptor_plus(k_desc, key_atom) + step,
                         descriptor_plus(q_desc, query_atom) + step, ks > 0);
      wgmma_m64n16k16_ss(dpt, descriptor_plus(v_desc, key_atom) + step,
                         descriptor_plus(do_desc, query_atom) + step, ks > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_registers(st);
    fence_registers(dpt);
    add_partial_scores(st, dpt, exchange);
    const float* lse_s = row_values_ptr + slot * 2 * kQueries;
    probabilities_t<kQueries>(st, dpt, lse_s, lse_s + kQueries, scale, scale2);
    pack_fragment(pa[0], st, 0);
    pack_fragment(dsa[0], dpt, 0);

    // dV += P^T dO and dK += dS^T Q over this warpgroup's atoms.
    open_wide_stage();
#pragma unroll
    for (int a = 0; a < kDkvWideOwn; ++a) {
      const uint32_t atom = (out_atom + a) * kDkvWideQueryTileBytes;
      wgmma_m64n64k16_rs_tb(acc_dv[a], pa[0], tile_descriptor(do_tiles + atom));
      wgmma_m64n64k16_rs_tb(acc_dk[a], dsa[0], tile_descriptor(q_tiles + atom));
    }
    wgmma_commit();
    wgmma_wait<0>();
    close_wide_sums();
  }

#pragma unroll
  for (int a = 0; a < kDkvWideOwn; ++a) {
    store_accumulator(dv + b * sdv.b + h * sdv.h, sdv.n, k0, n, (out_atom + a) * kAtom, width,
                      acc_dv[a], 1.f, 1.f);
    store_accumulator(dk + b * sdk.b + h * sdk.h, sdk.n, k0, n, (out_atom + a) * kAtom, width,
                      acc_dk[a], 1.f, 1.f);
  }
}

template <int NATOM>
int launch_dkv_wide(const void* q, const void* k, const void* v, const void* d_o,
                    const float* lse, const float* di, void* dk, void* dv, int batch, int heads,
                    int n, int width, const long long* st, float scale, cudaStream_t stream) {
  // The slack to align the first tile, K and V resident, the stages of Q
  // and dO with their lse and di, and the exchange of partial scores.
  const size_t smem = 1024 + (size_t)2 * NATOM * kDkvWideKeyTileBytes +
                      kDkvWideStages<NATOM> * ((size_t)2 * NATOM * kDkvWideQueryTileBytes +
                                               2 * kDkvWideQueries * sizeof(float)) +
                      kDkvWideExchange * sizeof(float);
  auto kernel = flash_bwd_dkv_wide_kernel<NATOM>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + kDkvWideKeys - 1) / kDkvWideKeys, batch * heads, kDkvWideGroups<NATOM>);
  kernel<<<grid, kTcThreads + kCopyThreads, smem, stream>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)d_o, lse, di, (bf16*)dk,
      (bf16*)dv, heads, n, width, Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
      Strides{st[6], st[7], st[8]}, Strides{st[9], st[10], st[11]},
      Strides{st[12], st[13], st[14]}, Strides{st[15], st[16], st[17]}, scale);
  return (int)cudaGetLastError();
}

}  // namespace rgie

// q, k, v, d_o, dk, dv: (batch, heads, n, width) with the width axis
// contiguous; `strides` holds (batch, head, row) strides in elements for
// them in that order (18 values). lse, di: (batch, heads, n) float32,
// contiguous. Returns cudaGetLastError() (0 on success), or -1 for a width
// or a grid the kernel does not take. Dispatch by shape (``kernel_route`` in
// ops/kernels/flash_attention.py states the same rule): bfloat16 with a
// width that is a multiple of 8 up to 128 runs the tensor-core kernel
// ("tensor"), bfloat16 with a width that is a multiple of 64 above 128 up to
// 512 the wide tensor-core kernel ("wide"; both take tensors 16-byte
// aligned, strides multiples of 8 elements); float32 up to width 128 the
// float32 kernel and above 128 the wide float32 kernel ("float32"; both
// 16-byte aligned, strides multiples of 4); every other bfloat16 width the
// first CUDA-core kernel ("cuda_cores").
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
    const int atoms = atoms_for_width(width);
    if (atoms == 1) {
      return launch_dkv_tc<1>(q, k, v, d_o, lse, di, dk, dv, batch, heads, n, width, strides,
                              scale, s);
    }
    if (atoms == 2) {
      return launch_dkv_tc<2>(q, k, v, d_o, lse, di, dk, dv, batch, heads, n, width, strides,
                              scale, s);
    }
    const int wide_atoms = wide_atoms_for_width(width);
    if (wide_atoms == 4) {
      return launch_dkv_wide<4>(q, k, v, d_o, lse, di, dk, dv, batch, heads, n, width, strides,
                                scale, s);
    }
    if (wide_atoms == 8) {
      return launch_dkv_wide<8>(q, k, v, d_o, lse, di, dk, dv, batch, heads, n, width, strides,
                                scale, s);
    }
    if (chunks == 1) RGIE_DKV(__nv_bfloat16, 1);
    if (chunks == 2) RGIE_DKV(__nv_bfloat16, 2);
    RGIE_DKV(__nv_bfloat16, 8);
  }
  if (chunks == 1) {
    return launch_dkv_f32<1, 8, 8>(q, k, v, d_o, lse, di, dk, dv, batch, heads, n, width, strides,
                                   scale, s);
  }
  if (chunks == 2) {
    return launch_dkv_f32<2, 4, 4>(q, k, v, d_o, lse, di, dk, dv, batch, heads, n, width, strides,
                                   scale, s);
  }
  if (wide_groups_for_width(width) == 2) {
    return launch_dkv_f32_wide<2>(q, k, v, d_o, lse, di, dk, dv, batch, heads, n, width, strides,
                                  scale, s);
  }
  return launch_dkv_f32_wide<4>(q, k, v, d_o, lse, di, dk, dv, batch, heads, n, width, strides,
                                scale, s);
#undef RGIE_DKV
}
