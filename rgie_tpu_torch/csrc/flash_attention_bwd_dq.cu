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
// (2, 5, 16384, 64)), the CUDA cores' for float32 (15.4 ms). In both kernels
// a block owns its query rows and walks the key tiles, so each dQ element is
// summed in a fixed order: no atomics, and the result is the same from run to
// run. Scores are recomputed from the saved log-sum-exp. dS is rounded to the
// inputs' type before dS K (the TPU kernel's `ds.astype(k.dtype)`; the
// identity for float32). Two kernels, chosen by shape in the C entry point:
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
// 2. `flash_bwd_dq_kernel`: float32 (the tensor cores would drop its last 13
//    mantissa bits) and the other bfloat16 widths, on the CUDA cores. One
//    block owns 64 query rows; Q and dO stay resident in shared memory at
//    width 64 and the scores never leave the chip. A head wider than 64 is
//    walked in 64-column chunks as in the forward kernel: the scores are
//    summed over the chunks once, and the block keeps one 4x4 patch of dQ per
//    chunk in registers (128 at width 512), so no product is repeated; the
//    price is that Q, dO, K and V are reloaded chunk by chunk.

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
// does not take. Dispatch by shape: bfloat16 with a width that is a multiple
// of 8 up to 128 runs the tensor-core kernel (its tensors 16-byte aligned,
// strides multiples of 8 elements); float32, and every other bfloat16 width,
// the CUDA-core kernel.
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
  if (chunks == 1) RGIE_DQ(float, 1);
  if (chunks == 2) RGIE_DQ(float, 2);
  RGIE_DQ(float, 8);
#undef RGIE_DQ
}
