"""Time variants of the package's CUDA kernels (flash attention, K1) against
the package's own, inside one process on one card, to see what bounds a
kernel.

    python -m rgie_tpu_torch.cli.kernel_variants

A variant is the package's source with a few lines replaced (``VARIANTS``
below). The script copies ``rgie_tpu_torch/csrc/`` into
``build/variants/<name>/`` (ignored by git), applies the variant's edits to
the copy (of the kernel's source, or of the shared header), compiles all
variants at once with the package's ``nvcc`` flags, loads them with
``ctypes`` and times each in alternation with the package's kernel on the
same tensors (CUDA events, median of 7). Nothing in the package is touched, and the package never
launches a variant. An edit names the exact lines it replaces; when the
source has changed under it, the script raises and says which edit no longer
applies.

The variants:

- ``dq_copies_only``, ``wide_copies_only``: the multiplying warpgroups only
  meet the barriers, so the time is that of the ``cp.async`` ring alone
  (printed with the bytes it brings from the L2 cache). Their results are
  not compared.
- ``dq_without_ex2``: the exponential of every score replaced by its
  argument: what the special-function unit costs. Not compared.
- ``dq_64_key_tiles``: 64-key tiles at head widths up to 64 (the package
  takes 128). Compared: equal to the package's result.
- ``dq_free_warpgroups``: the two multiplying warpgroups meet the copying one
  on named barriers of their own (tile arrived: 1 and 2; tile released: 3
  and 4) and no longer each other. Compared: equal to the package's result.
- ``dkv32_named``: half 0 starts dV += P^T dO without waiting for half 1's
  dS (half 1 meets only itself, on a named barrier).
- ``fwd32_*``, ``dkv32_*``, ``dq32_*``: the float32 forward, dK/dV and dQ
  (dQ at (2, 5, 16384, 64) and (1, 5, 16384, 64)). ``*_old`` is the
  entry point sending float32 back to the first CUDA-core kernels (the
  design before the float32 kernels; compared with the package's result);
  ``*_copies_only`` keeps the copies, barriers and softmax and drops the
  products, ``*_products_only`` drops the copies of the streamed tiles,
  ``*_without_exp`` replaces the exponential by its argument, each for the
  old and the new design; ``*_outer`` (all operands of a 4-deep step loaded,
  then the outer product one component at a time) and ``*_unroll1``,
  ``*_unroll4`` change the float32 products' loops in the shared header.
  ``dq32_one_half_ds`` has half 1 compute all of dS (as at width 128)
  instead of both halves half of it. ``*_old`` is compared with the
  package's result (float32 tolerance), the loop variants,
  ``dkv32_named`` and ``dq32_one_half_ds`` must equal it; the others are
  not compared.
- ``dkv32w_*``, ``dq32w_*``: the wide float32 dK/dV and dQ (float32 above
  width 128), timed at the VAE's (1, 1, 16384, 512) and at (1, 2, 16384,
  256) (as many operations, at 2 groups of 128 columns): ``*_old`` sends float32
  above 128 back to the first CUDA-core kernels (``RGIE_DKV(float, 8)``,
  ``RGIE_DQ(float, 8)``; compared with the package's result),
  ``*_copies_only`` drops both products (the lanes' score products and the
  sums), ``*_products_only`` drops the copies of the streamed tiles,
  ``*_without_exp`` replaces the exponential by its argument (not compared);
  ``dkv32w_float4``, ``*_two_stages``, ``dkv32w_xor1``, ``dq32w_xor0``,
  ``dkv32w_unrolled``, ``dq32w_rolled`` and
  ``dkv32w_pointers_in_registers`` turn one knob of the design the other
  way (must equal the package's result).
- ``k1_cooperative``: K1's two passes in one cooperative launch, as many
  blocks as fit on the card at once walking the (block, image) items, a
  grid-wide barrier between the passes; ``k1_switch``: the sector's colours
  by a ``switch`` instead of selects; ``k1_four_groups``: 4096-pixel blocks,
  16 pixels a thread read at once; all compared: equal to the package's
  result (the mean's partial sums are grouped differently in
  ``k1_four_groups``: within float32 rounding). ``k1_copies_only``: the prefix's arithmetic left out (not
  compared). ``k1_triton_old`` (no source edit: the module
  ``ops/kernels/pointwise_chain_triton.py`` and its wrapper, needs
  ``triton``) is the design before the CUDA C++ kernel. Both are timed per
  call (CUDA events around the wrapper, host work included) beside the
  package's kernel at (4, 1024, 1024, 3) and (1, 1024, 1024, 3), and the
  package's and the old design's device time alone (``graph_ms``: the call
  captured once in a CUDA graph and replayed).

A selection of variants: ``python -m rgie_tpu_torch.cli.kernel_variants
fwd32 dkv32`` builds and times only the variants whose names start so
(``k1`` the K1 ones).

Prints the card's name and power limit first. Needs CUDA and ``nvcc``.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import time

import numpy as np
import torch

from rgie_tpu_torch.device import resolve_device
from rgie_tpu_torch.ops.kernels import build
from rgie_tpu_torch.ops.kernels import flash_attention as FA
from rgie_tpu_torch.ops.kernels import pointwise_chain as PC

VARIANT_DIR = build.BUILD_DIR.parent / "variants"

_DQ, _FWD, _DKV = "flash_attention_bwd_dq", "flash_attention_fwd", "flash_attention_bwd_dkv"
_K1 = PC.KERNEL_SOURCE

_NAMED_BARRIERS = """
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\\n" ::"r"(id), "r"(threads) : "memory");
}
template <int NATOM>
__global__ void __launch_bounds__(kTcThreads + kCopyThreads, 1)
flash_bwd_dq_tc_kernel("""

# The entry points' float32 dispatch as it was before the float32 kernels:
# every width on the first CUDA-core kernels.
_FWD_OLD = [("""  if (chunks == 1) {
    return launch_fwd_f32<Fwd32>(flash_fwd_float32_kernel, q, k, v, o, lse, batch, heads, n,
                                 width, strides, scale, s);
  }
  return launch_fwd_f32<Fwd32Wide>(flash_fwd_float32_wide_kernel, q, k, v, o, lse, batch, heads,
                                   n, width, strides, scale, s);""",
              """  if (chunks == 1) return launch_fwd<float, 1>(q, k, v, o, lse, batch, heads, n, width, strides,
                                               scale, s);
  if (chunks == 2) return launch_fwd<float, 2>(q, k, v, o, lse, batch, heads, n, width, strides,
                                               scale, s);
  return launch_fwd<float, 8>(q, k, v, o, lse, batch, heads, n, width, strides, scale, s);""")]
_DKV_OLD = [("""  if (chunks == 1) {
    return launch_dkv_f32<1, 8, 8>(""", """  if (chunks == 1) RGIE_DKV(float, 1);
  if (chunks == -1) {
    return launch_dkv_f32<1, 8, 8>(""")]
_DQ_OLD = [("""  if (chunks == 1) {
    return launch_dq_f32<1>(""", """  if (chunks == 1) RGIE_DQ(float, 1);
  if (chunks == -1) {
    return launch_dq_f32<1>(""")]

# The entry points' float32 dispatch above width 128 as it was before the
# wide float32 kernels: the first CUDA-core kernels at 8 chunks of 64 columns.
_DKV_WIDE_OLD = [("""  if (wide_groups_for_width(width) == 2) {
    return launch_dkv_f32_wide<2>(""", """  RGIE_DKV(float, 8);
  if (wide_groups_for_width(width) == 2) {
    return launch_dkv_f32_wide<2>(""")]
_DQ_WIDE_OLD = [("""  if (wide_groups_for_width(width) == 2) {
    return launch_dq_f32_wide<2>(""", """  RGIE_DQ(float, 8);
  if (wide_groups_for_width(width) == 2) {
    return launch_dq_f32_wide<2>(""")]
# The lanes' score product of the wide kernels left out (the fold, the
# exponential and the barriers stay, on zeros).
_NO_LANE_SCORES = """    (void)rows;
#pragma unroll
    for (int i = 0; i < 64; ++i) sc[i] = 0.f;
"""

_K1_BRANCH_FREE = """  const float h6 = delta == 0.f ? 0.f : hue;
  const float s = cmax == 0.f ? 0.f : delta / cmax;
  const float c = cmax * (s * p[kSaturation]);
  const float x = c * (1.f - fabsf(h6 - 2.f * floorf(h6 * 0.5f) - 1.f));   // h6 >= 0
  const float m = cmax - c;
  // The JAX kernel's `pick` over sector = floor(h6) % 6 (h6 in [0, 6]): r is
  // c in sectors 0 and 5, x in 1 and 4, else 0; g c in 1, 2, x in 0, 3; b c
  // in 3, 4, x in 2, 5. One bit a sector.
  const int whole = (int)h6;
  const int bit = 1 << (whole == 6 ? 0 : whole);
  const float nr = bit & 0x21 ? c : bit & 0x12 ? x : 0.f;
  const float ng = bit & 0x06 ? c : bit & 0x09 ? x : 0.f;
  const float nb = bit & 0x18 ? c : bit & 0x24 ? x : 0.f;
"""
_K1_BRANCHES = """  const float h6 = delta == 0.f ? 0.f : hue;
  const float s = cmax == 0.f ? 0.f : delta / cmax;
  const float c = cmax * (s * p[kSaturation]);
  const float x = c * (1.f - fabsf(h6 - 2.f * floorf(h6 * 0.5f) - 1.f));
  const float m = cmax - c;
  const int sector = (int)floorf(h6) % 6;
  float nr, ng, nb;
  switch (sector) {
    case 0: nr = c; ng = x; nb = 0.f; break;
    case 1: nr = x; ng = c; nb = 0.f; break;
    case 2: nr = 0.f; ng = c; nb = x; break;
    case 3: nr = 0.f; ng = x; nb = c; break;
    case 4: nr = x; ng = 0.f; nb = c; break;
    default: nr = c; ng = 0.f; nb = x; break;
  }
"""

# K1's two passes in one cooperative launch: a grid that fits on the card at
# once walks the (block, image) items, pass 1, a grid-wide barrier, pass 2.
_K1_COOPERATIVE = [
    ("#include <stdint.h>\n", "#include <stdint.h>\n#include <cooperative_groups.h>\n"),
    ("}  // namespace rgie_k1\n", """__global__ void __launch_bounds__(kThreads)
k1_cooperative(const float* __restrict__ image, float* __restrict__ out,
               float* __restrict__ partials, int hw, int blocks, int batch, ParamPointers pp) {
  __shared__ __align__(16) float p[kParams];
  __shared__ float scratch[kThreads / 32];
  __shared__ float4 stage[kThreads * 3];
  load_params(p, pp);
  __syncthreads();
  const int items = blocks * batch;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    gray_partial(image, partials, hw, blocks, item % blocks, item / blocks, p, scratch,
                 stage + 3 * (threadIdx.x & ~31));
  }
  cooperative_groups::this_grid().sync();
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    contrast_block(image, out, partials, hw, blocks, item % blocks, item / blocks, p, scratch,
                   stage + 3 * (threadIdx.x & ~31));
  }
}

}  // namespace rgie_k1
"""),
    ("""  k1_gray_partials<<<grid, kThreads, 0, s>>>(image, partials, hw, pp);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  k1_contrast<<<grid, kThreads, 0, s>>>(image, out, partials, hw, pp);
  return (int)cudaGetLastError();""", """  (void)grid;
  int device = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k1_cooperative, kThreads, 0);
  const int n_grid = blocks * batch < sms * per_sm ? blocks * batch : sms * per_sm;
  const float* image_a = image;
  float *out_a = out, *partials_a = partials;
  int hw_a = hw, blocks_a = blocks, batch_a = batch;
  ParamPointers pp_a = pp;
  void* args[] = {&image_a, &out_a, &partials_a, &hw_a, &blocks_a, &batch_a, &pp_a};
  return (int)cudaLaunchCooperativeKernel((const void*)k1_cooperative, dim3(n_grid),
                                          dim3(kThreads), args, 0, s);"""),
]

# The float32 products' loops in the shared header: all operands of a 4-deep
# step loaded first, then the outer product one component at a time; and the
# unrolling of the loops over the depth.
_HEADER = "flash_attention_common.cuh"
_OUTER = (_HEADER, """    float4 a[R];
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
    }""", """    float4 a[R], b[C];
#pragma unroll
    for (int i = 0; i < R; ++i) a[i] = *reinterpret_cast<const float4*>(a_rows + RS * i * AP + k);
#pragma unroll
    for (int j = 0; j < C; ++j) b[j] = *reinterpret_cast<const float4*>(b_rows + TX * j * BP + k);
#pragma unroll
    for (int i = 0; i < R; ++i) {
#pragma unroll
      for (int j = 0; j < C; ++j) acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
#pragma unroll
      for (int j = 0; j < C; ++j) acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
#pragma unroll
      for (int j = 0; j < C; ++j) acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < R; ++i) {
#pragma unroll
      for (int j = 0; j < C; ++j) acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
    }""")


def _UNROLL(factor):
    return [(_HEADER, f"#pragma unroll 2\n  for ({loop}",
             f"#pragma unroll {factor}\n  for ({loop}")
            for loop in ("int k = 0; k < DEPTH; k += 4) {", "int j = 0; j < DEPTH; j += 4) {")]


#: name -> (source, [(lines to replace, replacement), ...]); an edit of three
#: items, (file, lines, replacement), edits another file of csrc/.
VARIANTS = {
    "dq_copies_only": (_DQ, [(
        """  registers_inc<kTcRegisters>();

  // Per thread: rows lane / 4 and lane / 4 + 8 of its warp's 16-row band.
  const float scale2""",
        """  registers_inc<kTcRegisters>();
  if (n > 0) {
    __syncthreads();
    for (int kt = 0; kt + 1 < n_tiles; ++kt) __syncthreads();
    return;
  }

  // Per thread: rows lane / 4 and lane / 4 + 8 of its warp's 16-row band.
  const float scale2""")]),
    "dq_without_ex2": (_DQ, [(
        "const float p = fast_exp2(fmaf(s[4 * j + i], scale2, neg_lse2[i >> 1]));",
        "const float p = fmaf(s[4 * j + i], scale2, neg_lse2[i >> 1]);")]),
    "dq_64_key_tiles": (_DQ, [(
        "constexpr int kDqKeys = NATOM == 1 ? 128 : 64;", "constexpr int kDqKeys = 64;")]),
    "dq_free_warpgroups": (_DQ, [
        ("""template <int NATOM>
__global__ void __launch_bounds__(kTcThreads + kCopyThreads, 1)
flash_bwd_dq_tc_kernel(""", _NAMED_BARRIERS),
        ("""    load_kv(0);
    load_kv(1);
    cp_async_wait_and_publish<1>();   // Q, dO and tile 0
    __syncthreads();
    for (int kt = 0; kt + 1 < n_tiles; ++kt) {
      cp_async_wait_and_publish<0>();   // tile kt + 1
      __syncthreads();
      load_kv(kt + 2);
    }
    return;""",
         """    load_kv(0);
    load_kv(1);
    load_kv(2);
    cp_async_wait_and_publish<2>();   // Q, dO and tile 0
    __syncthreads();
    for (int kt = 0; kt + 1 < n_tiles; ++kt) {
      if (kt >= 1) {   // both warpgroups released tile kt - 1: its stage takes tile kt + 2
        named_sync(3, 256);
        named_sync(4, 256);
        load_kv(kt + 2);
      }
      cp_async_wait_and_publish<1>();   // tile kt + 1
      named_arrive(1, 256);
      named_arrive(2, 256);
    }
    return;"""),
        ("""    const uint32_t next = KVs + ((kt + 1) % kDqStages) * kStageBytes;
    __syncthreads();""",
         """    const uint32_t next = KVs + ((kt + 1) % kDqStages) * kStageBytes;
    named_sync(1 + wg, 256);"""),
        ("""    for (int a = 0; a < NATOM; ++a) fence_registers(acc[a]);
#pragma unroll
    for (int ks = 0; ks < KEYS / 16; ++ks) pack_fragment(dsa[ks], dp, ks);
  }""",
         """    for (int a = 0; a < NATOM; ++a) fence_registers(acc[a]);
    if (kt + 2 < n_tiles) named_arrive(3 + wg, 256);
#pragma unroll
    for (int ks = 0; ks < KEYS / 16; ++ks) pack_fragment(dsa[ks], dp, ks);
  }""")]),
    # The float32 forward (flash_fwd_float32_kernel<1> and <8>) and dK/dV
    # (flash_bwd_dkv_float32_kernel<1, 8, 4>), and the CUDA-core kernels they
    # replaced for float32 (flash_fwd_kernel<float, 1 | 8>,
    # flash_bwd_dkv_kernel<float, 1>; still in the sources for other types
    # and widths), each with its copies only, its products only, and its
    # exponential replaced by its argument.
    "fwd32_copies_only": (_FWD, [
        ("    product_nt<8, 8, kF32Pitch, kF32Pitch, 16, 16>(s, Qs, Ks, threadIdx.x);\n",
         "    (void)Ks;\n"),
        ("""    product_nn<8, 8, 64, G::kPPitch, kF32Pitch, 8, 16>(acc, Ps + 64 * half,
                                                       Vs + 64 * half * kF32Pitch, t);
""", "    (void)Vs;\n"),
        ("""      product_nt<4, 8, G::kRowPitch, G::kKPitch, 16, 16, G::kKCols>(s, Qs + c * G::kKCols, Ks,
                                                                     threadIdx.x);
""", "      (void)Ks;\n"),
        ("""      product_nn<8, 16, G::kVKeys, G::kPPitch, G::kRowPitch, 32, 8>(
          acc, Ps + g * G::kVKeys, Vs, threadIdx.x);
""", "      (void)Vs;\n")]),
    "fwd32_products_only": (_FWD, [("    if (it < 2 * n_tiles) {", "    if (it < 0) {"),
                                   ("    if (it < n_tiles * per_tile) {", "    if (it < 0) {")]),
    "fwd32_without_exp": (_FWD, [
        ("""      const float alpha = fast_exp2(row_m[i] - m_new);      // 0 at the first tile
      row_m[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = fast_exp2(s[i][j] - m_new);""",
         """      const float alpha = row_m[i] - m_new;
      row_m[i] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = s[i][j] - m_new;"""),
        ("""    const float alpha = fast_exp2(row_m[i] - m_new);      // 0 at the first tile
    row_m[i] = m_new;""", """    const float alpha = row_m[i] - m_new;
    row_m[i] = m_new;"""),
        ("float p = fast_exp2(fmaf(s[i][j], scale2, -m_new));",
         "float p = fmaf(s[i][j], scale2, -m_new);")]),
    "fwd32_outer": (_FWD, [_OUTER]),
    "fwd32_unroll1": (_FWD, _UNROLL(1)),
    "fwd32_unroll4": (_FWD, _UNROLL(4)),
    "fwd32_old": (_FWD, _FWD_OLD),
    "fwd32_old_copies_only": (_FWD, _FWD_OLD + [
        ("        mma_nt(s, Qs, Ks);\n", ""),
        ("        mma_nn(acc[c], Ps, Vs);\n", "")]),
    "fwd32_old_products_only": (_FWD, _FWD_OLD + [
        ("""        if (NCHUNK > 1 || kt == 0) load_tile(Qs, qb, sq.n, q0, n, c * kTile, width);
        load_tile(Ks, kb, sk.n, k0, n, c * kTile, width);
""", ""),
        ("        load_tile(Vs, vb, sv.n, k0, n, c * kTile, width);\n", "")]),
    "fwd32_old_without_exp": (_FWD, _FWD_OLD + [
        ("const float p = expf(s[a][bb] - m_new);", "const float p = s[a][bb] - m_new;"),
        ("alpha[a] = expf(row_m[a] - m_new);", "alpha[a] = row_m[a] - m_new;")]),
    "dkv32_copies_only": (_DKV, [
        ("      if (c < nc) product_nt<KI, QJ, kDP, kDP, 8, 16>(sc, A + c * 64, B + c * 64, t);\n",
         ""),
        ("      if (c < nc) product_nn<KI, 8, kQueries, kTP, kDP, 8, 16>(acc[c], Tsum, X + c * 64, t);\n",
         "")]),
    "dkv32_products_only": (_DKV, [("    if (qt < n_tiles) {\n      const int q0 = qt * kQueries;",
                                    "    if (qt < 0) {\n      const int q0 = qt * kQueries;")]),
    "dkv32_without_exp": (_DKV, [(
        "sc[i][j] = fast_exp2(fmaf(sc[i][j], scale2, neg_lse2));",
        "sc[i][j] = fmaf(sc[i][j], scale2, neg_lse2);")]),
    "dkv32_named": (_DKV, [("""    __syncthreads();

    // dV += P^T dO (half 0), dK += dS^T Q (half 1).""", """    if (half == 1) asm volatile("bar.sync 1, 128;\\n" ::: "memory");

    // dV += P^T dO (half 0), dK += dS^T Q (half 1).""")]),
    "dkv32_outer": (_DKV, [_OUTER]),
    "dkv32_unroll1": (_DKV, _UNROLL(1)),
    "dkv32_unroll4": (_DKV, _UNROLL(4)),
    "dkv32_old": (_DKV, _DKV_OLD),
    "dkv32_old_copies_only": (_DKV, _DKV_OLD + [
        ("""        mma_nt(s, Qs, Ks);
        if (want_dk) mma_nt(dp, dOs, Vs);
""", ""),
        ("""        if (want_dv) mma_tn(acc[0][c], Ps, dOs);
        if (want_dk) mma_tn(acc[kSetDk][c], dSs, Qs);
""", "")]),
    "dkv32_old_products_only": (_DKV, _DKV_OLD + [(
        """        load_tile(Qs, qb, sq.n, q0, n, c * kTile, width);
        if (want_dk || NCHUNK == 1) load_tile(dOs, dob, sdo.n, q0, n, c * kTile, width);
        if (NCHUNK > 1 || qt == 0) {
          load_tile(Ks, kb, sk.n, k0, n, c * kTile, width);
          if (want_dk) load_tile(Vs, vb, sv.n, k0, n, c * kTile, width);
        }
""", "")]),
    "dkv32_old_without_exp": (_DKV, _DKV_OLD + [(
        "expf(s[a][bb] * scale - row_lse)", "(s[a][bb] * scale - row_lse)")]),
    "dq32_copies_only": (_DQ, [
        ("      product_nt<kQI, 8, kDP, kDP, 8, 16>(sc, A + c * 64, B + c * 64, t);\n",
         "      (void)B;\n"),
        ("    product_nn<8, 8, 32, kPP, kDP, G::kTX, G::kRS>(acc, Ps + 32 * half, Ks + 32 * half * kDP, t);\n",
         "")]),
    "dq32_products_only": (_DQ, [(
        "    if (kt < n_tiles) {\n      const uint32_t stage = ring_addr",
        "    if (kt < 0) {\n      const uint32_t stage = ring_addr")]),
    "dq32_without_exp": (_DQ, [(
        "fast_exp2(fmaf(sc[i][j], scale2, neg_lse2))", "fmaf(sc[i][j], scale2, neg_lse2)")]),
    # dS computed by half 1 alone, as at width 128.
    "dq32_one_half_ds": (_DQ, [(
        "  static constexpr bool kSplitDs = NCHUNK == 1;",
        "  static constexpr bool kSplitDs = false;")]),
    "dq32_old": (_DQ, _DQ_OLD),
    "dq32_old_copies_only": (_DQ, _DQ_OLD + [
        ("        mma_nt(s, Qs, Ks);\n        mma_nt(dp, dOs, Vs);\n", ""),
        ("        mma_nn(acc[c], dSs, Ks);\n", "")]),
    "dq32_old_products_only": (_DQ, _DQ_OLD + [(
        """        if (NCHUNK > 1 || kt == 0) {
          load_tile(Qs, qb, sq.n, q0, n, c * kTile, width);
          load_tile(dOs, dob, sdo.n, q0, n, c * kTile, width);
        }
        load_tile(Ks, kb, sk.n, k0, n, c * kTile, width);
        load_tile(Vs, vb, sv.n, k0, n, c * kTile, width);
""", """        if (NCHUNK > 1 || kt == 0) {
          load_tile(Qs, qb, sq.n, q0, n, c * kTile, width);
          load_tile(dOs, dob, sdo.n, q0, n, c * kTile, width);
        }
""")]),
    "dq32_old_without_exp": (_DQ, _DQ_OLD + [(
        "expf(s[a][bb] * scale - row_lse[a])", "(s[a][bb] * scale - row_lse[a])")]),
    "dkv32w_old": (_DKV, _DKV_WIDE_OLD),
    "dkv32w_copies_only": (_DKV, [
        ("""    lane_scores<NGROUP, kRow, kRow, G::kScoreVec, G::kScoreUnroll>(sc, rows, p_warp ? Qs : dOs,
                                                                   lane);
""", _NO_LANE_SCORES),
        ("    product_nn<8, 4 * NGROUP, kQueries, kQueries, kRow, 32, 1>(acc, T, p_warp ? dOs : Qs,\n"
         "                                                               lane);\n", "")]),
    "dkv32w_products_only": (_DKV, [(
        "    if (qt < n_tiles) {\n      const uint32_t stage",
        "    if (qt < 0) {\n      const uint32_t stage")]),
    "dkv32w_without_exp": (_DKV, [
        ("fast_exp2(fmaf(sc[0], scale2, -l2.x * kLog2e))", "fmaf(sc[0], scale2, -l2.x * kLog2e)"),
        ("fast_exp2(fmaf(sc[1], scale2, -l2.y * kLog2e))", "fmaf(sc[1], scale2, -l2.y * kLog2e)")]),
    # The design's knobs turned the other way (each measured; the package
    # keeps the faster): the score product's float4 reads at width 512 too,
    # two stages in the ring, the rows of the resident operand in the fold's
    # order for more or fewer of its rounds (`lane_rows`), and the score
    # product's loop over the column groups unrolled (dK/dV at width 512) or
    # rolled up (dQ).
    "dkv32w_float4": (_DKV, [("  static constexpr int kScoreVec = NGROUP == 4 ? 2 : 4;",
                              "  static constexpr int kScoreVec = 4;")]),
    "dkv32w_two_stages": (_DKV, [("  static constexpr int kStages = 3;",
                                  "  static constexpr int kStages = 2;")]),
    "dkv32w_xor1": (_DKV, [("  static constexpr int kXorBits = 0;",
                            "  static constexpr int kXorBits = 1;")]),
    "dkv32w_unrolled": (_DKV, [(
        "  static constexpr int kScoreUnroll = NGROUP == 4 ? 1 : NGROUP;",
        "  static constexpr int kScoreUnroll = NGROUP;")]),
    # The streamed tensors' addresses held in registers across the loop.
    "dkv32w_pointers_in_registers": (_DKV, [
        ("""  __shared__ const float* streamed[4];   // Q, dO, lse, di
  if (threadIdx.x == 0) {
    streamed[0] = q + b * sq.b + h * sq.h;
    streamed[1] = d_o + b * sdo.b + h * sdo.h;
    streamed[2] = lse + (long long)bh * n;
    streamed[3] = di + (long long)bh * n;
  }
  __syncthreads();""", """  const float* streamed[4] = {q + b * sq.b + h * sq.h, d_o + b * sdo.b + h * sdo.h,
                              lse + (long long)bh * n, di + (long long)bh * n};"""),
        ("        const float* src = streamed[2 + threadIdx.x / kQueries];",
         "        const float* src = threadIdx.x < kQueries ? streamed[2] : streamed[3];")]),
    "dq32w_old": (_DQ, _DQ_WIDE_OLD),
    "dq32w_two_stages": (_DQ, [("  static constexpr int kStages = 3;",
                                "  static constexpr int kStages = 2;")]),
    "dq32w_xor0": (_DQ, [("  static constexpr int kXorBits = 3;",
                          "  static constexpr int kXorBits = 0;")]),
    "dq32w_rolled": (_DQ, [("  static constexpr int kScoreUnroll = NGROUP;",
                            "  static constexpr int kScoreUnroll = 1;")]),
    "dq32w_copies_only": (_DQ, [
        ("""    lane_scores<NGROUP, kRow, kRow, G::kScoreVec, G::kScoreUnroll>(sc, rows, p_warp ? Ks : Vs,
                                                                   lane);
""", _NO_LANE_SCORES),
        ("    product_nn<8, 2 * NGROUP, kKeys, kKeys, kRow, 32, 1>(acc, S, Ks + col0, lane);\n", "")]),
    "dq32w_products_only": (_DQ, [(
        "    if (kt < n_tiles) {\n      const int k0 = kt * kKeys;",
        "    if (kt < 0) {\n      const int k0 = kt * kKeys;")]),
    "dq32w_without_exp": (_DQ, [
        ("fast_exp2(fmaf(sc[0], scale2, row_value))", "fmaf(sc[0], scale2, row_value)"),
        ("fast_exp2(fmaf(sc[1], scale2, row_value))", "fmaf(sc[1], scale2, row_value)")]),
    "k1_cooperative": (_K1, _K1_COOPERATIVE),
    # The prefix's arithmetic left out (each pass only reads and writes).
    "k1_copies_only": (_K1, [
        ("        prefix(px[3 * i], px[3 * i + 1], px[3 * i + 2], p);\n        gray +=",
         "        gray +="),
        ("      prefix(px[3 * i], px[3 * i + 1], px[3 * i + 2], p);\n#pragma unroll\n",
         "#pragma unroll\n")]),
    # Four groups of 4 pixels a thread in blocks of 4096 pixels, all read
    # before the arithmetic, at the registers that takes (3 blocks a
    # multiprocessor). Compared: equal to the package's result.
    "k1_four_groups": (_K1, [
        ("constexpr int kGroups = 2;", "constexpr int kGroups = 4;"),
        ("constexpr int kBlocksPerSM = 4;", "constexpr int kBlocksPerSM = 1;")]),
    # The sector's colours by a switch (a branch a sector) instead of
    # selects. Compared: equal to the package's result.
    "k1_switch": (_K1, [(_K1_BRANCH_FREE, _K1_BRANCHES)]),
    "wide_copies_only": (_FWD, [(
        """  float s[kWideKeys / 2];
  uint32_t pa[kWideKeys / 16][4];
""",
        """  float s[kWideKeys / 2];
  uint32_t pa[kWideKeys / 16][4];
  if (n > 0) {
    for (int item = 0; item < 2 * n_tiles; ++item) __syncthreads();
    return;
  }
""")]),
}


def build_variants(names):
    """Compile each variant of ``names`` from its own copy of the sources (all
    ``nvcc`` processes started together) and return their C entry points by
    name; prints the compiler's resource lines for the kernels they change."""
    jobs = {}
    for name in names:
        source, edits = VARIANTS[name]
        where = VARIANT_DIR / name
        where.mkdir(parents=True, exist_ok=True)
        for path in build.CSRC_DIR.iterdir():
            shutil.copy(path, where)
        for number, edit in enumerate(edits):
            # (old, new) edits the variant's source; (file, old, new) another file of csrc/.
            target, old, new = edit if len(edit) == 3 else (f"{source}.cu", *edit)
            text = (where / target).read_text()
            if text.count(old) != 1:
                raise RuntimeError(f"variant {name}: edit {number} no longer applies to {target}")
            (where / target).write_text(text.replace(old, new))
        lib = where / f"lib{name}.so"
        jobs[name] = (lib, subprocess.Popen(
            [build.find_nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o", str(lib),
             str(where / f"{source}.cu")], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True))
    fns, outputs = {}, {name: proc.communicate()[0] for name, (_, proc) in jobs.items()}
    failed = [name for name, (_, proc) in jobs.items() if proc.returncode != 0]
    if failed:
        raise RuntimeError("nvcc failed for variants " + ", ".join(failed) + ":\n"
                           + "\n".join(outputs[name] for name in failed))
    for name, (lib, _) in jobs.items():
        lines = outputs[name].splitlines()
        for i, line in enumerate(lines):
            if "Function properties" in line and any(key in line for key in (
                    "_tc_kernel", "_wide_kernel", "IfLi", "float32_kernel", "k1_")):
                print(f"  {name}: {line.split('for ')[-1][:60]}: {lines[i + 1].strip()}; "
                      f"{lines[i + 2].strip() if i + 2 < len(lines) else ''}")
            if "serializ" in line:
                print(f"  {name}: {line}")
        symbol = "rgie_" + VARIANTS[name][0]
        fn = getattr(ctypes.CDLL(str(lib)), symbol)
        fn.argtypes = PC._ARGTYPES if symbol == "rgie_" + _K1 else FA._ARGTYPES[symbol]
        fn.restype = ctypes.c_int
        fns[name] = fn
    return fns


def launch_dq(fn, q, k, v, do, lse, di, scale):
    b, h, n, d = q.shape
    dq = FA._empty_like_heads_last(q)
    strides = FA._stride_array(q, k, v, do, dq)
    FA._check_status(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                        di.data_ptr(), dq.data_ptr(), b, h, n, d, ctypes.addressof(strides), scale,
                        int(q.dtype == torch.bfloat16), FA._stream(q)), "variant of backward dQ")
    return dq


def launch_fwd(fn, q, k, v, scale):
    b, h, n, d = q.shape
    o = FA._empty_like_heads_last(q)
    lse = torch.empty((b, h, n), dtype=torch.float32, device=q.device)
    strides = FA._stride_array(q, k, v, o)
    FA._check_status(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(), b,
                        h, n, d, ctypes.addressof(strides), scale, int(q.dtype == torch.bfloat16),
                        FA._stream(q)), "variant of forward")
    return o


def launch_dkv(fn, q, k, v, do, lse, di, scale):
    b, h, n, d = q.shape
    dk, dv = FA._empty_like_heads_last(k), FA._empty_like_heads_last(v)
    strides = FA._stride_array(q, k, v, do, dk, dv)
    FA._check_status(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
                        di.data_ptr(), dk.data_ptr(), dv.data_ptr(), b, h, n, d,
                        ctypes.addressof(strides), scale, int(q.dtype == torch.bfloat16),
                        FA._stream(q)), "variant of backward dK/dV")
    return dk, dv


def time_group(fns, reps=7):
    """Median milliseconds of each ``fn()``, timed with CUDA events in
    alternation after one warm-up round."""
    for fn in fns:
        fn()
    times = [[] for _ in fns]
    for _ in range(reps):
        for fn, ts in zip(fns, times):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            ts.append(start.elapsed_time(end))
    return [float(np.median(ts)) for ts in times]


def make(shape, seed, device, dtype=torch.bfloat16):
    b, h, n, d = shape
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.standard_normal((b, n, h, d)).astype(np.float32))
            .to(device).to(dtype).transpose(1, 2) for _ in range(4)]


def float32_section(fns, device):
    """The float32 forward at the UNet's and the VAE's shapes, dK/dV at the
    UNet's and dQ at the UNet's at batch 2 and 1 (the null-text step's), the
    wide dK/dV and dQ at the VAE's: the package's kernel, the one it
    replaced (``*_old``) and each one's variants. The package's result is
    compared with the old kernel's."""
    for kernel, shape in [("fwd32", (2, 5, 16384, 64)), ("fwd32", (1, 1, 16384, 512)),
                          ("dkv32", (2, 5, 16384, 64)), ("dq32", (2, 5, 16384, 64)),
                          ("dq32", (1, 5, 16384, 64)), ("dkv32w", (1, 1, 16384, 512)),
                          ("dq32w", (1, 1, 16384, 512)), ("dkv32w", (1, 2, 16384, 256)),
                          ("dq32w", (1, 2, 16384, 256))]:
        names = [name for name in fns if name.startswith(kernel + "_")]
        if not names:
            continue
        q, k, v, do = make(shape, 5, device, torch.float32)
        scale = shape[3] ** -0.5
        if kernel == "fwd32":
            package = lambda: FA._launch_fwd(q, k, v, scale)[0]
            variant = lambda name: launch_fwd(fns[name], q, k, v, scale)
        elif kernel.startswith("dq32"):
            o, lse = FA.flash_attention_with_lse(q, k, v, scale)
            di = FA._row_delta(o, do)
            package = lambda: FA._launch_bwd_dq(q, k, v, do, lse, di, scale)
            variant = lambda name: launch_dq(fns[name], q, k, v, do, lse, di, scale)
        else:
            o, lse = FA.flash_attention_with_lse(q, k, v, scale)
            di = FA._row_delta(o, do)
            package = lambda: torch.cat(FA._launch_bwd_dkv(q, k, v, do, lse, di, scale), -1)
            variant = lambda name: torch.cat(launch_dkv(fns[name], q, k, v, do, lse, di, scale), -1)
        got = package()
        if kernel + "_old" in fns:
            old = variant(kernel + "_old")
            torch.cuda.synchronize()
            err = float((got - old).abs().max() / old.abs().max())
            print(f"{kernel} {shape} float32: package against the old kernel, {err:.3e} of the "
                  f"largest entry")
        same = [name for name in names
                if not name.endswith(("_old", "_copies_only", "_products_only", "_without_exp"))]
        for name in same:   # the same sums in the same order
            if not torch.equal(variant(name), got):
                raise AssertionError(f"variant {name} differs from the kernel at {shape}")
        if same:
            print(f"{kernel} {shape} float32: {', '.join(same)} equal the package's result")
        ms = time_group([package] + [lambda name=name: variant(name) for name in names])
        print(f"{kernel} {shape} float32: package {ms[0]:.3f} ms; "
              + "; ".join(f"{name} {t:.3f}" for name, t in zip(names, ms[1:])))
        del q, k, v, do


def main(argv=None):
    """``argv``: prefixes of the variants to build and time (all when empty),
    e.g. ``fwd32 dkv32`` for the float32 kernels alone."""
    import sys

    prefixes = tuple(sys.argv[1:] if argv is None else argv)
    device = resolve_device("cuda")
    print(subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip())
    FA.build_kernels()
    fns = build_variants([name for name in VARIANTS if not prefixes or name.startswith(prefixes)])

    if any(name.startswith("dq_") for name in fns):
        dq_section(fns, device)
    if "wide_copies_only" in fns:
        wide_section(fns, device)
    float32_section(fns, device)
    if not prefixes or any("k1".startswith(p) or p.startswith("k1") for p in prefixes):
        k1_section(fns, device)


def graph_ms(fn, reps=50):
    """Device milliseconds of one ``fn()``: the call captured once in a CUDA
    graph and replayed ``reps`` times between two CUDA events, so that the
    host's work between launches is not counted."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def k1_section(fns, device):
    """K1 per call (the wrapper between CUDA events) and on the device alone:
    the package's kernel, the cooperative single launch, and the Triton
    design before it, at the re-render's batch and at its one-image call."""
    import os

    os.environ.setdefault("TRITON_CACHE_DIR", str(build.BUILD_DIR.parent / "triton"))
    try:
        from rgie_tpu_torch.ops.kernels import pointwise_chain_triton as T
    except ImportError:
        T = None
        print("k1_triton_old: triton is not installed, not timed")
    from rgie_tpu_torch.ops import chain as CH

    rng = np.random.default_rng(1)
    for shape in [(4, 1024, 1024, 3), (1, 1024, 1024, 3)]:
        image = torch.from_numpy(rng.uniform(0, 1, shape).astype(np.float32)).to(device)
        params = CH.unpack_params(torch.from_numpy(
            np.asarray(CH.pack_params(CH.init_params())) + rng.uniform(-0.2, 0.2, 41)
            .astype(np.float32)).to(device))
        calls = {"package": lambda: PC.pointwise_chain(image, params)}
        for name in ("k1_cooperative", "k1_switch", "k1_four_groups", "k1_copies_only"):
            if name in fns:
                calls[name] = lambda name=name: PC.launch(fns[name], image, params)
        if T is not None:
            calls["k1_triton_old"] = lambda: T.old_pointwise_chain(image, params)
        expect = calls["package"]()
        for name, fn in calls.items():
            got = fn()
            torch.cuda.synchronize()
            err = float((got - expect).abs().max())
            limit = {"k1_cooperative": 0.0, "k1_switch": 0.0, "k1_four_groups": 2e-6}
            if err > limit.get(name, float("inf")):
                raise AssertionError(f"{name} differs from the package's K1 at {shape}")
            print(f"K1 {shape}: {name} against the package's result, max abs {err:.3e}")
        ms = time_group(list(calls.values()), reps=21)
        device_ms = {name: graph_ms(fn) for name, fn in calls.items() if name != "k1_cooperative"}
        print(f"K1 {shape} per call (CUDA events around the wrapper, median of 21): "
              + "; ".join(f"{name} {t:.4f} ms" for name, t in zip(calls, ms))
              + "; device alone (CUDA graph replay): "
              + "; ".join(f"{name} {t:.4f} ms" for name, t in device_ms.items()))
        # chip_smoke.py times each call right after the plain version (many
        # small ops); the host's share of a call is then larger.
        plain = lambda: PC.reference_pointwise_chain(image, params)
        after = {name: time_group([calls[name], plain], reps=21)[0]
                 for name in ("package", "k1_triton_old") if name in calls}
        host = {}
        for label, before in (("warm", calls["package"]), ("after the plain version", plain)):
            seconds = []
            for _ in range(21):
                before()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                calls["package"]()
                seconds.append(time.perf_counter() - t0)
            host[label] = 1e3 * float(np.median(seconds))
        print(f"K1 {shape} per call right after the plain version: "
              + "; ".join(f"{name} {t:.4f} ms" for name, t in after.items())
              + "; the package's host time a call (median of 21): "
              + "; ".join(f"{label} {t:.4f} ms" for label, t in host.items()))


def dq_section(fns, device):
    # The variants that keep the arithmetic give the package's result.
    for shape in [(1, 2, 100, 64), (1, 2, 300, 64), (1, 2, 520, 72), (1, 2, 2100, 128),
                  (1, 5, 9000, 64)]:
        q, k, v, do = make(shape, 3, device)
        scale = shape[3] ** -0.5
        o, lse = FA.flash_attention_with_lse(q, k, v, scale)
        di = FA._row_delta(o, do)
        expect = FA._launch_bwd_dq(q, k, v, do, lse, di, scale)
        for name in ("dq_64_key_tiles", "dq_free_warpgroups"):
            got = launch_dq(fns[name], q, k, v, do, lse, di, scale)
            torch.cuda.synchronize()
            if not torch.equal(got, expect):
                raise AssertionError(f"variant {name} differs from the kernel at {shape}")
    print("dq_64_key_tiles and dq_free_warpgroups equal the package's dQ at 5 shapes")

    for shape in [(2, 5, 16384, 64), (1, 5, 16384, 64), (1, 2, 16384, 128)]:
        q, k, v, do = make(shape, 3, device)
        scale = shape[3] ** -0.5
        o, lse = FA.flash_attention_with_lse(q, k, v, scale)
        di = FA._row_delta(o, do)
        names = [name for name in VARIANTS if name.startswith("dq_")]
        ms = time_group([lambda: FA._launch_bwd_dq(q, k, v, do, lse, di, scale)]
                        + [lambda name=name: launch_dq(fns[name], q, k, v, do, lse, di, scale)
                           for name in names])
        b, h, n, d = shape
        keys = 128 if d <= 64 else 64
        atoms = 1 if d <= 64 else 2
        # Every block of 128 query rows brings every K and V tile from L2.
        gb = b * h * -(-n // 128) * -(-n // keys) * 2 * atoms * keys * 128 / 1e9
        print(f"dQ {shape} bfloat16: package {ms[0]:.3f} ms; "
              + "; ".join(f"{name} {t:.3f}" for name, t in zip(names, ms[1:]))
              + f" (the ring brings {gb:.2f} GB from L2: "
              f"{gb / ms[1 + names.index('dq_copies_only')]:.2f} TB/s alone)")


def wide_section(fns, device):
    for shape in [(1, 1, 16384, 512), (1, 2, 16384, 256)]:
        q, k, v, _ = make(shape, 4, device)
        scale = shape[3] ** -0.5
        ms = time_group([lambda: FA._launch_fwd(q, k, v, scale),
                         lambda: launch_fwd(fns["wide_copies_only"], q, k, v, scale)])
        b, h, n, d = shape
        atoms = 4 if d <= 256 else 8
        # Every block of 64 query rows brings every K and V tile from L2.
        gb = b * h * -(-n // 64) * -(-n // 32) * 2 * atoms * 32 * 128 / 1e9
        print(f"wide forward {shape} bfloat16: package {ms[0]:.3f} ms; wide_copies_only "
              f"{ms[1]:.3f} (the ring brings {gb:.2f} GB from L2: {gb / ms[1]:.2f} TB/s alone)")


if __name__ == "__main__":
    main()
